"""The port's inference BatchNorm against the JAX package's.

``batch_norm_inference`` (the CUDA kernel of BatchNorm with the moving
statistics) takes its plain version, ``_batch_norm_inference_plain``,
for CPU tensors, counts no launch there, and refuses what the kernel
does not take. The BatchNorm op with the moving statistics is the plain
version's ``x * a + b`` bitwise, in float32 and float64; the plain
version rounds each of its float32 operations correctly; and the JAX
op's ``(x - mean) * rsqrt(var + eps) * gamma + beta`` within 2e-6
relative to the output's scale (another order of float32 operations,
and XLA's ``rsqrt`` is not correctly rounded). Gradients through the op
with ``use_global_stats`` match the JAX op's within the same limit.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import registry as jreg  # noqa: E402

import mxnet_tpu_torch  # noqa: E402,F401
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402
from mxnet_tpu_torch.ops.cuda import batch_norm as bn  # noqa: E402

TOL = 2e-6

SHAPES = [((4, 3, 5, 7), False), ((2, 16, 8, 8), True), ((5, 6), False),
          ((2, 8, 3, 4, 5), False)]


def _inputs(rng, shape):
    c = shape[1]
    return (rng.randn(*shape).astype(np.float32) * 3 + 1,
            rng.rand(c).astype(np.float32) + 0.5,
            rng.randn(c).astype(np.float32),
            rng.randn(c).astype(np.float32),
            rng.rand(c).astype(np.float32) * 2 + 0.1)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1.0)
    return np.abs(got - want).max() <= TOL * scale


@pytest.mark.parametrize("shape,fix_gamma", SHAPES)
def test_plain_version_and_op_against_the_jax_op(shape, fix_gamma):
    rng = np.random.RandomState(len(shape) * 10 + shape[1])
    arrays = _inputs(rng, shape)
    ts = [torch.from_numpy(a) for a in arrays]
    bn.reset_launches()
    got = bn.batch_norm_inference(*ts, 1e-3, fix_gamma)
    assert bn.LAUNCHES == {"batch_norm_inference": 0}
    plain = bn._batch_norm_inference_plain(*ts, 1e-3, fix_gamma)
    assert torch.equal(got, plain)
    attrs = {"fix_gamma": fix_gamma, "use_global_stats": True, "eps": 1e-3}
    op = treg.get_op("BatchNorm").fn(*ts, **attrs)
    assert torch.equal(op, plain)
    want = jreg.get_op("BatchNorm").fn(*[jnp.asarray(a) for a in arrays],
                                       **attrs)
    assert _close(got.numpy(), want)
    # the op without use_global_stats and train_mode is inference too
    assert torch.equal(treg.get_op("BatchNorm").fn(
        *ts, fix_gamma=fix_gamma, eps=1e-3), plain)


def test_plain_version_is_correctly_rounded():
    """Every step as numpy's float32 arithmetic, which rounds each
    correctly (as the kernel does): 2048 channels whose variances span
    twelve decades, where PyTorch's float32 sqrt on the CPU is an ulp off
    in some."""
    rng = np.random.RandomState(6)
    c = 2048
    x, g, b, m, _ = _inputs(rng, (2, c, 3, 3))
    v = (rng.rand(c) * 10.0 ** rng.uniform(-6, 6, c)).astype(np.float32)
    eps = np.float32(2e-5)
    a = g / np.sqrt(v + eps)
    want = x * a.reshape(1, c, 1, 1) + (b - m * a).reshape(1, c, 1, 1)
    got = bn._batch_norm_inference_plain(
        *map(torch.from_numpy, (x, g, b, m, v)), 2e-5)
    assert _same(got.numpy(), want)


def _same(got, want):
    return got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_op_axis_and_float64():
    rng = np.random.RandomState(3)
    x, g, b, m, v = _inputs(rng, (2, 4, 3, 5))
    xl = np.ascontiguousarray(np.moveaxis(x, 1, -1))     # channels last
    got = treg.get_op("BatchNorm").fn(
        *map(torch.from_numpy, (xl, g, b, m, v)), axis=-1, fix_gamma=False,
        use_global_stats=True)
    want = bn._batch_norm_inference_plain(
        *map(torch.from_numpy, (x, g, b, m, v)), 1e-3)
    assert torch.equal(got, want.movedim(1, -1))
    x64 = [torch.from_numpy(a.astype(np.float64)) for a in (x, g, b, m, v)]
    got64 = treg.get_op("BatchNorm").fn(*x64, fix_gamma=False,
                                        use_global_stats=True)
    assert got64.dtype == torch.float64
    assert torch.equal(got64, bn._batch_norm_inference_plain(*x64, 1e-3))


def test_gradients_with_global_stats_against_the_jax_op():
    rng = np.random.RandomState(4)
    arrays = _inputs(rng, (3, 5, 4, 4))
    dy = rng.randn(3, 5, 4, 4).astype(np.float32)
    attrs = {"fix_gamma": False, "use_global_stats": True, "eps": 1e-3,
             "train_mode": True}
    ts = [torch.from_numpy(a).requires_grad_(i < 3)
          for i, a in enumerate(arrays)]
    out = treg.get_op("BatchNorm").fn(*ts, **attrs)
    got = torch.autograd.grad(out, ts[:3], torch.from_numpy(dy))

    def f(x, g, b):
        return jreg.get_op("BatchNorm").fn(x, g, b, *map(jnp.asarray,
                                                         arrays[3:]),
                                           **attrs)
    _, vjp = jax.vjp(f, *map(jnp.asarray, arrays[:3]))
    for a, w in zip(got, vjp(jnp.asarray(dy))):
        assert _close(a.numpy(), w)


@pytest.mark.parametrize("case", ["float64", "channels", "noncontig",
                                  "rank1", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    rng = np.random.RandomState(5)
    x, g, b, m, v = map(torch.from_numpy, _inputs(rng, (2, 4, 3, 3)))
    if case == "float64":
        x = x.double()
    elif case == "channels":
        g = g[:3].contiguous()
    elif case == "noncontig":
        x = x.transpose(2, 3)
    elif case == "rank1":
        x = x.reshape(-1)
    else:
        g = g.to("meta")
    with pytest.raises(MXNetError):
        bn.batch_norm_inference(x, g, b, m, v, 1e-3)
