"""The port's int8 kernels' plain versions and quantization ops against
the JAX package's.

``_int8_matmul_plain`` and ``_int8_conv_plain`` (the plain versions of
the ``int8_matmul`` / ``int8_conv_im2col`` CUDA kernels) must equal,
bitwise, the JAX package's lax twins (``_int8_matmul_xla``,
``_int8_conv_xla``) and its Pallas kernels run by the interpreter: int32
sums of int8 products are exact, and the float32 epilogue is one
multiply of the same operands. The wrappers take the plain versions for
CPU tensors only, count no launch, and refuse what the kernels do not
take. Every quantization op of the registry is held against its JAX
twin on the same numpy inputs: the per-channel serving pair as every JAX
graph runs it (jitted: the division by the static ``act_scale`` folded
into a multiply by its float32 reciprocal), bitwise without a bias and,
with one, within the rounding XLA's fused multiply-add saves; the triple
ops, called eagerly, bitwise on their integer outputs and ranges.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import importlib  # noqa: E402

from mxnet_tpu.ops import registry as jreg  # noqa: E402

import mxnet_tpu_torch  # noqa: E402,F401
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402
from mxnet_tpu_torch.ops.cuda import int8_matmul as tk  # noqa: E402

# the module (the package attribute of the same name is its function)
jk = importlib.import_module("mxnet_tpu.ops.pallas.int8_matmul")


def _i8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _scales(rng, n):
    return (rng.rand(n).astype(np.float32) * 0.1 + 1e-3)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return got.dtype == want.dtype and got.shape == want.shape \
        and got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# the plain versions against the lax twins and the Pallas interpreter
# ---------------------------------------------------------------------------

MATMUL_SHAPES = [(1, 8, 4), (5, 37, 11), (16, 256, 64), (33, 147, 130)]


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_int8_matmul_plain_equals_xla_twin_and_pallas_bitwise(m, k, n):
    rng = np.random.RandomState(m * 7 + k)
    x, w, s = _i8(rng, m, k), _i8(rng, n, k), _scales(rng, n)
    got = tk._int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(s))
    twin = jk._int8_matmul_xla(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(s))
    pallas = jk.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                            interpret=True)
    assert _same(got, twin)
    assert _same(got, pallas)


# (b, cin, h, w, cout, groups, kh, kw, stride, dilate, pad)
CONV_SHAPES = [
    (2, 3, 17, 19, 8, 1, 7, 7, (2, 2), (1, 1), (3, 3)),   # stem-like, K 147
    (2, 8, 9, 11, 12, 2, 3, 3, (2, 1), (2, 2), (2, 1)),   # groups, dilate
    (1, 16, 6, 6, 24, 1, 1, 1, (2, 2), (1, 1), (0, 0)),   # 1x1 stride 2
    (2, 4, 5, 7, 8, 4, 3, 3, (1, 1), (1, 1), (1, 1)),     # depthwise
]


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "x".join(
    str(v) for v in s[:8]))
def test_int8_conv_plain_equals_xla_twin_and_pallas_bitwise(shape):
    b, c, h, w, co, g, kh, kw, st, dl, pd = shape
    rng = np.random.RandomState(b * 31 + c)
    q, wq, s = _i8(rng, b, c, h, w), _i8(rng, co, c // g, kh, kw), \
        _scales(rng, co)
    got = tk._int8_conv_plain(torch.from_numpy(q), torch.from_numpy(wq),
                              torch.from_numpy(s), st, dl, pd, g)
    twin = jk._int8_conv_xla(jnp.asarray(q), jnp.asarray(wq), jnp.asarray(s),
                             st, dl, pd, g)
    pallas = jk.int8_conv_im2col(jnp.asarray(q), jnp.asarray(wq),
                                 jnp.asarray(s), st, dl, pd, g,
                                 interpret=True)
    assert _same(got, twin)
    assert _same(got, pallas)


def test_zero_scale_channels_give_exact_zeros():
    x = torch.ones((3, 16), dtype=torch.int8)
    w = torch.ones((4, 16), dtype=torch.int8)
    s = torch.tensor([0.0, 1.0, 0.5, 0.0])
    out = tk.int8_matmul(x, w, s)
    assert torch.isfinite(out).all()
    assert (out[:, 0] == 0).all() and (out[:, 1] == 16).all()


# ---------------------------------------------------------------------------
# the wrappers: CPU routing, shapes, refusals
# ---------------------------------------------------------------------------

def test_wrappers_take_plain_versions_on_cpu_and_count_no_launch(
        monkeypatch):
    calls = []
    for name in ("_int8_matmul_plain", "_int8_conv_plain"):
        real = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    tk.reset_launches()
    rng = np.random.RandomState(0)
    out = tk.int8_matmul(torch.from_numpy(_i8(rng, 5, 37)),
                         torch.from_numpy(_i8(rng, 11, 37)),
                         torch.from_numpy(_scales(rng, 11)))
    assert out.shape == (5, 11) and out.dtype == torch.float32
    out = tk.int8_conv_im2col(torch.from_numpy(_i8(rng, 2, 4, 9, 7)),
                              torch.from_numpy(_i8(rng, 6, 2, 3, 3)),
                              torch.from_numpy(_scales(rng, 6)), (2, 1),
                              (1, 2), (1, 1), 2)
    assert out.shape == (2, 6, 5, 5)
    assert calls == ["_int8_matmul_plain", "_int8_conv_plain"]
    assert tk.LAUNCHES == {"int8_matmul": 0, "int8_conv_im2col": 0}


def test_conv_output_shape_on_meta_tensors():
    q = torch.empty((2, 4, 9, 7), dtype=torch.int8, device="meta")
    wq = torch.empty((6, 2, 3, 3), dtype=torch.int8, device="meta")
    s = torch.empty((6,), device="meta")
    out = tk.int8_conv_im2col(q, wq, s, (2, 1), (1, 2), (1, 1), 2)
    assert out.shape == (2, 6, 5, 5) and out.device.type == "meta"


@pytest.mark.parametrize("case", ["dtype", "k", "scale", "layout",
                                  "device", "rank"])
def test_int8_matmul_refuses_what_the_kernel_does_not_take(case):
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((3, 8), dtype=torch.int8)
    s = torch.ones(3)
    if case == "dtype":
        x = x.float()
    elif case == "k":
        w = torch.zeros((3, 9), dtype=torch.int8)
    elif case == "scale":
        s = torch.ones(3, dtype=torch.float64)
    elif case == "layout":
        x = torch.zeros((8, 4), dtype=torch.int8).t()
    elif case == "device":
        s = torch.ones(3, device="meta")
    else:
        x = x[None]
    with pytest.raises(MXNetError):
        tk.int8_matmul(x, w, s)


@pytest.mark.parametrize("case", ["groups", "scale", "stride", "window"])
def test_int8_conv_refuses_what_the_kernel_does_not_take(case):
    q = torch.zeros((1, 4, 5, 5), dtype=torch.int8)
    wq = torch.zeros((6, 2, 3, 3), dtype=torch.int8)
    s = torch.ones(6)
    args = [(1, 1), (1, 1), (0, 0), 2]
    if case == "groups":
        args[3] = 3
    elif case == "scale":
        s = torch.ones(5)
    elif case == "stride":
        args[0] = (0, 1)
    else:
        wq = torch.zeros((6, 2, 7, 7), dtype=torch.int8)
    with pytest.raises(MXNetError):
        tk.int8_conv_im2col(q, wq, s, *args)


# ---------------------------------------------------------------------------
# the quantization ops against their JAX twins
# ---------------------------------------------------------------------------

def _run(name, arrays, attrs):
    """The op of each registry on the same numpy inputs -> (port, jax)
    outputs as tuples of numpy arrays."""
    got = treg.get_op(name).fn(*[torch.from_numpy(a) for a in arrays],
                               **attrs)
    want = jreg.get_op(name).fn(*[jnp.asarray(a) for a in arrays], **attrs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


def _assert_all_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes()


def _jit_op(name, arrays, attrs):
    """The JAX op as every JAX graph runs it: under ``jax.jit``."""
    fn = jreg.get_op(name).fn
    out = jax.jit(lambda *a: fn(*a, **attrs))(*map(jnp.asarray, arrays))
    return np.asarray(out)


def _port_op(name, arrays, attrs):
    return treg.get_op(name).fn(*map(torch.from_numpy, arrays),
                                **attrs).numpy()


def _hold_serving_op(name, arrays, attrs, bias):
    """Without a bias the port's op equals the jitted JAX op bitwise.
    With one it is that output plus the bias, one rounded add, and within
    the rounding of the product of the jitted JAX op, where XLA on the
    CPU fuses the rescale and the bias into one multiply-add."""
    plain = dict(attrs, no_bias=True)
    got0 = _port_op(name, arrays, plain)
    want0 = _jit_op(name, arrays, plain)
    assert got0.dtype == want0.dtype == np.float32
    assert got0.tobytes() == want0.tobytes()
    if bias is None:
        return
    chan = (1, -1) + (1,) * (got0.ndim - 2) if got0.ndim > 2 else (1, -1)
    got = _port_op(name, arrays + [bias], attrs)
    assert got.tobytes() == (got0 + bias.reshape(chan)).tobytes()
    want = _jit_op(name, arrays + [bias], attrs)
    assert (np.abs(got - want)
            <= np.spacing(np.abs(got0)) + np.spacing(np.abs(want))).all()


@pytest.mark.parametrize("act_scale", [1.0, 12.3456789, 127.0 / 3.7e-3])
@pytest.mark.parametrize("bias", [False, True])
def test_quantized_fc_int8_equals_jax_graph(act_scale, bias):
    rng = np.random.RandomState(3)
    data = rng.randn(6, 3, 4, 4).astype(np.float32) * 2
    wq, ws = _i8(rng, 10, 48), _scales(rng, 10)
    _hold_serving_op("_contrib_quantized_fc_int8", [data, wq, ws],
                     {"num_hidden": 10, "no_bias": False,
                      "act_scale": act_scale},
                     rng.randn(10).astype(np.float32) if bias else None)


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("bias", [False, True])
def test_quantized_conv_int8_equals_jax_graph(nd, bias):
    rng = np.random.RandomState(nd)
    space = {1: (13,), 2: (9, 11), 3: (5, 6, 7)}[nd]
    data = rng.randn(2, 4, *space).astype(np.float32)
    kernel = (3,) * nd
    wq, ws = _i8(rng, 6, 2, *kernel), _scales(rng, 6)
    _hold_serving_op("_contrib_quantized_conv_int8", [data, wq, ws],
                     {"kernel": kernel, "stride": (2,) + (1,) * (nd - 1),
                      "dilate": (1,) * (nd - 1) + (2,), "pad": (1,) * nd,
                      "num_filter": 6, "num_group": 2, "no_bias": False,
                      "act_scale": 31.7},
                     rng.randn(6).astype(np.float32) if bias else None)


def test_out_scale_is_the_reciprocal_multiply_of_jax_graphs():
    """``w_scale * f32(1 / act_scale)``, what XLA compiles the JAX op's
    ``w_scale / act_scale`` into; a true division differs in the last bit
    for some values."""
    from mxnet_tpu_torch.ops import quantization_ops as tq
    rng = np.random.RandomState(9)
    s = rng.rand(200000).astype(np.float32)
    act = 127.0 / 3.3
    got = tq._out_scale(torch.from_numpy(s), act).numpy()
    recip = np.float32(1) / np.float32(act)
    assert got.tobytes() == (s * recip).tobytes()
    assert (s / np.float32(act)).tobytes() != got.tobytes()


def test_quantize_act_rounds_half_to_even_and_saturates():
    from mxnet_tpu_torch.ops import quantization_ops as tq
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 200.0, -200.0])
    got = tq._quantize_act(x, 1.0)
    assert got.tolist() == [0, 2, 2, 0, -2, 127, -127]


def _triple_cases(rng):
    data = rng.randn(4, 6).astype(np.float32) * 3
    q8 = _i8(rng, 4, 6)
    f32 = lambda v: np.array(v, np.float32)  # noqa: E731
    acc = rng.randint(-2 ** 30, 2 ** 30, (4, 6)).astype(np.int32)
    img = _i8(rng, 2, 3, 6, 6)
    return [
        ("_contrib_quantize", [data, f32(-2.5), f32(4.0)], {}),
        ("_contrib_quantize", [data, f32(0.0), f32(0.0)], {}),
        ("_contrib_quantize_v2", [data], {}),
        ("_contrib_quantize_v2", [data], {"min_calib_range": -1.0,
                                          "max_calib_range": 2.0}),
        ("_contrib_dequantize", [q8, f32(-3.0), f32(1.5)], {}),
        ("_contrib_requantize", [acc, f32(-7.0), f32(9.0)], {}),
        ("_contrib_requantize", [acc, f32(-7.0), f32(9.0)],
         {"min_calib_range": -2.0, "max_calib_range": 2.0}),
        ("_contrib_quantized_fully_connected",
         [q8, _i8(rng, 5, 6), f32(-1.0), f32(1.0), f32(-0.5), f32(0.5)],
         {"num_hidden": 5, "no_bias": True}),
        ("_contrib_quantized_fully_connected",
         [q8, _i8(rng, 5, 6), _i8(rng, 5), f32(-1.0), f32(1.0), f32(-0.5),
          f32(0.5), f32(-2.0), f32(2.0)], {"num_hidden": 5}),
        ("_contrib_quantized_conv",
         [img, _i8(rng, 4, 3, 3, 3), f32(-1.0), f32(2.0), f32(-0.3),
          f32(0.3)], {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                      "num_filter": 4}),
        ("_contrib_quantized_pooling", [img, f32(-1.0), f32(1.0)],
         {"kernel": (3, 3), "pool_type": "max", "stride": (2, 2)}),
        ("_contrib_quantized_pooling", [img, f32(-1.0), f32(1.0)],
         {"kernel": (2, 2), "pool_type": "avg", "stride": (2, 2)}),
        ("_contrib_quantized_flatten", [img, f32(-1.0), f32(1.0)], {}),
    ]


@pytest.mark.parametrize("idx", range(13))
def test_triple_ops_equal_jax_bitwise(idx):
    name, arrays, attrs = _triple_cases(np.random.RandomState(11))[idx]
    got, want = _run(name, arrays, attrs)
    _assert_all_same(got, want)


def test_every_quantization_op_of_the_jax_registry_is_ported():
    from mxnet_tpu_torch.ops import quantization_ops as tq
    import mxnet_tpu.ops.quantization_ops as jq
    import ast
    import inspect

    def registered(mod):
        tree = ast.parse(inspect.getsource(mod))
        return {d.args[0].value for node in ast.walk(tree)
                if isinstance(node, ast.FunctionDef)
                for d in node.decorator_list
                if isinstance(d, ast.Call) and getattr(d.func, "id", "")
                == "register"}

    names = registered(jq)
    assert len(names) == 10
    assert registered(tq) == names
