"""The PyTorch/CUDA port's transformer train step against the JAX package.

``make_transformer_train_step`` of ``mxnet_tpu_torch.parallel`` is held
against the JAX package's ``make_transformer_train_step`` on a
(1, 1, 1, 1, 1) CPU mesh, at the tiny config of
tests/test_torch_transformer.py, for {learned, rope} positions x {MHA,
GQA with 2 kv heads}: the same seeded weights and numpy-seeded batches
go through both, and the loss of each of 3 steps and every weight after
them must agree within 1e-4 (float32; the JAX step's attention is its
flash custom_vjp, whose forward runs the XLA twin of the Pallas kernel
under shard_map on the CPU and whose backward is the ring body's
recompute; the port's is the flash kernel's plain versions). Also: the
``device_loop`` form against the JAX loop, the ring body's einsum and
flash routes against each other and against the JAX ring attention,
the round trip of trained weights through the JAX layout, and the
settings that are not ported (sharded mesh axes, remat, MoE, serving
weights) raising.
"""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from mxnet_tpu.parallel import transformer as J  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.convert import (params_from_jax,  # noqa: E402
                                     params_to_numpy)
from mxnet_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402
from mxnet_tpu_torch.parallel import ring_attention as TR  # noqa: E402
from mxnet_tpu_torch.parallel import transformer as T  # noqa: E402

# the JAX package exports a function of the module's name
JR = importlib.import_module("mxnet_tpu.parallel.ring_attention")
TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=64)
B, S, LR = 2, 16, 0.1


def _mesh():
    dev = np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1)
    return Mesh(dev, ("dp", "sp", "tp", "pp", "ep"))


def _configs(**kw):
    cfg = dict(SMALL, **kw)
    return J.TransformerConfig(**cfg), T.TransformerConfig(**cfg)


def _batches(seed, shape):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, SMALL["vocab_size"], shape).astype(np.int32),
            rng.randint(0, SMALL["vocab_size"], shape).astype(np.int32))


def _assert_params_close(pt, pj):
    got = params_to_numpy(pt)
    want = jax.tree_util.tree_map(np.asarray, pj)
    assert set(got) == set(want)
    for k in want:
        if k == "layers":
            for lk in want[k]:
                np.testing.assert_allclose(got[k][lk], want[k][lk],
                                           err_msg=lk, **TOL)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


CASES = [("learned", None), ("learned", 2), ("rope", None), ("rope", 2)]


@pytest.mark.parametrize("pos_type,n_kv_heads", CASES)
def test_train_step_matches_jax(pos_type, n_kv_heads):
    cj, ct = _configs(pos_type=pos_type, n_kv_heads=n_kv_heads)
    pj, _ = J.init_transformer_params(cj, _mesh(), seed=7)
    pt = T.init_transformer_params_np(ct, seed=7, device="cpu",
                                      trainable=True)
    step_j = J.make_transformer_train_step(cj, _mesh(), lr=LR)
    step_t = T.make_transformer_train_step(ct, None, lr=LR)
    tfa.reset_launches()
    for i in range(3):
        tok, tgt = _batches(100 + i, (B, S))
        pj, lj = step_j(pj, jnp.asarray(tok), jnp.asarray(tgt))
        pt, lt = step_t(pt, torch.from_numpy(tok), torch.from_numpy(tgt))
        assert lt.dtype == torch.float32 and lt.dim() == 0
        np.testing.assert_allclose(float(lt), float(lj), **TOL)
    _assert_params_close(pt, pj)
    # CPU tensors take the plain versions: no kernel launched
    assert all(n == 0 for n in tfa.LAUNCHES.values())


def test_device_loop_matches_jax_loop():
    cj, ct = _configs(pos_type="rope", n_kv_heads=2)
    pj, _ = J.init_transformer_params(cj, _mesh(), seed=8)
    pt = T.init_transformer_params_np(ct, seed=8, device="cpu",
                                      trainable=True)
    tok, tgt = _batches(5, (3, B, S))
    loop_j = J.make_transformer_train_step(cj, _mesh(), lr=LR,
                                           device_loop=True)
    loop_t = T.make_transformer_train_step(ct, None, lr=LR,
                                           device_loop=True)
    pj, lj = loop_j(pj, jnp.asarray(tok), jnp.asarray(tgt))
    pt2, lt = loop_t(pt, torch.from_numpy(tok), torch.from_numpy(tgt))
    assert pt2 is pt                      # updated in place
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
    _assert_params_close(pt, pj)


def test_ulysses_at_sp1_equals_ring():
    _, ring = _configs(pos_type="rope")
    _, uly = _configs(pos_type="rope", sp_attn="ulysses")
    tok, tgt = (torch.from_numpy(a) for a in _batches(9, (B, S)))
    losses = []
    for cfg in (ring, uly):
        p = T.init_transformer_params_np(cfg, seed=2, device="cpu",
                                         trainable=True)
        step = T.make_transformer_train_step(cfg, lr=LR)
        losses.append([float(step(p, tok, tgt)[1]) for _ in range(2)])
    assert losses[0] == losses[1]


@pytest.mark.parametrize("pos_type,n_kv_heads", CASES)
def test_lm_loss_plain_attention_route_matches_kernel_route(pos_type,
                                                            n_kv_heads):
    # the route chip_smoke.py holds the bf16 kernels against on the card
    _, ct = _configs(pos_type=pos_type, n_kv_heads=n_kv_heads)
    p = T.init_transformer_params_np(ct, seed=11, device="cpu",
                                     trainable=True)
    tok, tgt = (torch.from_numpy(a) for a in _batches(12, (B, S)))
    out = []
    for impl in ("auto", "einsum"):
        loss = T._lm_local_loss(p, tok, tgt, ct, attn_impl=impl)
        out.append((loss.detach(),
                    torch.autograd.grad(loss, list(p.parameters()))))
    np.testing.assert_allclose(float(out[0][0]), float(out[1][0]), **TOL)
    for (name, _), a, b in zip(p.named_parameters(), out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("impl", ["flash", "einsum"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_local_matches_jax_ring_attention(impl, causal):
    rng = np.random.RandomState(4)
    q, k, v, g = (rng.randn(2, 3, 12, 8).astype(np.float32)
                  for _ in range(4))
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))

    def jloss(q, k, v):
        o = JR.ring_attention(q, k, v, mesh=mesh, causal=causal,
                              impl=impl)
        return jnp.sum(o * g), o

    (_, oj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ot = TR.ring_attention_local(qt, kt, vt, causal, 1 / np.sqrt(8),
                                 impl=impl)
    gt = torch.autograd.grad(ot, (qt, kt, vt), torch.from_numpy(g))
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj), **TOL)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_ring_local_rejects_rings_and_impls():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(NotImplementedError, match="A13"):
        TR.ring_attention_local(q, q, q, True, 1.0, ring_size=2)
    with pytest.raises(ValueError):
        TR.ring_attention_local(q, q, q, True, 1.0, impl="pallas")


def test_trained_params_round_trip_jax_layout():
    _, ct = _configs(pos_type="learned", n_kv_heads=2)
    pt = T.init_transformer_params_np(ct, seed=3, device="cpu",
                                      trainable=True)
    step = T.make_transformer_train_step(ct, lr=LR)
    tok, tgt = (torch.from_numpy(a) for a in _batches(1, (B, S)))
    step(pt, tok, tgt)
    tree = params_to_numpy(pt)
    back = params_from_jax(tree, ct, device="cpu", trainable=True)
    assert all(p.requires_grad for p in back.parameters())
    for (name, a), (_, b) in zip(pt.named_parameters(),
                                 back.named_parameters()):
        assert torch.equal(a.detach(), b.detach()), name
    # and the JAX package takes the tree back
    cj, _ = _configs(pos_type="learned", n_kv_heads=2)
    lj = J.make_transformer_train_step(cj, _mesh(), lr=LR)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tok.numpy()),
        jnp.asarray(tgt.numpy()))[1]
    np.testing.assert_allclose(float(step(back, tok, tgt)[1]), float(lj),
                               **TOL)


@pytest.mark.parametrize("axis", ["dp", "sp", "tp", "pp", "ep"])
def test_sharded_mesh_axes_raise(axis):
    _, ct = _configs()
    mesh = {a: 1 for a in T.AXES}
    mesh[axis] = 2
    with pytest.raises(NotImplementedError, match="ROADMAP A1[35]"):
        T.make_transformer_train_step(ct, mesh)


def test_unsupported_settings_raise():
    _, ct = _configs()
    with pytest.raises(ValueError, match="missing axis"):
        T.make_transformer_train_step(ct, {"dp": 1})
    _, remat = _configs(remat=True)
    with pytest.raises(NotImplementedError, match="remat"):
        T.make_transformer_train_step(remat)
    _, moe = _configs(num_experts=4)
    with pytest.raises(NotImplementedError, match="MoE"):
        T.make_transformer_train_step(moe)
    _, bad = _configs(sp_attn="allgather")
    with pytest.raises(ValueError, match="sp_attn"):
        T.make_transformer_train_step(bad)
    serving = T.init_transformer_params_np(ct, seed=0, device="cpu")
    assert not any(p.requires_grad for p in serving.parameters())
    tok, tgt = (torch.from_numpy(a) for a in _batches(1, (B, S)))
    with pytest.raises(MXNetError, match="trainable=True"):
        T.make_transformer_train_step(ct)(serving, tok, tgt)
    loop = T.make_transformer_train_step(ct, device_loop=True)
    with pytest.raises(ValueError, match="stacked"):
        loop(T.init_transformer_params_np(ct, seed=0, device="cpu",
                                          trainable=True), tok, tgt)
