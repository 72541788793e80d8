"""The PyTorch/CUDA port's MoE layers against the JAX package.

``parallel/moe.py``: ``top_k_gating`` must route as the JAX package's
does (the dense dispatch / combine tensors equal, the aux loss and the
gate's gradients within 1e-6 in float32) at three shapes, top-1 and
top-2, with a capacity small enough that tokens are dropped, and the
same tokens dropped; ``moe_apply`` (dispatch by index, the experts, the
weighted combine) against the JAX ``moe_apply`` on a one-device ``ep``
mesh within 1e-5, and its top-2 mix against the hand-made one. The
transformer with MoE layers: the init draws (``gate``, ``we1``, ``we2``
in the JAX order), ``params_from_jax``, the reference forward and two
train steps (loss with its ``0.01 * aux`` term, and every weight) within
1e-4 of the JAX step in float32.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from mxnet_tpu.parallel import moe as JM  # noqa: E402
from mxnet_tpu.parallel import transformer as J  # noqa: E402
from mxnet_tpu_torch.convert import (params_from_jax,  # noqa: E402
                                     params_to_numpy)
from mxnet_tpu_torch.parallel import moe as TM  # noqa: E402
from mxnet_tpu_torch.parallel import transformer as T  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ROUTE_TOL = dict(rtol=1e-6, atol=1e-6)
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=64, max_len=64, num_experts=4)

# (tokens, experts, capacity): capacities below tokens * choices /
# experts overflow, so some choices are dropped
GATING = [(16, 4, 3), (40, 8, 6), (64, 4, 20)]


def _mesh5():
    dev = np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1)
    return Mesh(dev, ("dp", "sp", "tp", "pp", "ep"))


def _configs(**kw):
    cfg = dict(SMALL, **kw)
    return J.TransformerConfig(**cfg), T.TransformerConfig(**cfg)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n,E,cap", GATING)
def test_top_k_gating_routes_as_jax(n, E, cap, k):
    logits = np.random.RandomState(n + E).randn(n, E).astype(np.float32)
    dj, cj, aj = JM.top_k_gating(jnp.asarray(logits), E, cap, k=k)
    dt, ct, at = TM.top_k_gating(torch.from_numpy(logits), E, cap, k=k)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **ROUTE_TOL)
    np.testing.assert_allclose(float(at), float(aj), **ROUTE_TOL)
    # the capacity overflows: the same choices dropped in both
    kept = dt.numpy().sum((1, 2))
    assert kept.min() < min(k, 2)
    np.testing.assert_array_equal(kept, np.asarray(dj).sum((1, 2)))
    # the index form names the same (expert, slot) for every kept choice
    experts, slots, _, keep, _ = TM.top_k_route(torch.from_numpy(logits),
                                                E, cap, k=k)
    rows = torch.arange(n)[:, None].expand_as(experts)
    assert torch.equal(dt[rows[keep], experts[keep], slots[keep]],
                       torch.ones(int(keep.sum())))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n,E,cap", GATING)
def test_aux_loss_and_gate_gradients_match_jax(n, E, cap, k):
    rng = np.random.RandomState(3 * n + E)
    logits = rng.randn(n, E).astype(np.float32)
    probe = rng.randn(n, E, cap).astype(np.float32)

    def jloss(x):
        _, comb, aux = JM.top_k_gating(x, E, cap, k=k)
        return jnp.sum(comb * probe) + aux

    gj = jax.grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    _, comb, aux = TM.top_k_gating(x, E, cap, k=k)
    (gt,) = torch.autograd.grad((comb * torch.from_numpy(probe)).sum()
                                + aux, x)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **ROUTE_TOL)


def _experts(rng, E, d, f):
    return [{"w1": rng.randn(d, f).astype(np.float32) * 0.2,
             "w2": rng.randn(f, d).astype(np.float32) * 0.2}
            for _ in range(E)]


@pytest.mark.parametrize("k,cf", [(2, 4.0), (2, 0.5), (1, 1.0)])
def test_moe_apply_matches_jax(k, cf):
    """test_parallel_5d.py:86 on one device: the routed layer, with and
    without dropped tokens."""
    rng = np.random.RandomState(2)
    n, d, E = 64, 16, 8
    x = rng.randn(n, d).astype(np.float32)
    gate_w = (rng.randn(d, E) * 0.5).astype(np.float32)
    experts = _experts(rng, E, d, 32)
    out_j, aux_j = JM.moe_apply(
        jnp.asarray(x), jnp.asarray(gate_w),
        JM.stack_expert_params([jax.tree_util.tree_map(jnp.asarray, e)
                                for e in experts]),
        lambda p, h: jax.nn.relu(h @ p["w1"]) @ p["w2"],
        mesh=Mesh(np.array(jax.devices()[:1]), ("ep",)), k=k,
        capacity_factor=cf)
    out_t, aux_t = TM.moe_apply(
        torch.from_numpy(x), torch.from_numpy(gate_w),
        TM.stack_expert_params([{n_: torch.from_numpy(a)
                                 for n_, a in e.items()} for e in experts]),
        lambda p, h: torch.relu(h @ p["w1"]) @ p["w2"], mesh={"ep": 1},
        k=k, capacity_factor=cf)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    with pytest.raises(NotImplementedError, match="A15"):
        TM.moe_apply(torch.from_numpy(x), torch.from_numpy(gate_w), {},
                     None, mesh={"ep": 2})


def test_moe_top2_weights():
    """test_parallel_5d.py:109: with room for every token, token 0's
    output is the renormalised mix of its two experts."""
    rng = np.random.RandomState(3)
    n, d, E = 32, 8, 4
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    gate_w = torch.from_numpy(rng.randn(d, E).astype(np.float32))
    experts = [{k: torch.from_numpy(a) for k, a in e.items()}
               for e in _experts(rng, E, d, 16)]

    def fn(p, h):
        return torch.relu(h @ p["w1"]) @ p["w2"]

    out, _ = TM.moe_apply(x, gate_w, TM.stack_expert_params(experts), fn,
                          k=2, capacity_factor=8.0)
    g = torch.softmax(x[0] @ gate_w, -1)
    i1 = int(g.argmax())
    i2 = int(torch.where(torch.arange(E) == i1, 0.0, g).argmax())
    w1, w2 = g[i1] / (g[i1] + g[i2]), g[i2] / (g[i1] + g[i2])
    manual = w1 * fn(experts[i1], x[:1]) + w2 * fn(experts[i2], x[:1])
    np.testing.assert_allclose(out[0].numpy(), manual[0].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_moe_init_draws_and_params_from_jax():
    cj, ct = _configs(pos_type="learned")
    pj = jax.tree_util.tree_map(
        np.asarray, J.init_transformer_params(cj, _mesh5(), seed=4)[0])
    pt = params_to_numpy(T.init_transformer_params_np(ct, seed=4,
                                                      device="cpu"))
    assert set(pt["layers"]) == set(pj["layers"]) == set(T.MOE_LAYER_KEYS)
    for k in pj["layers"]:
        np.testing.assert_array_equal(pt["layers"][k], pj["layers"][k])
    for k in ("embed", "pos"):
        np.testing.assert_array_equal(pt[k], pj[k])
    back = params_to_numpy(params_from_jax(pj, ct, device="cpu"))
    assert back["layers"]["we1"].shape == (1, 2, 4, 32, 64)
    for k in pj["layers"]:
        np.testing.assert_array_equal(back["layers"][k], pj["layers"][k])
    # a dense tree does not load into an MoE config
    _, dense = _configs(num_experts=0)
    with pytest.raises(T.MXNetError, match="missing"):
        params_from_jax(pj, dense, device="cpu")


@pytest.mark.parametrize("pos_type,cf", [("learned", 2.0), ("rope", 1.0)])
def test_moe_forward_and_train_steps_match_jax(pos_type, cf):
    """test_parallel_5d.py's MoE train step on one device: the forward,
    and two steps (cf 1.0 drops tokens) within 1e-4."""
    cj, ct = _configs(pos_type=pos_type, capacity_factor=cf)
    pj, _ = J.init_transformer_params(cj, _mesh5(), seed=6)
    pt = T.init_transformer_params_np(ct, seed=6, device="cpu",
                                      trainable=True)
    rng = np.random.RandomState(7)
    toks = rng.randint(0, 64, (2, 16)).astype(np.int32)
    np.testing.assert_allclose(
        T.transformer_forward_single(pt, torch.from_numpy(toks),
                                     ct).detach().numpy(),
        np.asarray(J.transformer_forward_single(pj, jnp.asarray(toks), cj)),
        **TOL)
    step_j = J.make_transformer_train_step(cj, _mesh5(), lr=0.1)
    step_t = T.make_transformer_train_step(ct, None, lr=0.1)
    for _ in range(2):
        tok, tgt = (rng.randint(0, 64, (2, 16)).astype(np.int32)
                    for _ in range(2))
        pj, lj = step_j(pj, jnp.asarray(tok), jnp.asarray(tgt))
        pt, lt = step_t(pt, torch.from_numpy(tok), torch.from_numpy(tgt))
        np.testing.assert_allclose(float(lt), float(lj), **TOL)
    got = params_to_numpy(pt)
    want = jax.tree_util.tree_map(np.asarray, pj)
    for k in want["layers"]:
        np.testing.assert_allclose(got["layers"][k], want["layers"][k],
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(got["embed"], want["embed"], **TOL)


def test_moe_loss_adds_one_hundredth_of_aux():
    _, ct = _configs()
    pt = T.init_transformer_params_np(ct, seed=1, device="cpu",
                                      trainable=True)
    tok, tgt = (torch.from_numpy(a) for a in np.random.RandomState(
        2).randint(0, 64, (2, 2, 8)))
    loss = T._lm_local_loss(pt, tok, tgt, ct)
    x = pt.embed[tok.long()] + pt.pos[:8]
    x, aux = T._stage_local(pt, x, ct)
    logp = torch.log_softmax(T._ln(x, pt.lnf_g, pt.lnf_b) @ pt.embed.T, -1)
    nll = -logp.gather(-1, tgt.long()[..., None]).mean()
    assert float(aux.detach()) > 0
    np.testing.assert_allclose(float(loss.detach()),
                               float((nll + 0.01 * aux).detach()), rtol=1e-6)
