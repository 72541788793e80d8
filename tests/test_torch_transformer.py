"""The PyTorch/CUDA port's transformer against the JAX package.

Same seeded weights in both packages (``init_transformer_params_np`` vs
``init_transformer_params``), the JAX pytree round trip through
``convert.params_from_jax``, and the paged prefill / decode step /
reference forward held against the JAX functions on the CPU in float32
(logits and pools within 1e-4), at the JAX decode tests' tiny config.
The layer helpers that differ between the frameworks unless ported
with care (tanh GELU, ``jnp.repeat``, RoPE's f32-then-cast order) each
get a unit check. MoE configs and the dense KV cache, refused until they
were ported, are held here at their entry points (and at length in
tests/test_torch_moe.py and tests/test_torch_generate.py).
"""
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
from mxnet_tpu_torch.parallel import transformer as T  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=64, max_len=64)
PAGE = 4


def _mesh():
    dev = np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1)
    return Mesh(dev, ("dp", "sp", "tp", "pp", "ep"))


def _configs(**kw):
    cfg = dict(SMALL, **kw)
    return J.TransformerConfig(**cfg), T.TransformerConfig(**cfg)


@pytest.fixture(scope="module")
def model():
    cj, ct = _configs(pos_type="rope")
    pj, _ = J.init_transformer_params(cj, _mesh(), seed=11)
    pt = T.init_transformer_params_np(ct, seed=11, device="cpu")
    return cj, ct, pj, pt


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos_type", ["rope", "learned"])
def test_init_params_np_equals_jax_init(pos_type):
    cj, ct = _configs(pos_type=pos_type)
    pj = _np_tree(J.init_transformer_params(cj, _mesh(), seed=3)[0])
    pt = params_to_numpy(T.init_transformer_params_np(ct, seed=3,
                                                      device="cpu"))
    assert set(pt) == set(pj)
    assert set(pt["layers"]) == set(pj["layers"])
    for k in pj:
        if k != "layers":
            np.testing.assert_array_equal(pt[k], pj[k])
    for k in pj["layers"]:
        np.testing.assert_array_equal(pt["layers"][k], pj["layers"][k])


def test_params_from_jax_round_trips_pp2():
    """A (pp=2, lps=1) JAX tree flattens to n_layers and comes back."""
    cj, ct = _configs(pos_type="learned")
    dev = np.array(jax.devices()[:2]).reshape(1, 1, 1, 2, 1)
    pj = _np_tree(J.init_transformer_params(
        cj, Mesh(dev, ("dp", "sp", "tp", "pp", "ep")), seed=5)[0])
    pt = params_from_jax(pj, ct, device="cpu")
    assert tuple(pt.layers["wq"].shape) == (2, 32, 32)
    back = params_to_numpy(pt, pp=2)
    for k in ("embed", "pos", "lnf_g", "lnf_b"):
        np.testing.assert_array_equal(back[k], pj[k])
    for k in pj["layers"]:
        np.testing.assert_array_equal(back["layers"][k], pj["layers"][k])


@pytest.mark.parametrize("bad", ["missing", "extra", "layer_missing",
                                 "layer_extra", "shape", "stack"])
def test_params_from_jax_rejects_bad_trees(model, bad):
    cj, ct, pj, _ = model
    tree = _np_tree(pj)
    tree["layers"] = dict(tree["layers"])
    if bad == "missing":
        del tree["lnf_b"]
    elif bad == "extra":
        tree["pos"] = np.zeros((64, 32), np.float32)  # rope has no table
    elif bad == "layer_missing":
        del tree["layers"]["wq"]
    elif bad == "layer_extra":
        tree["layers"]["gate"] = np.zeros((1, 2, 32, 4), np.float32)
    elif bad == "shape":
        tree["embed"] = tree["embed"][:, :16]
    else:
        tree["layers"]["w1"] = tree["layers"]["w1"][:, :1]
    with pytest.raises(MXNetError):
        params_from_jax(tree, ct, device="cpu")


def test_moe_config_not_ported():
    """MoE configs were refused until they were ported; now the init
    gives the JAX package's MoE weights (gate, we1, we2 for w1, w2)."""
    cj, ct = _configs(num_experts=4)
    pt = params_to_numpy(T.init_transformer_params_np(ct, seed=2,
                                                      device="cpu"))
    pj = _np_tree(J.init_transformer_params(cj, _mesh(), seed=2)[0])
    assert set(pt["layers"]) == set(pj["layers"]) == set(T.MOE_LAYER_KEYS)
    for k in pj["layers"]:
        np.testing.assert_array_equal(pt["layers"][k], pj["layers"][k])


# ---------------------------------------------------------------------------
# layer helpers
# ---------------------------------------------------------------------------

def test_gelu_is_jax_tanh_gelu():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(T._gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_expand_kv_is_jnp_repeat():
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    np.testing.assert_array_equal(
        T._expand_kv(torch.from_numpy(x), 3, 2).numpy(),
        np.asarray(J._expand_kv(jnp.asarray(x), 3, 2)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 7, 8).astype(np.float32)
    pos = np.arange(7) + 5
    got = T._rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                  torch.from_numpy(pos), 10000.0).float().numpy()
    ref = np.asarray(J._rope(jnp.asarray(x, getattr(jnp, dtype)),
                             jnp.asarray(pos), 10000.0)).astype(np.float32)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    tok = rng.randn(3, 4, 8).astype(np.float32)
    pb = np.array([0, 9, 31], np.int32)
    np.testing.assert_allclose(
        T._rope_token(torch.from_numpy(tok), torch.from_numpy(pb),
                      10000.0).numpy(),
        np.asarray(J._rope_token(jnp.asarray(tok), jnp.asarray(pb),
                                 10000.0)), rtol=1e-5, atol=1e-5)


def test_layer_norm_matches_jax():
    x = np.random.RandomState(1).randn(4, 32).astype(np.float32) * 3 + 1
    g = np.linspace(0.5, 1.5, 32).astype(np.float32)
    b = np.linspace(-1, 1, 32).astype(np.float32)
    np.testing.assert_allclose(
        T._ln(*(torch.from_numpy(a) for a in (x, g, b))).numpy(),
        np.asarray(J._ln(*(jnp.asarray(a) for a in (x, g, b)))),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# model paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos_type", ["rope", "learned"])
def test_forward_single_matches_jax(pos_type):
    cj, ct = _configs(pos_type=pos_type)
    pj = J.init_transformer_params(cj, _mesh(), seed=2)[0]
    pt = T.init_transformer_params_np(ct, seed=2, device="cpu")
    toks = np.random.RandomState(2).randint(0, 64, (2, 9)).astype(np.int32)
    ref = J.transformer_forward_single(pj, jnp.asarray(toks), cj)
    got = T.transformer_forward_single(pt, torch.from_numpy(toks), ct)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _paged_pair(cj, ct, bt, num_pages=24):
    kj, vj = J.init_kv_pages(cj, num_pages, PAGE)
    kt, vt = T.init_kv_pages(ct, num_pages, PAGE, device="cpu")
    return (J.PagedKVCache(kj, vj, jnp.asarray(bt), PAGE),
            T.PagedKVCache(kt, vt, torch.from_numpy(bt), PAGE))


def _assert_pools(cache_j, cache_t):
    np.testing.assert_allclose(cache_t.k_pages.numpy(),
                               np.asarray(cache_j.k_pages), **TOL)
    np.testing.assert_allclose(cache_t.v_pages.numpy(),
                               np.asarray(cache_j.v_pages), **TOL)


def test_prefill_paged_and_decode_steps_match_jax(model):
    """A ragged batch-2 bucket prefill, then 4 per-row-position decode
    steps: logits and both pools stay within 1e-4 of the JAX
    package's."""
    cj, ct, pj, pt = model
    rng = np.random.RandomState(4)
    bt = np.array([[1, 2, 3, 4, 5, 6, 7, 8],
                   [9, 10, 11, 12, 13, 14, 15, 16]], np.int32)
    cache_j, cache_t = _paged_pair(cj, ct, bt)
    toks = rng.randint(0, 64, (2, 16)).astype(np.int32)
    lens = np.array([6, 16], np.int32)
    lj, cache_j = J.transformer_prefill_paged(
        pj, cache_j, jnp.asarray(toks), jnp.asarray(lens), cj)
    lt, cache_t = T.transformer_prefill_paged(
        pt, cache_t, torch.from_numpy(toks), torch.from_numpy(lens), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _assert_pools(cache_j, cache_t)
    pos = lens.copy()
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for _ in range(4):
        lj, cache_j = J.transformer_decode_step(
            pj, cache_j, jnp.asarray(tok), jnp.asarray(pos), cj)
        lt, cache_t = T.transformer_decode_step(
            pt, cache_t, torch.from_numpy(tok), torch.from_numpy(pos), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        _assert_pools(cache_j, cache_t)
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        pos += 1


def test_decode_step_paged_convenience_matches_jax(model):
    cj, ct, pj, pt = model
    bt = np.array([[3, 4, 5, 6, 7, 8, 9, 10]], np.int32)
    cache_j, cache_t = _paged_pair(cj, ct, bt)
    for p in range(5):                       # a scalar position
        lj, kj, vj = J.transformer_decode_step_paged(
            pj, cache_j.k_pages, cache_j.v_pages, cache_j.block_tables,
            jnp.asarray([p + 1], jnp.int32), p, cj, PAGE)
        cache_j = J.PagedKVCache(kj, vj, cache_j.block_tables, PAGE)
        lt, kt, vt = T.transformer_decode_step_paged(
            pt, cache_t.k_pages, cache_t.v_pages, cache_t.block_tables,
            torch.tensor([p + 1], dtype=torch.int32), p, ct, PAGE)
        assert kt is cache_t.k_pages             # updated in place
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _assert_pools(cache_j, cache_t)


def test_prefill_then_decode_tracks_forward_single(model):
    """Within the port: prefill + decode logits equal the no-cache
    reference forward at the same positions."""
    _, ct, _, pt = model
    toks = np.random.RandomState(8).randint(0, 64, (1, 11)).astype(np.int32)
    full = T.transformer_forward_single(pt, torch.from_numpy(toks), ct)
    kt, vt = T.init_kv_pages(ct, 8, PAGE, device="cpu")
    cache = T.PagedKVCache(kt, vt, torch.arange(1, 5, dtype=torch.int32)[
        None], PAGE)
    lp, cache = T.transformer_prefill_paged(
        pt, cache, torch.from_numpy(toks[:, :8]),
        torch.tensor([8], dtype=torch.int32), ct)
    np.testing.assert_allclose(lp.numpy(), full[:, 7].numpy(), **TOL)
    for p in range(8, 11):
        ld, cache = T.transformer_decode_step(
            pt, cache, torch.from_numpy(toks[:, p]), p, ct)
        np.testing.assert_allclose(ld.numpy(), full[:, p].numpy(), **TOL)


def test_dense_cache_not_ported(model):
    """The dense cache was refused until it was ported; now a decode
    step over it gives the paged step's logits, and only a malformed
    cache raises."""
    _, ct, _, pt = model
    tok = torch.tensor([5], dtype=torch.int32)
    dense, _ = T.transformer_decode_step(
        pt, T.init_kv_cache(ct, 1, 16, device="cpu"), tok, 0, ct)
    kt, vt = T.init_kv_pages(ct, 8, PAGE, device="cpu")
    paged, _ = T.transformer_decode_step(
        pt, T.PagedKVCache(kt, vt, torch.arange(1, 5, dtype=torch.int32)[
            None], PAGE), tok, 0, ct)
    np.testing.assert_allclose(dense.numpy(), paged.numpy(), **TOL)
    with pytest.raises(TypeError, match="dense dict"):
        T.transformer_decode_step(pt, {"k": None, "v": None}, tok, 0, ct)
