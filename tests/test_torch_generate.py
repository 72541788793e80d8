"""The PyTorch/CUDA port's dense KV cache and ``transformer_generate``
against the JAX package.

On the CPU in float32, at the JAX package's decode tests' tiny configs
(learned positions; RoPE with GQA; MoE): the dense-cache prefill and
decode steps against the port's own full forward and against the JAX
package's prefill and decode steps (logits within 2e-4, as
test_parallel_5d.py holds its own decode; the caches within 1e-5),
greedy ``transformer_generate`` tokens equal to the JAX package's,
sampling held by definition (the port's draws are its own: the same
seed gives the same tokens, another seed others, ``top_k=1`` the
greedy stream, and every sampled token lies in the step's top k), the
dense and the paged greedy streams equal, and an MoE ``DecodeEngine``
on the paged kernels' plain versions giving the JAX engine's streams.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from mxnet_tpu.parallel import transformer as J  # noqa: E402
from mxnet_tpu.serve import DecodeConfig as JDecodeConfig  # noqa: E402
from mxnet_tpu.serve import DecodeEngine as JDecodeEngine  # noqa: E402
from mxnet_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402
from mxnet_tpu_torch.parallel import transformer as T  # noqa: E402
from mxnet_tpu_torch.serve import DecodeConfig, DecodeEngine  # noqa: E402

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
BASE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=16)
CONFIGS = {
    "learned": dict(BASE),
    "rope_gqa": dict(BASE, n_heads=8, n_kv_heads=2, pos_type="rope"),
    "moe": dict(BASE, num_experts=4, moe_top_k=2, capacity_factor=1.0),
}


def _mesh():
    dev = np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1)
    return Mesh(dev, ("dp", "sp", "tp", "pp", "ep"))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    cfg = CONFIGS[request.param]
    cj, ct = J.TransformerConfig(**cfg), T.TransformerConfig(**cfg)
    pj, _ = J.init_transformer_params(cj, _mesh(), seed=3)
    pt = T.init_transformer_params_np(ct, seed=3, device="cpu")
    return cj, ct, pj, pt


def test_dense_cache_decode_matches_full_forward_and_jax(model):
    """test_parallel_5d.py:226 / :269 / :314 / :381: prefill 3 tokens,
    then decode per position; every logit against the port's full
    forward and the JAX decode step, and the cache against JAX's."""
    cj, ct, pj, pt = model
    toks = np.random.RandomState(0).randint(0, 64, (2, 8)).astype(np.int32)
    full = T.transformer_forward_single(pt, torch.from_numpy(toks), ct)
    cache_t = T.init_kv_cache(ct, 2, max_len=16, device="cpu")
    assert cache_t["k"].shape == (2, 2, T._kv_heads(ct), 16,
                                  ct.d_model // ct.n_heads)
    cache_j = J.init_kv_cache(cj, 2, max_len=16)
    lt, cache_t = T.transformer_prefill(pt, torch.from_numpy(toks[:, :3]),
                                        cache_t, ct)
    lj, cache_j = J.transformer_prefill(pj, jnp.asarray(toks[:, :3]),
                                        cache_j, cj)
    if not ct.num_experts:     # MoE routes the prompt's 6 tokens together
        np.testing.assert_allclose(lt.numpy(), full[:, 2].numpy(),
                                   **LOGIT_TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    for t in range(3, 8):
        lt, cache_t = T.transformer_decode_step(
            pt, cache_t, torch.from_numpy(toks[:, t]), t, ct)
        lj, cache_j = J.transformer_decode_step(
            pj, cache_j, jnp.asarray(toks[:, t]), t, cj)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        if not ct.num_experts:
            np.testing.assert_allclose(lt.numpy(), full[:, t].numpy(),
                                       **LOGIT_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_t[key].numpy(),
                                   np.asarray(cache_j[key]), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["learned", "rope_gqa"])
def test_per_row_positions_mask_the_dense_tail(name):
    """Rows at their own depths see only positions <= their own: a
    ragged step equals each row's step alone (not for MoE, whose
    capacity couples a step's rows by design)."""
    ct = T.TransformerConfig(**CONFIGS[name])
    pt = T.init_transformer_params_np(ct, seed=3, device="cpu")
    toks = np.random.RandomState(1).randint(0, 64, (2, 6)).astype(np.int32)
    cache = T.init_kv_cache(ct, 2, max_len=16, device="cpu")
    _, cache = T.transformer_prefill(pt, torch.from_numpy(toks), cache, ct)
    pos = torch.tensor([3, 5], dtype=torch.int32)
    both, _ = T.transformer_decode_step(
        pt, {k: v.clone() for k, v in cache.items()},
        torch.from_numpy(toks[:, 0]), pos, ct)
    for r in range(2):
        one = {k: v[:, r:r + 1].clone() for k, v in cache.items()}
        alone, _ = T.transformer_decode_step(
            pt, one, torch.from_numpy(toks[r:r + 1, 0]), pos[r:r + 1], ct)
        np.testing.assert_allclose(both[r].numpy(), alone[0].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_greedy_generate_equals_jax(model):
    cj, ct, pj, pt = model
    prompt = np.random.RandomState(2).randint(0, 64, (2, 4)).astype(
        np.int32)
    gj = np.asarray(J.transformer_generate(pj, jnp.asarray(prompt), 6, cj))
    gt = T.transformer_generate(pt, torch.from_numpy(prompt), 6, ct)
    assert gt.dtype == torch.int32 and gt.shape == (2, 6)
    np.testing.assert_array_equal(gt.numpy(), gj)
    # and a full-forward greedy rollout (test_parallel_5d.py:226)
    if not ct.num_experts:
        cur = torch.from_numpy(prompt).long()
        for _ in range(6):
            nxt = T.transformer_forward_single(pt, cur, ct)[:, -1].argmax(-1)
            cur = torch.cat([cur, nxt[:, None]], 1)
        np.testing.assert_array_equal(gt.numpy(), cur[:, 4:].numpy())


def test_generate_sampling_by_definition():
    """test_parallel_5d.py:427 (the port's draws are its own)."""
    ct = T.TransformerConfig(**dict(BASE, max_len=24))
    pt = T.init_transformer_params_np(ct, seed=7, device="cpu")
    prompt = torch.from_numpy(np.random.RandomState(3).randint(
        0, 64, (2, 6)).astype(np.int32))
    g1 = T.transformer_generate(pt, prompt, 6, ct)
    assert torch.equal(g1, T.transformer_generate(pt, prompt, 6, ct))
    s1 = T.transformer_generate(pt, prompt, 6, ct, temperature=1.0, seed=1)
    s2 = T.transformer_generate(pt, prompt, 6, ct, temperature=1.0, seed=1)
    s3 = T.transformer_generate(pt, prompt, 6, ct, temperature=1.0, seed=9)
    assert torch.equal(s1, s2) and not torch.equal(s1, s3)
    t1 = T.transformer_generate(pt, prompt, 6, ct, temperature=1.0,
                                top_k=1, seed=4)
    assert torch.equal(t1, g1)
    # a sampled first token lies in the prompt's top 3
    cache = T.init_kv_cache(ct, 2, 24, device="cpu")
    logits, _ = T.transformer_prefill(pt, prompt, cache, ct)
    top3 = torch.topk(logits, 3).indices
    for seed in range(12):
        first = T.transformer_generate(pt, prompt, 1, ct, temperature=2.0,
                                       top_k=3, seed=seed)[:, 0]
        assert all(int(first[r]) in top3[r].tolist() for r in range(2))
    with pytest.raises(ValueError, match="max_len"):
        T.transformer_generate(pt, prompt, 19, ct)


def test_dense_and_paged_greedy_streams_are_equal():
    cfg = T.TransformerConfig(**dict(BASE, n_kv_heads=2, pos_type="rope",
                                     max_len=32))
    pt = T.init_transformer_params_np(cfg, seed=5, device="cpu")
    prompt = torch.from_numpy(np.random.RandomState(4).randint(
        0, 64, (2, 8)).astype(np.int32))
    dense = T.transformer_generate(pt, prompt, 8, cfg)
    kp, vp = T.init_kv_pages(cfg, 17, 4, device="cpu")
    paged = T.PagedKVCache(kp, vp, torch.arange(1, 17, dtype=torch.int32)
                           .reshape(2, 8), 4)
    tfa.reset_launches()
    logits, paged = T.transformer_prefill(pt, prompt, paged, cfg)
    out = [logits.argmax(-1).to(torch.int32)]
    for t in range(7):
        logits, paged = T.transformer_decode_step(pt, paged, out[-1], 8 + t,
                                                  cfg)
        out.append(logits.argmax(-1).to(torch.int32))
    assert torch.equal(torch.stack(out, 1), dense)
    assert all(n == 0 for n in tfa.LAUNCHES.values())   # plain versions


def test_moe_decode_engine_streams_equal_jax_engine():
    """An MoE config served by both engines, one request at a time
    (capacity counts a step's idle rows too, so the batches must
    agree): the port's paged prefill and decode steps give the JAX
    engine's streams."""
    cfg = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
               n_layers=2, d_ff=64, max_len=64, pos_type="rope",
               num_experts=4, capacity_factor=2.0)
    cj, ct = J.TransformerConfig(**cfg), T.TransformerConfig(**cfg)
    pj, _ = J.init_transformer_params(cj, _mesh(), seed=11)
    pt = T.init_transformer_params_np(ct, seed=11, device="cpu")
    rng = np.random.RandomState(5)
    reqs = [([int(t) for t in rng.randint(0, 64, (pl,))], mn)
            for pl, mn in ((3, 6), (7, 5), (12, 4))]
    dcfg = dict(slots=4, page_size=4, num_pages=64, max_context=32,
                queue_depth=8, max_new_tokens=16, default_timeout_ms=60000)
    jeng = JDecodeEngine(pj, cj, JDecodeConfig(**dcfg)).start().warmup()
    try:
        jout = [jeng.submit(p, mn).result() for p, mn in reqs]
    finally:
        jeng.close(drain=False)
    eng = DecodeEngine(pt, ct, DecodeConfig(**dcfg),
                       device="cpu").start().warmup()
    try:
        tout = [eng.submit(p, mn).result() for p, mn in reqs]
    finally:
        eng.close(drain=False)
    assert [len(o) for o in tout] == [mn for _, mn in reqs]
    assert tout == jout
