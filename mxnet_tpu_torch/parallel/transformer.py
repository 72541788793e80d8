"""Decoder-only transformer LM: decode serving, generation and
single-device training.

Counterpart of the JAX package's ``parallel/transformer.py`` on a mesh of
one device: the reference forward, the train step
``make_transformer_train_step`` (with ``remat`` and MoE layers), the
prefill and decode step over either KV cache (the dense dict of
:func:`init_kv_cache` or a :class:`PagedKVCache`), and
:func:`transformer_generate`. Weights live in a :class:`TransformerParams`
module in the JAX package's layout (``x @ w``; per-layer stacks
flattened from ``(pp, layers_per_stage, ...)`` to ``(n_layers, ...)``),
so the two packages load the same numbers (``convert.params_from_jax``,
:func:`init_transformer_params_np`).

Caches are updated IN PLACE. The paged prefill writes each layer's
prompt K/V through the ``flash_prefill_paged`` kernel and the paged
decode step writes the new token's K/V before ``paged_decode_attention``
reads the pool, on one stream. The dense cache's attention is plain
tensor ops (einsum, the ``<= pos`` mask at -1e30, softmax), as the JAX
package leaves it to XLA. The train step runs the layer math with the
``flash_attention`` kernel (forward and backward) and updates the
weights in place. MoE layers route by index (``parallel/moe.py``); their
capacity counts every token of the call, padded or idle rows included,
as the JAX package's does. Sharded meshes (dp/sp/tp/pp/ep above 1) are
ROADMAP A13/A15.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..base import MXNetError
from ..context import default_device
from ..ops.cuda.flash_attention import (flash_prefill_paged,
                                        paged_decode_attention)
from .moe import moe_ffn
from .ring_attention import ring_attention_local

__all__ = ["TransformerConfig", "TransformerParams", "LAYER_KEYS",
           "MOE_LAYER_KEYS", "layer_keys", "init_transformer_params_np",
           "transformer_forward_single", "init_kv_cache", "init_kv_pages",
           "PagedKVCache", "transformer_decode_step",
           "transformer_decode_step_paged", "transformer_prefill",
           "transformer_prefill_paged", "transformer_generate",
           "make_transformer_train_step", "AXES"]

NEG_INF = -1e30

# the JAX package's mesh axes, in its order
AXES = ("dp", "sp", "tp", "pp", "ep")

# per-layer weights of the dense (no-MoE) block, in the JAX layout
LAYER_KEYS = ("ln1_g", "ln1_b", "ln2_g", "ln2_b", "wq", "wk", "wv", "wo",
              "w1", "w2")
# and of the MoE block: the router and the stacked experts
MOE_LAYER_KEYS = LAYER_KEYS[:-2] + ("gate", "we1", "we2")


@dataclass
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 4
    # grouped-query attention: number of shared K/V heads (None = MHA)
    n_kv_heads: int = None
    n_layers: int = 4
    d_ff: int = 256
    max_len: int = 512
    num_experts: int = 0          # 0 = dense FFN; >0 = MoE FFN
    moe_top_k: int = 2
    capacity_factor: float = 2.0
    dtype: torch.dtype = torch.float32
    # sequence-parallel attention: "ring" or "ulysses"; on one device
    # both are the ring body's flash_attention call
    sp_attn: str = "ring"
    # recompute each block in the backward (torch.utils.checkpoint)
    remat: bool = False
    # "learned" adds a trained position table; "rope" rotates q/k
    pos_type: str = "learned"
    rope_base: float = 10000.0


def _kv_heads(cfg):
    return cfg.n_kv_heads or cfg.n_heads


def layer_keys(cfg):
    """The per-layer weight names of ``cfg``'s block."""
    return MOE_LAYER_KEYS if cfg.num_experts else LAYER_KEYS


def _validate(cfg):
    if cfg.num_experts < 0:
        raise ValueError("num_experts must be >= 0, got %r"
                         % (cfg.num_experts,))
    if cfg.num_experts and cfg.moe_top_k < 1:
        raise ValueError("moe_top_k must be >= 1, got %r"
                         % (cfg.moe_top_k,))
    kvh = cfg.n_kv_heads
    if kvh is not None:
        if not isinstance(kvh, int) or kvh < 1:
            raise ValueError("n_kv_heads must be a positive int, got %r"
                             % (kvh,))
        if cfg.n_heads % kvh:
            raise ValueError("n_heads=%d must divide by n_kv_heads=%d"
                             % (cfg.n_heads, kvh))
    if cfg.pos_type not in ("learned", "rope"):
        raise ValueError("pos_type must be 'learned' or 'rope', got %r"
                         % (cfg.pos_type,))
    if cfg.sp_attn not in ("ring", "ulysses"):
        raise ValueError("sp_attn must be 'ring' or 'ulysses', got %r"
                         % (cfg.sp_attn,))


def expected_shapes(cfg):
    """{name: shape} of every weight, layer stacks as (n_layers, ...)."""
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    kvd = _kv_heads(cfg) * (d // cfg.n_heads)
    shapes = {"embed": (V, d), "lnf_g": (d,), "lnf_b": (d,)}
    if cfg.pos_type == "learned":
        shapes["pos"] = (cfg.max_len, d)
    shapes.update({
        "ln1_g": (L, d), "ln1_b": (L, d), "ln2_g": (L, d), "ln2_b": (L, d),
        "wq": (L, d, d), "wk": (L, d, kvd), "wv": (L, d, kvd),
        "wo": (L, d, d)})
    if cfg.num_experts:
        E = cfg.num_experts
        shapes.update({"gate": (L, d, E), "we1": (L, E, d, f),
                       "we2": (L, E, f, d)})
    else:
        shapes.update({"w1": (L, d, f), "w2": (L, f, d)})
    return shapes


class TransformerParams(nn.Module):
    """The model's weights: ``embed`` (tied output projection), final
    LayerNorm ``lnf_g``/``lnf_b``, ``pos`` for learned positions, and
    ``layers[name]`` stacked (n_layers, ...) for every name in
    :func:`layer_keys` (the MoE block's ``gate`` / ``we1`` / ``we2`` in
    place of ``w1`` / ``w2``). Serving weights (the default) take no
    gradients; ``trainable=True`` makes every weight a leaf that does,
    for :func:`make_transformer_train_step`."""

    def __init__(self, cfg, tensors, trainable=False):
        super().__init__()
        _validate(cfg)
        shapes = expected_shapes(cfg)
        for name, shape in shapes.items():
            t = tensors[name]
            if tuple(t.shape) != shape:
                raise MXNetError("%s: shape %s, expected %s"
                                 % (name, tuple(t.shape), shape))
        grad = bool(trainable)
        self.embed = nn.Parameter(tensors["embed"], requires_grad=grad)
        self.lnf_g = nn.Parameter(tensors["lnf_g"], requires_grad=grad)
        self.lnf_b = nn.Parameter(tensors["lnf_b"], requires_grad=grad)
        self.pos = (nn.Parameter(tensors["pos"], requires_grad=grad)
                    if "pos" in shapes else None)
        self.layers = nn.ParameterDict({
            k: nn.Parameter(tensors[k], requires_grad=grad)
            for k in layer_keys(cfg)})

    def layer(self, li):
        """Layer ``li``'s weights as views, keyed like the JAX pytree."""
        return {k: p[li] for k, p in self.layers.items()}


def _init_numpy(cfg, seed):
    """The JAX package's ``init_transformer_params`` draws, with pp=1:
    the same ``RandomState(seed)`` stream in the same order, returned as
    float64 numpy arrays in its (1, n_layers, ...) pytree layout."""
    rng = np.random.RandomState(seed)
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    kvd = _kv_heads(cfg) * (d // cfg.n_heads)

    def rand(*shape):
        return rng.randn(*shape) * 0.02

    layers = {
        "ln1_g": np.ones((1, L, d)), "ln1_b": np.zeros((1, L, d)),
        "ln2_g": np.ones((1, L, d)), "ln2_b": np.zeros((1, L, d)),
        "wq": rand(1, L, d, d), "wk": rand(1, L, d, kvd),
        "wv": rand(1, L, d, kvd), "wo": rand(1, L, d, d),
    }
    if cfg.num_experts:
        E = cfg.num_experts
        layers["gate"] = rand(1, L, d, E)
        layers["we1"] = rand(1, L, E, d, f)
        layers["we2"] = rand(1, L, E, f, d)
    else:
        layers["w1"] = rand(1, L, d, f)
        layers["w2"] = rand(1, L, f, d)
    params = {"embed": rand(V, d), "lnf_g": np.ones((d,)),
              "lnf_b": np.zeros((d,)), "layers": layers}
    if cfg.pos_type == "learned":
        params["pos"] = rand(cfg.max_len, d)
    return params


def init_transformer_params_np(cfg: TransformerConfig, seed=0,
                               device=None, trainable=False):
    """Seeded weights equal to the JAX package's
    ``init_transformer_params(cfg, mesh, seed)`` (drawn from
    ``np.random.RandomState(seed)`` in the same order, cast to
    ``cfg.dtype``), as a :class:`TransformerParams` on ``device``
    (default ``cuda:0``; pass ``"cpu"`` for the host); ``trainable``
    as for :class:`TransformerParams`."""
    from ..convert import params_from_jax
    _validate(cfg)
    return params_from_jax(_init_numpy(cfg, seed), cfg, device,
                           trainable=trainable)


# ---------------------------------------------------------------------------
# layer math (each helper mirrors the JAX function of the same name)
# ---------------------------------------------------------------------------

def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)     # biased, as jnp.var
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _expand_kv(t, groups, dim):
    """Repeat each K/V head ``groups`` times (``jnp.repeat``, not
    ``Tensor.repeat``) so grouped K/V line up with the query heads."""
    return t if groups == 1 else torch.repeat_interleave(t, groups, dim=dim)


def _rope(t, positions, base):
    """Rotary embedding over the trailing head_dim: the (first half,
    second half) pairs rotate by position-scaled angles. ``cos``/``sin``
    are computed in float32 and cast to ``t``'s dtype before the
    multiply, as the JAX package does."""
    hd = t.shape[-1]
    half = hd // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=t.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang).to(t.dtype)
    sin = torch.sin(ang).to(t.dtype)
    t1 = t[..., :half]
    t2 = t[..., half:]
    return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], dim=-1)


def _rope_bshd(t, positions, base):
    """RoPE for (b, s, h, hd): heads out, rotate, heads back."""
    return _rope(t.transpose(1, 2), positions, base).transpose(1, 2)


def _rope_token(t, pos_b, base):
    """RoPE for one token per row: t (b, heads, hd), pos_b (b,)."""
    return _rope(t[..., None, :], pos_b[:, None, None], base)[..., 0, :]


def _ffn(lp, x, cfg):
    """The block's feed-forward over x (..., d) -> (out, aux): the dense
    FFN (aux 0), or the MoE FFN over all of x's tokens at once, whose
    capacity therefore counts every row of the call."""
    if not cfg.num_experts:
        return _gelu(x @ lp["w1"]) @ lp["w2"], None
    out, aux = moe_ffn(x.reshape(-1, x.shape[-1]), lp["gate"], lp["we1"],
                       lp["we2"], cfg.capacity_factor, cfg.moe_top_k)
    return out.reshape(x.shape), aux


def _embed(params, tokens, positions, cfg):
    x = params.embed[tokens.long()]
    if cfg.pos_type == "learned":
        x = x + params.pos[positions.long()]
    return x


def transformer_forward_single(params, tokens, cfg: TransformerConfig):
    """Single-device reference forward: tokens (b, s) -> logits (b, s,
    V), full causal attention in the working dtype (no cache)."""
    _validate(cfg)
    b, s = tokens.shape
    hd = cfg.d_model // cfg.n_heads
    kvh = _kv_heads(cfg)
    groups = cfg.n_heads // kvh
    pos = torch.arange(s, device=tokens.device)
    x = _embed(params, tokens, pos, cfg)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                 device=tokens.device))
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        h = _ln(x, lp["ln1_g"], lp["ln1_b"])
        q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, hd)
        k = _expand_kv((h @ lp["wk"]).reshape(b, s, kvh, hd), groups, 2)
        v = _expand_kv((h @ lp["wv"]).reshape(b, s, kvh, hd), groups, 2)
        if cfg.pos_type == "rope":
            q = _rope_bshd(q, pos, cfg.rope_base)
            k = _rope_bshd(k, pos, cfg.rope_base)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        sc = torch.where(mask, sc, NEG_INF)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)
        x = x + o.reshape(b, s, cfg.d_model) @ lp["wo"]
        x = x + _ffn(lp, _ln(x, lp["ln2_g"], lp["ln2_b"]), cfg)[0]
    x = _ln(x, params.lnf_g, params.lnf_b)
    return x @ params.embed.T


# ---------------------------------------------------------------------------
# KV caches: dense and paged
# ---------------------------------------------------------------------------

class PagedKVCache(object):
    """Paged KV-cache view: the pooled pages plus per-row block tables.

    ``k_pages``/``v_pages``: (layers, num_pages, page_size, kv_heads,
    hd), preallocated once and shared by every live sequence.
    ``block_tables``: (b, pages_per_seq) int32 — position ``p`` of row
    ``r`` lives at page ``block_tables[r, p // page_size]``, offset ``p
    % page_size``. The functions below write the pool in place."""

    __slots__ = ("k_pages", "v_pages", "block_tables", "page_size")

    def __init__(self, k_pages, v_pages, block_tables, page_size):
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.block_tables = block_tables
        self.page_size = int(page_size)

    @property
    def max_context(self):
        """Positions addressable per row via the block table."""
        return self.block_tables.shape[1] * self.page_size


def init_kv_pages(cfg: TransformerConfig, num_pages, page_size,
                  device=None):
    """Zeroed page pool ``(k_pages, v_pages)``, each (layers, num_pages,
    page_size, kv_heads, hd) in ``cfg.dtype``: 2 * layers * num_pages *
    page_size * kv_heads * hd * itemsize bytes, sized once."""
    hd = cfg.d_model // cfg.n_heads
    shape = (cfg.n_layers, int(num_pages), int(page_size), _kv_heads(cfg),
             hd)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def init_kv_cache(cfg: TransformerConfig, batch, max_len=None,
                  device=None):
    """Zeroed dense K/V cache: ``{"k", "v"}``, each (layers, batch,
    kv_heads, max_len, hd) in ``cfg.dtype`` on ``device`` (default
    ``cuda:0``). GQA stores only the shared heads."""
    max_len = max_len or cfg.max_len
    hd = cfg.d_model // cfg.n_heads
    shape = (cfg.n_layers, int(batch), _kv_heads(cfg), int(max_len), hd)
    device = default_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _check_cache(cache):
    if isinstance(cache, PagedKVCache):
        return
    if not (isinstance(cache, dict) and set(cache) == {"k", "v"}
            and all(isinstance(t, torch.Tensor) for t in cache.values())):
        raise TypeError("cache must be a PagedKVCache or the dense dict "
                        "{'k', 'v'} of init_kv_cache, got %r"
                        % (type(cache).__name__,))


def _positions_vec(pos, b, device):
    """Per-row int32 positions (b,) from a scalar or a (b,) vector."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if pos.dim() == 0:
        pos = pos.expand(b)
    return pos


def _cache_write_token(cache, li, k_t, v_t, pos_b):
    """Write one token's K/V (b, kv_heads, hd) of layer ``li`` at each
    row's position, in place, into either cache layout. Paged padding
    rows all aim at the null page's offset 0; which of those writes lands
    is unspecified and unread."""
    pos_l = pos_b.long()
    if not isinstance(cache, PagedKVCache):
        rows = torch.arange(k_t.shape[0], device=k_t.device)
        cache["k"][li][rows, :, pos_l] = k_t.to(cache["k"].dtype)
        cache["v"][li][rows, :, pos_l] = v_t.to(cache["v"].dtype)
        return cache
    page = cache.block_tables.long().gather(
        1, (pos_l // cache.page_size)[:, None])[:, 0]
    off = pos_l % cache.page_size
    cache.k_pages[li][page, off] = k_t.to(cache.k_pages.dtype)
    cache.v_pages[li][page, off] = v_t.to(cache.v_pages.dtype)
    return cache


def _cache_attend(cache, li, q, pos_b, cfg):
    """One-token GQA attention against layer ``li`` of either cache: q
    (b, n_heads, hd) -> context (b, d_model). Rows see positions <= their
    own: through the paged decode kernel, or over the dense strip with
    later positions masked at -1e30 (the JAX package's XLA math)."""
    b, nh, hd = q.shape
    kvh = _kv_heads(cfg)
    if isinstance(cache, PagedKVCache):
        o = paged_decode_attention(
            q.reshape(b, kvh, nh // kvh, hd).contiguous(),
            cache.k_pages[li], cache.v_pages[li], cache.block_tables,
            pos_b + 1, sm_scale=1.0 / math.sqrt(hd))
        return o.reshape(b, cfg.d_model)
    kc = cache["k"][li]                           # (b, kvh, max_len, hd)
    vc = cache["v"][li]
    L = kc.shape[2]
    visible = (torch.arange(L, device=q.device)[None, :]
               <= pos_b.long()[:, None])                          # (b, L)
    qg = q.reshape(b, kvh, nh // kvh, hd)
    sc = torch.einsum("bkgd,bkld->bkgl", qg, kc) / math.sqrt(hd)
    sc = torch.where(visible[:, None, None, :], sc, NEG_INF)
    o = torch.einsum("bkgl,bkld->bkgd", torch.softmax(sc, -1), vc)
    return o.reshape(b, cfg.d_model)


def transformer_decode_step(params, cache, tokens_t, pos,
                            cfg: TransformerConfig):
    """One decode step: tokens_t (b,) at position(s) ``pos`` (a scalar
    or a (b,) vector, every row at its own depth) -> (logits (b, V),
    cache). ``cache`` is the dense dict of :func:`init_kv_cache` or a
    :class:`PagedKVCache`; each layer writes the token's K/V into it
    first, then attends positions <= pos. An MoE layer routes the b
    tokens of the step together."""
    _validate(cfg)
    _check_cache(cache)
    b = tokens_t.shape[0]
    hd = cfg.d_model // cfg.n_heads
    kvh = _kv_heads(cfg)
    pos_b = _positions_vec(pos, b, tokens_t.device)
    x = _embed(params, tokens_t, pos_b, cfg)                     # (b, d)
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        h = _ln(x, lp["ln1_g"], lp["ln1_b"])
        q = (h @ lp["wq"]).reshape(b, cfg.n_heads, hd)
        k_t = (h @ lp["wk"]).reshape(b, kvh, hd)
        v_t = (h @ lp["wv"]).reshape(b, kvh, hd)
        if cfg.pos_type == "rope":
            q = _rope_token(q, pos_b, cfg.rope_base)
            k_t = _rope_token(k_t, pos_b, cfg.rope_base)
        _cache_write_token(cache, li, k_t, v_t, pos_b)
        o = _cache_attend(cache, li, q, pos_b, cfg)
        x = x + o @ lp["wo"]
        x = x + _ffn(lp, _ln(x, lp["ln2_g"], lp["ln2_b"]), cfg)[0]
    x = _ln(x, params.lnf_g, params.lnf_b)
    return x @ params.embed.T, cache


def _cache_write_prompt(cache, li, kg, vg):
    """Write a prompt's K/V (b, s, kv_heads, hd) of layer ``li`` into
    the dense cache's positions [0, s), in place."""
    s = kg.shape[1]
    cache["k"][li][:, :, :s] = kg.transpose(1, 2).to(cache["k"].dtype)
    cache["v"][li][:, :, :s] = vg.transpose(1, 2).to(cache["v"].dtype)
    return cache


def _prefill_impl(params, tokens, cache, cfg, lengths):
    """One batched causal forward that fills each row's cache and
    returns the logits of each row's last real position ``lengths - 1``
    (or position -1). A paged cache's layers go through the flash
    prefill kernel (attention and page write in one launch); the dense
    cache takes the prompt's K/V as written and the JAX package's plain
    causal attention (expanded K/V, einsum, -1e30 mask, softmax)."""
    _validate(cfg)
    _check_cache(cache)
    paged = isinstance(cache, PagedKVCache)
    b, s = tokens.shape
    hd = cfg.d_model // cfg.n_heads
    kvh = _kv_heads(cfg)
    groups = cfg.n_heads // kvh
    pos = torch.arange(s, device=tokens.device)
    x = _embed(params, tokens, pos, cfg)
    mask = None if paged else torch.tril(
        torch.ones((s, s), dtype=torch.bool, device=tokens.device))
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        h = _ln(x, lp["ln1_g"], lp["ln1_b"])
        q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, hd)
        kg = (h @ lp["wk"]).reshape(b, s, kvh, hd)
        vg = (h @ lp["wv"]).reshape(b, s, kvh, hd)
        if cfg.pos_type == "rope":
            # rotate BEFORE caching: decode stores rotated keys too
            q = _rope_bshd(q, pos, cfg.rope_base).contiguous()
            kg = _rope_bshd(kg, pos, cfg.rope_base).contiguous()
        if paged:
            o, _, _ = flash_prefill_paged(q, kg, vg, cache.k_pages[li],
                                          cache.v_pages[li],
                                          cache.block_tables)
        else:
            _cache_write_prompt(cache, li, kg, vg)
            k = _expand_kv(kg, groups, 2)
            v = _expand_kv(vg, groups, 2)
            sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            sc = torch.where(mask[None, None], sc, NEG_INF)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)
        x = x + o.reshape(b, s, cfg.d_model) @ lp["wo"]
        x = x + _ffn(lp, _ln(x, lp["ln2_g"], lp["ln2_b"]), cfg)[0]
    if lengths is None:
        xl = x[:, -1]
    else:
        last = torch.as_tensor(lengths, device=x.device).long() - 1
        xl = x[torch.arange(b, device=x.device), last]
    xl = _ln(xl, params.lnf_g, params.lnf_b)
    return xl @ params.embed.T, cache


def transformer_prefill(params, tokens, cache, cfg: TransformerConfig):
    """Fill ``cache`` (dense or paged) from the prompts ``tokens`` (b,
    s) with one batched causal forward; returns (logits at position -1
    (b, V), cache)."""
    return _prefill_impl(params, tokens, cache, cfg, lengths=None)


def transformer_prefill_paged(params, cache: PagedKVCache, tokens,
                              lengths, cfg: TransformerConfig):
    """Bucketed paged prefill: ``tokens`` (b, s) right-padded to the
    bucket ``s`` (a multiple of ``cache.page_size``), ``lengths`` (b,)
    real prompt lengths. Returns (logits at each row's position
    ``lengths-1`` (b, V), cache). The padded tail's K/V land in the
    row's own reserved pages but stay invisible: causality keeps them out
    of every real position, and decode masks positions > pos."""
    return _prefill_impl(params, tokens, cache, cfg, lengths=lengths)


def transformer_decode_step_paged(params, k_pages, v_pages, block_tables,
                                  tokens_t, pos, cfg: TransformerConfig,
                                  page_size):
    """Page-table-consuming decode step over raw pool tensors: returns
    (logits (b, V), k_pages, v_pages), the pools updated in place."""
    paged = PagedKVCache(k_pages, v_pages, block_tables, page_size)
    logits, paged = transformer_decode_step(params, paged, tokens_t, pos,
                                            cfg)
    return logits, paged.k_pages, paged.v_pages


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _step_generator(seed, step, device):
    """The draw stream of one generation step: a ``torch.Generator`` on
    ``device`` seeded from (seed, step), so that each step's draw depends
    on the seed and the step alone."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFF,
                                    int(step)]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) & 0x7FFFFFFFFFFFFFFF)


def _pick_token(logits, seed, step, temperature, top_k):
    """Next-token rule: greedy ``argmax`` at temperature 0 (the first
    index on ties; no generator is made); else the float32 logits over
    ``temperature``, with ``top_k`` only the scores ``>=`` the k-th
    largest kept, and one categorical draw a row from step ``step``'s
    stream (:func:`_step_generator`; Gumbel-max over uniforms in
    [tiny, 1), as ``jax.random.categorical`` draws; the numbers are the
    port's own)."""
    if temperature == 0.0:
        return logits.argmax(-1).to(torch.int32)
    gen = _step_generator(seed, step, logits.device)
    scaled = logits.float() / temperature
    if top_k:
        kth = torch.sort(scaled, dim=-1).values[:, -int(top_k)][:, None]
        scaled = torch.where(scaled >= kth, scaled,
                             torch.full_like(scaled, -math.inf))
    u = torch.rand(scaled.shape, generator=gen, device=scaled.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (scaled - torch.log(-torch.log(u))).argmax(-1).to(torch.int32)


def transformer_generate(params, prompt, steps, cfg: TransformerConfig,
                         max_len=None, temperature=0.0, top_k=0, seed=0):
    """Generation: prompt (b, s) integers -> (b, steps) int32 on the
    params' device. One batched prefill into a dense KV cache of
    ``max_len`` (default ``cfg.max_len``) positions, then one decode
    step a token. Greedy by default; ``temperature > 0`` samples
    (top-k filtered when ``top_k``) with step ``t``'s draw from a
    ``torch.Generator`` seeded by (``seed``, t)."""
    _validate(cfg)
    b, s = prompt.shape
    max_len = max_len or cfg.max_len
    if s + steps > max_len:
        raise ValueError("prompt + steps = %d exceeds max_len %d"
                         % (s + steps, max_len))
    temperature, top_k = float(temperature), int(top_k)
    dev = params.embed.device
    prompt = torch.as_tensor(prompt, device=dev).long()
    out = torch.empty((b, steps), dtype=torch.int32, device=dev)
    if steps == 0:
        return out
    with torch.no_grad():
        cache = init_kv_cache(cfg, b, max_len, device=dev)
        logits, cache = transformer_prefill(params, prompt, cache, cfg)
        out[:, 0] = _pick_token(logits, seed, 0, temperature, top_k)
        for t in range(1, steps):
            logits, cache = transformer_decode_step(
                params, cache, out[:, t - 1], s + t - 1, cfg)
            out[:, t] = _pick_token(logits, seed, t, temperature, top_k)
    return out


# ---------------------------------------------------------------------------
# single-device training
# ---------------------------------------------------------------------------

# the ROADMAP item that ports each mesh axis above size 1
_MESH_ITEMS = {"dp": "A13", "sp": "A13/A15", "tp": "A15", "pp": "A15",
               "ep": "A15"}


def _check_mesh(mesh):
    """``mesh``: None (every axis 1) or a dict of the five axis sizes,
    as the JAX package's Mesh carries them. Only size 1 is ported."""
    if mesh is None:
        return
    for ax in AXES:
        if ax not in mesh:
            raise ValueError("mesh is missing axis %r" % ax)
    extra = sorted(set(mesh) - set(AXES))
    if extra:
        raise ValueError("mesh has unknown axes %s (axes are %s)"
                         % (extra, AXES))
    for ax in AXES:
        n = int(mesh[ax])
        if n < 1:
            raise ValueError("mesh axis %r has size %d" % (ax, n))
        if n > 1:
            raise NotImplementedError(
                "mesh axis %r = %d: only a one-device mesh is ported; "
                "sharded training over torch.distributed is ROADMAP %s"
                % (ax, n, _MESH_ITEMS[ax]))


def _attention_local(lp, x, cfg, attn_impl="auto"):
    """x (b, s, d) -> attention block output (b, s, d), the JAX
    package's ``_attention_local`` on one device: K/V expanded to the
    query heads before the kernel, RoPE at positions 0..s-1, causal
    flash attention through the ring's local body (at sp = 1 Ulysses'
    local body is the same flash_attention call, ``ulysses.py:46``).
    ``attn_impl`` is the ring body's ``impl``: "auto" (the kernels, as
    the JAX package always takes) or "einsum" (plain tensor ops, the
    reference the kernels' route is held against on the card)."""
    b, s, d = x.shape
    hd = d // cfg.n_heads
    kvh = _kv_heads(cfg)
    groups = cfg.n_heads // kvh
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]

    def split(t, nh):
        return t.reshape(b, s, nh, hd).transpose(1, 2)

    qh = split(q, cfg.n_heads)
    kh = _expand_kv(split(k, kvh), groups, 1)
    vh = _expand_kv(split(v, kvh), groups, 1)
    if cfg.pos_type == "rope":
        pos = torch.arange(s, device=x.device)
        qh = _rope(qh, pos, cfg.rope_base)
        kh = _rope(kh, pos, cfg.rope_base)
    o = ring_attention_local(qh, kh, vh, causal=True,
                             sm_scale=1.0 / math.sqrt(hd), impl=attn_impl)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
    return o @ lp["wo"]


def _block_local(lp, x, cfg, attn_impl="auto"):
    """One pre-LN block: attention, then the FFN (the dense one, the JAX
    package's ``_dense_ffn_local``, or its ``_moe_ffn_local`` over the
    block's b * s tokens), each added to the residual. Returns (x, aux):
    the MoE load-balancing loss, None for the dense block."""
    x = x + _attention_local(lp, _ln(x, lp["ln1_g"], lp["ln1_b"]), cfg,
                             attn_impl)
    f, aux = _ffn(lp, _ln(x, lp["ln2_g"], lp["ln2_b"]), cfg)
    return x + f, aux


def _stage_local(params, x, cfg, attn_impl="auto"):
    """Every layer in order: the JAX package's ``_stage_local`` scan, as
    its ``_pipeline_stages_local`` runs it for pp = 1; returns (x, the
    layers' summed aux loss, None for a dense model). With ``cfg.remat`` each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    dropped after the forward and recomputed in the backward, as
    ``jax.checkpoint`` with ``nothing_saveable`` does. The layer stacks
    are split with one ``unbind`` each, whose backward stacks the
    layers' gradients in one op (indexing layer by layer would add a
    full-stack zero gradient per layer)."""
    stacks = {k: p.unbind(0) for k, p in params.layers.items()}
    aux = None
    for li in range(cfg.n_layers):
        lp = {k: t[li] for k, t in stacks.items()}
        if cfg.remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _block_local, lp, x, cfg, attn_impl, use_reentrant=False)
        else:
            x, a = _block_local(lp, x, cfg, attn_impl)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _lm_local_loss(params, tokens, targets, cfg, attn_impl="auto"):
    """Mean next-token negative log-likelihood of ``targets`` (b, s)
    given ``tokens`` (b, s), plus ``0.01 *`` the MoE layers' summed aux
    loss, as a float32 scalar: the JAX package's ``_lm_local_loss`` on
    one device (the dense model's aux loss is 0). ``attn_impl``: see
    :func:`_attention_local`."""
    s = tokens.shape[1]
    x = params.embed[tokens.long()]
    if cfg.pos_type == "learned":
        x = x + params.pos[:s]
    x, aux = _stage_local(params, x, cfg, attn_impl)
    x = _ln(x, params.lnf_g, params.lnf_b)
    logp = torch.log_softmax(x @ params.embed.T, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    loss = nll.sum().float() / float(nll.numel())
    return loss if aux is None else loss + 0.01 * aux


def make_transformer_train_step(cfg: TransformerConfig, mesh=None, lr=0.1,
                                num_microbatches=None, device_loop=False):
    """Build ``step(params, tokens, targets) -> (params, loss)``: forward,
    backward through the flash attention kernels, and SGD ``p - lr * g``
    on every weight, the JAX package's ``make_transformer_train_step``
    on a one-device mesh.

    ``params`` is a :class:`TransformerParams` built with
    ``trainable=True``; the step updates it in place (the analog of the
    JAX step's donated params) and returns it with the loss as a float32
    scalar tensor on its device, without waiting for the device.
    ``tokens``/``targets`` (batch, seq) integers are moved to the
    params' device.

    ``mesh``: None or a dict of the five axis sizes ``dp, sp, tp, pp,
    ep``; sizes above 1 raise :class:`NotImplementedError` naming the
    ROADMAP item. ``cfg.remat`` recomputes each block in the backward;
    MoE configs add ``0.01 *`` their aux loss.
    ``num_microbatches`` matters only for pp > 1. ``device_loop=True``
    returns ``loop(params, tokens, targets)`` over stacked (k, batch,
    seq) batches instead: k steps in one call, returning the last
    loss."""
    _validate(cfg)
    _check_mesh(mesh)
    del num_microbatches
    lr = float(lr)

    def step(params, tokens, targets):
        leaves = list(params.parameters())
        if not all(p.requires_grad for p in leaves):
            raise MXNetError("params take no gradients (serving weights); "
                             "build them with trainable=True")
        dev = leaves[0].device
        with torch.enable_grad():
            loss = _lm_local_loss(params, tokens.to(dev), targets.to(dev),
                                  cfg)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            torch._foreach_add_(leaves, grads, alpha=-lr)
        return params, loss.detach()

    if not device_loop:
        return step

    def loop(params, tokens, targets):
        """``k`` steps over stacked (k, batch, seq) batches; returns
        (params, last loss)."""
        if tokens.dim() != 3 or tuple(targets.shape) != tuple(tokens.shape):
            raise ValueError("device_loop takes stacked (k, batch, seq) "
                             "tokens and targets, got %s and %s"
                             % (tuple(tokens.shape), tuple(targets.shape)))
        loss = None
        for i in range(tokens.shape[0]):
            params, loss = step(params, tokens[i], targets[i])
        return params, loss

    return loop
