"""Attention kernels written by hand in CUDA for Hopper.

Counterpart of the JAX package's ``ops/pallas/flash_attention.py``:
``flash_attention`` (training: forward, and its backward as a kernel of
its own, ``flash_attention_bwd``), ``paged_decode_attention`` and
``flash_prefill_paged`` (decode serving). The same signatures and
layouts, each backed by a CUDA C++ kernel for Hopper (``csrc/*.cu``) and
beside it a plain PyTorch version of the same function, op for op the
JAX package's XLA twin.

Each kernel has two routes, picked before the launch from dtype,
shapes and alignment alone (:func:`decode_route`, :func:`prefill_route`,
:func:`flash_route`, memoised); a failed launch raises and nothing
retries on the other route. ``paged_decode_attention``: "cluster" splits
each (row, kv head) over a thread-block cluster of up to
:data:`DECODE_CLUSTER` CTAs, each owning a contiguous range of the row's
live pages (:func:`decode_split_pages`), combined in rank order over
distributed shared memory within the one launch; "serial" is the first
design (one CTA walking the pages), for head dims the cluster route does
not take. ``flash_prefill_paged``: "mma" runs bfloat16 on the tensor
cores (mma.sync), one CTA per (q tile, kv head) for every query head of
the group; "fma" is the first design, float32 FMAs on the CUDA cores,
for float32 (where tensor cores would mean TF32) and other shapes.
``flash_attention`` and ``flash_attention_bwd``: "wgmma" (TMA and wgmma,
bfloat16, q, k and v of one length, head_dim 32 or 64) or "fma" (float32
FMAs on the CUDA cores over tiles in shared memory) for every other call
the TPU kernel takes: float32, k and v longer or shorter than q, and
head dims up to :data:`MAX_HEAD_DIM`.

A wrapper launches its kernel for CUDA tensors, on
``torch.cuda.current_stream()``, and raises when the launch returns a
CUDA error. It takes the plain version only because the tensors it was
given lie on the CPU; nothing falls back to it. Every kernel launch adds
one to :data:`LAUNCHES` and, for the serving kernels, to its route's
count in :data:`ROUTES` (plain calls do not).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ...base import MXNetError
from . import _build

__all__ = ["flash_attention", "flash_attention_bwd", "paged_decode_attention",
           "flash_prefill_paged", "CUDA_KERNELS", "LAUNCHES", "ROUTES",
           "reset_launches", "decode_route", "decode_split_pages",
           "live_pages", "prefill_route", "flash_route", "NEG_INF",
           "WGMMA_HEAD_DIMS", "MAX_HEAD_DIM",
           "DECODE_CLUSTER", "PREFILL_HEAD_DIMS", "PREFILL_MAX_GROUP"]

# kernel-contract registry: every CUDA kernel maps to its plain PyTorch
# version in this module (tests/test_torch_contract.py checks each has
# a csrc/<kernel>.cu source and a CPU test naming both)
CUDA_KERNELS = {
    "paged_decode_attention": "_paged_decode_torch",
    "flash_prefill_paged": "_flash_prefill_torch",
    "flash_attention": "_flash_fwd_torch",
    "flash_attention_bwd": "_flash_bwd_torch",
}

# kernel launches since the last reset_launches(), by kernel name, and
# by route
LAUNCHES = {name: 0 for name in CUDA_KERNELS}
ROUTES = {"paged_decode_attention": {"cluster": 0, "serial": 0},
          "flash_prefill_paged": {"mma": 0, "fma": 0},
          "flash_attention": {"wgmma": 0, "fma": 0},
          "flash_attention_bwd": {"wgmma": 0, "fma": 0}}

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

# flash_attention / flash_attention_bwd on CUDA tensors: the head dims of
# the "wgmma" route, and the largest head_dim of any route (ROADMAP B.5
# queues the rest)
WGMMA_HEAD_DIMS = (32, 64)
MAX_HEAD_DIM = 256

# the decode "cluster" route: the most CTAs a (row, kv head) is split over
# (the portable thread-block cluster size)
DECODE_CLUSTER = 8
# the prefill "mma" route: its head dims and largest group (8 warps of a
# CTA hold 8 positions x 16 query heads)
PREFILL_HEAD_DIMS = (32, 64, 128)
PREFILL_MAX_GROUP = 16

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the serving kernels' libraries: every entry point, by route and dtype
_DECODE_ARGS = [_P] * 6 + [_I] * 7 + [_F, _P]
_PREFILL_ARGS = [_P] * 7 + [_I] * 8 + [_F, _P]
_ROUTE_SYMBOLS = {
    # q, k_pages, v_pages, block_tables, lengths, out, b, kvh, group, hd,
    # num_pages, page_size, pages_per_seq[, splits], sm_scale, stream
    "paged_decode_attention": {
        ("serial", "f32"): ("paged_decode_attention_f32", _DECODE_ARGS),
        ("serial", "bf16"): ("paged_decode_attention_bf16", _DECODE_ARGS),
        ("cluster", "f32"): ("paged_decode_split_f32",
                             [_P] * 6 + [_I] * 8 + [_F, _P]),
        ("cluster", "bf16"): ("paged_decode_split_bf16",
                              [_P] * 6 + [_I] * 8 + [_F, _P])},
    # q, kg, vg, k_pages, v_pages, block_tables, out, b, s, nh, kvh, hd,
    # num_pages, page_size, bt_stride, sm_scale, stream
    "flash_prefill_paged": {
        ("fma", "f32"): ("flash_prefill_paged_f32", _PREFILL_ARGS),
        ("fma", "bf16"): ("flash_prefill_paged_bf16", _PREFILL_ARGS),
        ("mma", "bf16"): ("flash_prefill_mma_bf16", _PREFILL_ARGS)},
}
# the flash kernels' "wgmma" entries (<name>_bf16)
_SYMBOLS = {
    # q, k, v, o, lse, b*h, s, hd, causal, sm_scale, stream
    "flash_attention": [_P] * 5 + [_I] * 4 + [_F, _P],
    # q, k, v, o, lse, do, dq, dk, dv, delta, b*h, s, hd, causal,
    # sm_scale, stream
    "flash_attention_bwd": [_P] * 10 + [_I] * 4 + [_F, _P],
}
# and their "fma" entries (<name>_fma_f32, <name>_fma_bf16): s_q and s_k
# in place of s
_FMA_SYMBOLS = {name: args[:-4] + [_I] + args[-4:]
                for name, args in _SYMBOLS.items()}


def reset_launches():
    """Set every kernel's launch count and route count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in ROUTES.values():
        for route in counts:
            counts[route] = 0


def _kernel_fn(name, route, dtype):
    """The C entry point of flash kernel ``name`` on ``route`` for
    ``dtype`` (the library built and loaded on first use)."""
    symbols = {"%s_bf16" % name: _SYMBOLS[name]}
    symbols.update({"%s_fma_%s" % (name, tag): _FMA_SYMBOLS[name]
                    for tag in _KERNEL_DTYPES.values()})
    lib = _build.load(name, symbols)
    if route == "wgmma":
        return getattr(lib, "%s_bf16" % name)
    return getattr(lib, "%s_fma_%s" % (name, _KERNEL_DTYPES[dtype]))


_route_fns = {}   # (kernel, route, dtype) -> ctypes function


def _route_fn(name, route, dtype):
    """The C entry point of ``name``'s ``route`` for ``dtype`` (the
    library built and loaded on first use)."""
    key = (name, route, dtype)
    fn = _route_fns.get(key)
    if fn is None:
        lib = _build.load(name, dict(_ROUTE_SYMBOLS[name].values()))
        fn = _route_fns[key] = getattr(
            lib, _ROUTE_SYMBOLS[name][(route, _KERNEL_DTYPES[dtype])][0])
    return fn


def _launch(name, dev, fn, args, route=None):
    """``fn(*args, stream)`` with ``dev``'s current stream, read at call
    time (inside autograd's backward, the stream the engine runs the
    node on) and ``dev`` the current device (the library's runtime
    launches there); count the launch, and on ``route`` if given, or
    raise."""
    with _build.on_device(dev):
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise MXNetError("%s: CUDA kernel launch failed%s (cudaError_t %d)"
                         % (name, "" if route is None
                            else " on the %s route" % route, err))
    LAUNCHES[name] += 1
    if route is not None:
        ROUTES[name][route] += 1


def _check(cond, fmt, *args):
    if not cond:
        raise MXNetError(fmt % args)


def _check_tensors(fn, float_args, int_args):
    """Shared argument checks: one device, contiguous, float inputs of
    one kernel dtype (float32 or bfloat16), int32 index tensors."""
    for name, t in float_args + int_args:
        _check(isinstance(t, torch.Tensor), "%s: %s must be a tensor",
               fn, name)
    dev = float_args[0][1].device
    dtype = float_args[0][1].dtype
    for name, t in float_args + int_args:
        _check(t.device == dev, "%s: %s is on %s, expected %s", fn, name,
               t.device, dev)
        _check(t.is_contiguous(), "%s: %s must be contiguous", fn, name)
    _check(dtype in _KERNEL_DTYPES, "%s: dtype %s unsupported (float32 "
           "or bfloat16)", fn, dtype)
    for name, t in float_args:
        _check(t.dtype == dtype, "%s: %s has dtype %s, expected %s", fn,
               name, t.dtype, dtype)
    for name, t in int_args:
        _check(t.dtype == torch.int32, "%s: %s must be int32, got %s", fn,
               name, t.dtype)
    _check(dev.type in ("cpu", "cuda"), "%s: unsupported device %s", fn,
           dev)
    return dev


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _paged_decode_torch(q, k_pages, v_pages, block_tables, lengths,
                        sm_scale):
    """Plain version of :func:`paged_decode_attention`, op for op the
    JAX package's ``_paged_decode_xla``: block-table gather of each
    row's (L, kv_heads, hd) view, then masked GQA softmax in float32."""
    b, kvh, g, hd = q.shape
    bt = block_tables.long()
    kc = k_pages[bt]                     # (b, pages, page_size, kvh, hd)
    vc = v_pages[bt]
    L = kc.shape[1] * kc.shape[2]
    kc = kc.reshape(b, L, kvh, hd).transpose(1, 2)
    vc = vc.reshape(b, L, kvh, hd).transpose(1, 2)
    visible = (torch.arange(L, device=q.device)[None, :]
               < lengths[:, None])                                # (b, L)
    sc = torch.einsum("bkgd,bkld->bkgl", q.float(), kc.float()) * sm_scale
    sc = torch.where(visible[:, None, None, :], sc, NEG_INF)
    o = torch.einsum("bkgl,bkld->bkgd", torch.softmax(sc, -1), vc.float())
    return o.to(q.dtype)


def live_pages(length, page_size, pages_per_seq):
    """Pages a row of ``length`` keys reaches: ceil(length / page_size),
    at most ``pages_per_seq`` (none for a length <= 0)."""
    return min(-(-max(int(length), 0) // page_size), pages_per_seq)


def decode_split_pages(n_live, splits):
    """``[(p0, p1), ...]``: the contiguous live pages ``[p0, p1)`` that
    cluster rank ``r`` of the "cluster" route owns out of a row's
    ``n_live``, ``r * n_live // splits`` to ``(r + 1) * n_live //
    splits`` (the kernel's own rule); a rank may own none."""
    return [(r * n_live // splits, (r + 1) * n_live // splits)
            for r in range(splits)]


@functools.lru_cache(maxsize=1024)
def decode_route(dtype, head_dim, pages_per_seq, aligned=True):
    """``("cluster", splits)`` or ``("serial", None)`` for a decode call
    in ``dtype`` (float32 or bfloat16). The cluster route takes a
    head_dim of at most 256 whose rows are whole 16-byte segments (a
    multiple of 8 in bfloat16, of 4 in float32) and 16-byte aligned
    tensors (``aligned``), and splits each (row, kv head) over
    ``min(DECODE_CLUSTER, pages_per_seq)`` CTAs of one cluster."""
    vec = 8 if dtype == torch.bfloat16 else 4
    if (aligned and 0 < head_dim <= 256 and head_dim % vec == 0
            and pages_per_seq >= 1):
        return ("cluster", min(DECODE_CLUSTER, pages_per_seq))
    return ("serial", None)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                           sm_scale=None):
    """Decode-phase attention against a paged KV cache: one query token
    per row, keys/values read page by page through a block table.

    Parameters
    ----------
    q : (b, kv_heads, group, head_dim) — query heads grouped per shared
        K/V head (``group = n_heads // kv_heads``).
    k_pages, v_pages : (num_pages, page_size, kv_heads, head_dim) — one
        layer's slice of the page pool.
    block_tables : (b, pages_per_seq) int32 — page ids per row, in
        position order.
    lengths : (b,) int32 — row ``r`` attends positions ``< lengths[r]``.

    Returns (b, kv_heads, group, head_dim) in ``q``'s dtype. All inputs
    on one device and contiguous; float32 or bfloat16. A row of length 0
    gives zeros on the card (the TPU kernel's result); the plain version,
    like the JAX package's XLA twin, averages V over the row's pages."""
    fn = "paged_decode_attention"
    dev = _check_tensors(fn, [("q", q), ("k_pages", k_pages),
                              ("v_pages", v_pages)],
                         [("block_tables", block_tables),
                          ("lengths", lengths)])
    _check(q.dim() == 4, "%s: q must be (b, kv_heads, group, head_dim), "
           "got %s", fn, tuple(q.shape))
    b, kvh, g, hd = q.shape
    _check(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
           "%s: k_pages/v_pages must be one (num_pages, page_size, "
           "kv_heads, head_dim) shape, got %s and %s", fn,
           tuple(k_pages.shape), tuple(v_pages.shape))
    num_pages, page_size = k_pages.shape[:2]
    _check(tuple(k_pages.shape[2:]) == (kvh, hd), "%s: pages hold "
           "(kv_heads, head_dim) %s, q has %s", fn,
           tuple(k_pages.shape[2:]), (kvh, hd))
    _check(block_tables.dim() == 2 and block_tables.shape[0] == b,
           "%s: block_tables must be (b=%d, pages_per_seq), got %s", fn,
           b, tuple(block_tables.shape))
    _check(tuple(lengths.shape) == (b,), "%s: lengths must be (%d,), got "
           "%s", fn, b, tuple(lengths.shape))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if dev.type == "cpu":
        return _paged_decode_torch(q, k_pages, v_pages, block_tables,
                                   lengths, float(sm_scale))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    pps = block_tables.shape[1]
    qp, kp, vp = q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()
    route, splits = decode_route(q.dtype, hd, pps,
                                 (qp | kp | vp) % 16 == 0)
    head = (qp, kp, vp, block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, kvh, g, hd, num_pages, page_size, pps)
    _launch(fn, dev, _route_fn(fn, route, q.dtype),
            head + ((float(sm_scale),) if splits is None
                    else (splits, float(sm_scale))), route)
    return out


# ---------------------------------------------------------------------------
# paged flash prefill (causal attention + the prompt's page write)
# ---------------------------------------------------------------------------

def _flash_prefill_torch(q, kg, vg, k_pages, v_pages, block_tables):
    """Plain version of :func:`flash_prefill_paged`, op for op the JAX
    package's ``_flash_prefill_xla`` (expanded-KV einsum / sqrt(hd),
    tril mask, softmax, reshape-scatter of the pages), except that the
    page write updates ``k_pages``/``v_pages`` in place."""
    b, s, nh, hd = q.shape
    kvh = kg.shape[2]
    groups = nh // kvh
    ps = k_pages.shape[1]
    n_pb = s // ps
    k = kg if groups == 1 else torch.repeat_interleave(kg, groups, dim=2)
    v = vg if groups == 1 else torch.repeat_interleave(vg, groups, dim=2)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    sc = torch.where(mask[None, None], sc, NEG_INF)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)
    bt = block_tables[:, :n_pb].long()
    # repeated page ids (the null page of warmup rows) neither raise nor
    # promise which row's write survives
    k_pages[bt] = kg.reshape(b, n_pb, ps, kvh, hd).to(k_pages.dtype)
    v_pages[bt] = vg.reshape(b, n_pb, ps, kvh, hd).to(v_pages.dtype)
    return o, k_pages, v_pages


@functools.lru_cache(maxsize=1024)
def prefill_route(dtype, head_dim, n_heads, kv_heads, aligned=True):
    """``"mma"`` (bfloat16 on the tensor cores) or ``"fma"`` (float32
    FMAs on the CUDA cores) for a prefill call. The mma route takes
    bfloat16, a head_dim in :data:`PREFILL_HEAD_DIMS`, a group
    ``n_heads // kv_heads`` of at most :data:`PREFILL_MAX_GROUP` and
    16-byte aligned tensors (``aligned``); float32 stays on fma, where
    tensor cores would mean TF32 and other numbers."""
    if (dtype == torch.bfloat16 and aligned
            and head_dim in PREFILL_HEAD_DIMS
            and n_heads // kv_heads <= PREFILL_MAX_GROUP):
        return "mma"
    return "fma"


def flash_prefill_paged(q, kg, vg, k_pages, v_pages, block_tables):
    """Prefill-phase causal attention over a paged KV pool that also
    writes the prompt's K/V into the pool's pages, in place.

    Parameters
    ----------
    q : (b, s, n_heads, head_dim) — prompt queries (RoPE-rotated).
    kg, vg : (b, s, kv_heads, head_dim) — compact GQA K/V; the kernel
        never builds the ``n_heads``-expanded copies.
    k_pages, v_pages : (num_pages, page_size, kv_heads, head_dim) — one
        layer's slice of the pool; updated in place and returned.
    block_tables : (b, pages_per_row) int32 — destination page ids in
        position order; only the first ``s // page_size`` are used.

    Returns ``(o, k_pages, v_pages)`` with ``o`` (b, s, n_heads,
    head_dim). Score scale 1/sqrt(head_dim), causal. Rows whose block
    table repeats a page (the reserved null page 0 in warmup batches)
    leave that page's contents unspecified."""
    fn = "flash_prefill_paged"
    dev = _check_tensors(fn, [("q", q), ("kg", kg), ("vg", vg),
                              ("k_pages", k_pages), ("v_pages", v_pages)],
                         [("block_tables", block_tables)])
    _check(q.dim() == 4, "%s: q must be (b, s, n_heads, head_dim), got %s",
           fn, tuple(q.shape))
    b, s, nh, hd = q.shape
    _check(kg.dim() == 4 and kg.shape == vg.shape
           and tuple(kg.shape[:2]) == (b, s) and kg.shape[3] == hd,
           "%s: kg/vg must be (b=%d, s=%d, kv_heads, head_dim=%d), got "
           "%s and %s", fn, b, s, hd, tuple(kg.shape), tuple(vg.shape))
    kvh = kg.shape[2]
    _check(kvh >= 1 and nh % kvh == 0, "%s: n_heads=%d must divide by "
           "kv_heads=%d", fn, nh, kvh)
    _check(k_pages.dim() == 4 and k_pages.shape == v_pages.shape
           and tuple(k_pages.shape[2:]) == (kvh, hd),
           "%s: k_pages/v_pages must be (num_pages, page_size, %d, %d), "
           "got %s and %s", fn, kvh, hd, tuple(k_pages.shape),
           tuple(v_pages.shape))
    num_pages, ps = k_pages.shape[:2]
    if s % ps:
        raise ValueError("prefill bucket %d is not a multiple of "
                         "page_size %d" % (s, ps))
    _check(block_tables.dim() == 2 and block_tables.shape[0] == b,
           "%s: block_tables must be (b=%d, pages_per_row), got %s", fn, b,
           tuple(block_tables.shape))
    if s // ps > block_tables.shape[1]:
        raise ValueError("prefill bucket %d needs %d pages/row; "
                         "block table holds %d"
                         % (s, s // ps, block_tables.shape[1]))
    if dev.type == "cpu":
        return _flash_prefill_torch(q, kg, vg, k_pages, v_pages,
                                    block_tables)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out, k_pages, v_pages
    ptrs = (q.data_ptr(), kg.data_ptr(), vg.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr())
    route = prefill_route(q.dtype, hd, nh, kvh,
                          (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4])
                          % 16 == 0)
    _launch(fn, dev, _route_fn(fn, route, q.dtype), ptrs + (
        block_tables.data_ptr(), out.data_ptr(), b, s, nh, kvh, hd,
        num_pages, ps, block_tables.shape[1], 1.0 / math.sqrt(hd)), route)
    return out, k_pages, v_pages


# ---------------------------------------------------------------------------
# flash attention (training): forward with lse, backward from lse
# ---------------------------------------------------------------------------

def _flash_fwd_torch(q, k, v, causal, sm_scale):
    """Plain version of :func:`_flash_fwd`, op for op the JAX package's
    ``_flash_fwd_xla``: float32 scores scaled after the product, causal
    mask -1e30, softmax with ``l == 0`` guarded, ``lse = m + log(l)``.
    Returns ``(o in q's dtype, lse float32 (b, h, s))``."""
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        s_q, s_k = q.shape[2], k.shape[2]
        mask = (torch.arange(s_k, device=q.device)[None, :]
                <= torch.arange(s_q, device=q.device)[:, None])
        sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l_safe, v.float())
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def _flash_bwd_torch(q, k, v, o, lse, do, causal, sm_scale):
    """Plain version of :func:`flash_attention_bwd`, op for op the JAX
    package's ``_flash_bwd`` with one key block: ``delta`` from the
    stored ``o`` in float32, ``p = exp(s - lse)`` zeroed where masked,
    dk from the scaled q, dq scaled at the end. Returns ``(dq, dk, dv)``
    in the inputs' dtypes."""
    g = do.float()
    qf = q.float() * sm_scale
    kf = k.float()
    vf = v.float()
    delta = (o.float() * g).sum(-1)                               # (b,h,sq)
    sc = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    mask = None
    if causal:
        s_q, s_k = q.shape[2], k.shape[2]
        mask = (torch.arange(s_k, device=q.device)[None, :]
                <= torch.arange(s_q, device=q.device)[:, None])
        sc = torch.where(mask, sc, NEG_INF)
    p = torch.exp(sc - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, vf)
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)                 # scaled q
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_attention(fn, qs, kvs, lse=None):
    """Checks shared by the flash_attention entries: ``qs`` (q, and o and
    do) one (b, h, s_q, head_dim) shape, ``kvs`` (k, v) one (b, h, s_k,
    head_dim) shape, one dtype, contiguous, on one device; ``lse``
    float32 (b, h, s_q). On a CUDA device also a head_dim of at most
    :data:`MAX_HEAD_DIM`. Returns (device, (b, h, s_q, s_k, head_dim))."""
    dev = _check_tensors(fn, qs + kvs, [])
    shape = tuple(qs[0][1].shape)
    _check(len(shape) == 4, "%s: q must be (b, heads, seq, head_dim), got "
           "%s", fn, shape)
    for name, t in qs[1:]:
        _check(tuple(t.shape) == shape, "%s: %s has shape %s, expected %s "
               "(q's)", fn, name, tuple(t.shape), shape)
    kshape = tuple(kvs[0][1].shape)
    _check(len(kshape) == 4 and kshape[:2] == shape[:2]
           and kshape[3] == shape[3], "%s: k must be (b=%d, heads=%d, "
           "s_k, head_dim=%d), got %s", fn, shape[0], shape[1], shape[3],
           kshape)
    for name, t in kvs[1:]:
        _check(tuple(t.shape) == kshape, "%s: %s has shape %s, expected %s "
               "(k's)", fn, name, tuple(t.shape), kshape)
    if lse is not None:
        _check(isinstance(lse, torch.Tensor) and lse.device == dev
               and lse.dtype == torch.float32 and lse.is_contiguous()
               and tuple(lse.shape) == shape[:3],
               "%s: lse must be a contiguous float32 %s tensor on %s", fn,
               shape[:3], dev)
    if dev.type == "cuda":
        _check(shape[3] <= MAX_HEAD_DIM, "%s: head_dim %d has no kernel "
               "(at most %d on the card; larger head dims are ROADMAP "
               "B.5)", fn, shape[3], MAX_HEAD_DIM)
        # b * heads is the "fma" grid's y dimension; the wgmma kernels'
        # TMA coordinates into the (b * heads * s) lse are 32-bit
        _check(shape[0] * shape[1] <= 65535, "%s: b * heads = %d exceeds "
               "65535", fn, shape[0] * shape[1])
        _check(shape[0] * shape[1] * max(shape[2], kshape[2]) < 2 ** 31,
               "%s: b * heads * seq = %d exceeds 2^31 - 1", fn,
               shape[0] * shape[1] * max(shape[2], kshape[2]))
    return dev, shape[:3] + (kshape[2], shape[3])


@functools.lru_cache(maxsize=1024)
def flash_route(dtype, head_dim, s_q, s_k, aligned=True):
    """``"wgmma"`` or ``"fma"`` for a flash_attention call (forward and
    backward alike). The wgmma route (TMA rings, bf16 tensor cores)
    takes bfloat16 with q, k and v of one length, a head_dim in
    :data:`WGMMA_HEAD_DIMS` and 16-byte aligned storage (``aligned``);
    every other call, float32 among them, takes the fma route."""
    if (dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS
            and s_q == s_k and aligned):
        return "wgmma"
    return "fma"


def _attention_route(dtype, shape, tensors):
    b, h, s_q, s_k, hd = shape
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return flash_route(dtype, hd, s_q, s_k, aligned)


def _flash_fwd(q, k, v, causal=False, sm_scale=None):
    """Attention forward that also returns the row log-sum-exp: ``(o,
    lse)`` with ``o`` (b, h, s_q, head_dim) in q's dtype and ``lse`` (b,
    h, s_q) float32, the pair ring attention merges by; k and v are (b,
    h, s_k, head_dim). Launches the ``flash_attention`` kernel for CUDA
    tensors on :func:`flash_route`'s route; CPU tensors take
    :func:`_flash_fwd_torch`.

    Rounding: on the wgmma route (bfloat16) the kernel multiplies the
    float32 product q k^T by ``sm_scale`` (the order of the JAX package's
    XLA twin) where the Pallas kernel and the fma route scale q in
    float32 before the dot. The two agree exactly for a power-of-two
    scale (head_dim 64) and within about one float32 ulp of the score
    otherwise (head_dim 32)."""
    fn = "flash_attention"
    dev, shape = _check_attention(fn, [("q", q)], [("k", k), ("v", v)])
    b, h, s_q, s_k, hd = shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if dev.type == "cpu":
        return _flash_fwd_torch(q, k, v, bool(causal), float(sm_scale))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=dev)
    if o.numel() == 0:
        return o, lse
    route = _attention_route(q.dtype, shape, (q, k, v))
    lens = (s_q,) if route == "wgmma" else (s_q, s_k)
    _launch(fn, dev, _kernel_fn(fn, route, q.dtype), (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b * h) + lens + (hd, int(bool(causal)),
                                         float(sm_scale)), route)
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, sm_scale=None):
    """Gradients ``(dq, dk, dv)`` of attention from the forward's ``o``
    and ``lse`` and the output gradient ``do`` (FlashAttention-2
    recompute, the JAX package's ``_flash_bwd``); dk and dv have k's
    shape (b, h, s_k, head_dim). One launch of the
    ``flash_attention_bwd`` kernel entry for CUDA tensors on
    :func:`flash_route`'s route (wgmma: a dq pass that also computes
    delta, then a dk/dv pass; fma: a delta pre-pass, then the two),
    deterministic: no atomics, every sum in a fixed order. CPU tensors
    take :func:`_flash_bwd_torch`."""
    fn = "flash_attention_bwd"
    dev, shape = _check_attention(
        fn, [("q", q), ("o", o), ("do", do)], [("k", k), ("v", v)],
        lse=lse)
    b, h, s_q, s_k, hd = shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if dev.type == "cpu":
        return _flash_bwd_torch(q, k, v, o, lse, do, bool(causal),
                                float(sm_scale))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b * h * s_q,), dtype=torch.float32, device=dev)
    route = _attention_route(q.dtype, shape, (q, k, v, o, do))
    lens = (s_q,) if route == "wgmma" else (s_q, s_k)
    _launch(fn, dev, _kernel_fn(fn, route, q.dtype), (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), b * h) + lens + (
            hd, int(bool(causal)), float(sm_scale)), route)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``o = flash_attention(q, k, v)`` with the kernel backward; saves
    q, k, v, o and lse, as the JAX package's custom_vjp does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = _flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Memory-efficient attention ``softmax(q k^T * sm_scale [+ causal
    mask]) v``, differentiable.

    Parameters
    ----------
    q : (batch, heads, s_q, head_dim); k, v : (batch, heads, s_k,
        head_dim), s_k equal to s_q or not, as the TPU kernel takes them;
        contiguous, on one device, float32 or bfloat16 (head_dim at most
        :data:`MAX_HEAD_DIM` on CUDA).
    causal : key position ``kpos`` is visible to query position ``qpos``
        when ``kpos <= qpos``, both counted from 0.
    sm_scale : score scale; default ``1/sqrt(head_dim)``.

    Forward and backward are the ``flash_attention`` and
    ``flash_attention_bwd`` kernels on CUDA tensors, their plain
    versions on CPU tensors."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))
