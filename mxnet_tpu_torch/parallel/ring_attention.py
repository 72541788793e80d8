"""Ring attention, for a ring of one member.

Counterpart of the JAX package's ``parallel/ring_attention.py``
``_ring_attention_local``: the per-shard body that attends the local
queries against K/V chunks rotating around the ``sp`` mesh axis and
merges the chunks' outputs by log-sum-exp. This package runs it on one
device only: with one member there is one chunk, the diagonal one, so
the result is the attention of the local block. A ring of more members
needs the K/V rotation over ``torch.distributed`` (ROADMAP A13/A15) and
raises :class:`NotImplementedError`.

``impl="flash"`` (and ``"auto"``) is the flash kernel's ``(o, lse)``
with the LSE merge against the empty accumulator (lse -1e30, weight
exp(-1e30 - lse) = 0), which is the identity on ``o``;
:func:`~..ops.cuda.flash_attention.flash_attention` computes exactly that
and carries the kernel backward. ``impl="einsum"`` is the plain tensor
path, op for op the JAX package's ``_ring_einsum_local``.
"""
from __future__ import annotations

import torch

from ..ops.cuda.flash_attention import NEG_INF, flash_attention

__all__ = ["ring_attention_local"]


def _chunk_attention(q, k, v, q_off, k_off, causal, scale):
    """One q block x one K/V chunk: ``(pv, m, l)`` in float32, the JAX
    package's ``_chunk_attention``. q (b, h, sq, d) float32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.float()) * scale
    if causal:
        qpos = q_off + torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = k_off + torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    m_safe = torch.clamp(m, min=NEG_INF / 2)       # all-masked rows
    p = torch.exp(s - m_safe)
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    l = p.sum(-1, keepdim=True)
    pv = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return pv, m_safe, l


def _ring_einsum_local(q, k, v, causal, sm_scale):
    """Plain per-shard body for a ring of one: the single chunk merged
    into the (m=-1e30, l=0, acc=0) start, as ``_ring_einsum_local``."""
    b, h, s, d = q.shape
    pv, m_c, l_c = _chunk_attention(q.float(), k, v, 0, 0, causal, sm_scale)
    m = torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    m_new = torch.maximum(m, m_c)
    a_cur = torch.exp(m_c - m_new)
    acc = pv * a_cur              # + zeros * exp(m - m_new)
    l = l_c * a_cur
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).to(q.dtype)


def ring_attention_local(q, k, v, causal, sm_scale, impl="auto",
                         ring_size=1):
    """Per-shard ring attention: q, k, v (b, h, s_local, head_dim) ->
    (b, h, s_local, head_dim). ``ring_size`` is the ``sp`` axis size;
    only 1 is supported. ``impl``: "flash" (the kernel), "einsum" (plain
    tensors) or "auto" (flash). k and v must already be expanded to the
    query head count."""
    if ring_size != 1:
        raise NotImplementedError(
            "ring attention over %d members (sp > 1) needs the K/V ring "
            "over torch.distributed: not ported yet (ROADMAP A13/A15)"
            % ring_size)
    if impl == "auto":
        impl = "flash"
    if impl == "flash":
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal,
                               sm_scale=sm_scale)
    if impl == "einsum":
        return _ring_einsum_local(q, k, v, causal, sm_scale)
    raise ValueError("impl must be 'auto', 'flash' or 'einsum', got %r"
                     % (impl,))
