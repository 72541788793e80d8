"""Mixture-of-Experts layers: top-k routing with per-expert capacity.

Counterpart of the JAX package's ``parallel/moe.py`` on one device (an
``ep`` axis of size 1; larger ones are ROADMAP A15). The routing rule
is the JAX package's GShard/Switch recipe, step for step:

* softmax gates over the experts, first choice by ``argmax`` (the first
  index on ties, in both frameworks), second choice by ``argmax`` of the
  gates with the first one zeroed;
* each expert's queue fills in token order: a token's slot is the count
  of earlier tokens with the same choice, and the second choices queue
  after all first choices; a slot at or past ``capacity`` drops the
  token from that expert;
* the two gates are renormalised, ``g / max(g1 + g2, 1e-9)``; top-1
  when ``k == 1``, top-2 for every ``k >= 2``;
* the load-balancing loss ``E * sum(density * density_proxy)``.

:func:`top_k_gating` returns the JAX package's dense ``(dispatch,
combine, aux)`` tensors, ``(tokens, experts, capacity)`` each, for
tests. The layers never build them (at full width, 8192 tokens, 8
experts and capacity 4096, each is 268M elements a layer): they route
by index (:func:`top_k_route`), gather each kept (token, choice) into
its (expert, slot) of an ``(E, C, d)`` buffer with zeros in empty
slots, run the experts as batched matmuls and combine with the gathered
weights. Each (expert, slot) holds one token or none, so that equals the
JAX package's one-hot einsums. The expert GEMMs are ``torch.bmm``: the
JAX package leaves them to XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["top_k_gating", "top_k_route", "moe_apply",
           "stack_expert_params", "expert_capacity", "moe_ffn"]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_expert_params(params_list):
    """Stack per-expert parameter trees (dicts, lists or tensors) on a
    leading ``num_experts`` axis."""
    return _tree_map(lambda *xs: torch.stack(xs, dim=0), *params_list)


def expert_capacity(n_tokens, num_experts, k, capacity_factor):
    """Slots an expert holds: ``max(1, int(capacity_factor * n_tokens *
    min(k, 2) / num_experts))``, as the JAX package sizes them."""
    return max(1, int(capacity_factor * n_tokens * min(k, 2)
                      / num_experts))


def _token_cumsum(mask):
    """``mask.cumsum(0)`` of a (tokens, experts) one-hot mask, scanned
    along the contiguous dimension: CUDA's scan over the outer dimension
    of a narrow (8192, 8) tensor took 30 of an MoE train step's 99
    device ms (H100). Counts are exact in float32 either way."""
    return mask.t().contiguous().cumsum(1).t()


def top_k_route(gate_logits, num_experts, capacity, k=2):
    """Top-1 or top-2 routing by index.

    ``gate_logits``: (tokens, num_experts). Returns ``(experts, slots,
    weights, kept, aux_loss)``: ``experts`` and ``slots`` (tokens,
    choices) int64, ``weights`` (tokens, choices) float32 (the first
    gate for top-1, the renormalised pair for top-2), ``kept`` (tokens,
    choices) bool (the slot is below ``capacity``), and the float32
    load-balancing loss. ``choices`` is 1 for ``k == 1``, else 2."""
    gates = torch.softmax(gate_logits, dim=-1)
    idx1 = gates.argmax(dim=-1)
    mask1 = F.one_hot(idx1, num_experts).float()
    g1 = (gates * mask1).sum(-1)
    density = mask1.mean(0)
    density_proxy = gates.mean(0)
    aux = num_experts * (density * density_proxy).sum()
    # a token's place in its expert's queue: earlier tokens with the
    # same first choice
    pos1 = ((_token_cumsum(mask1) * mask1 - mask1).sum(-1)).long()
    if k < 2:
        return (idx1[:, None], pos1[:, None], g1[:, None],
                (pos1 < capacity)[:, None], aux)
    idx2 = (gates * (1.0 - mask1)).argmax(dim=-1)
    mask2 = F.one_hot(idx2, num_experts).float()
    g2 = (gates * mask2).sum(-1)
    # second choices queue after every first choice of the expert
    pos2 = (((_token_cumsum(mask2) - mask2 + mask1.sum(0, keepdim=True))
             * mask2).sum(-1)).long()
    denom = torch.clamp(g1 + g2, min=1e-9)
    slots = torch.stack([pos1, pos2], dim=1)
    return (torch.stack([idx1, idx2], dim=1), slots,
            torch.stack([g1 / denom, g2 / denom], dim=1), slots < capacity,
            aux)


def top_k_gating(gate_logits, num_experts, capacity, k=2):
    """Dense dispatch/combine tensors for top-k routing, the JAX
    package's ``top_k_gating``.

    gate_logits : (tokens, num_experts).
    Returns (dispatch (n, E, C) in {0, 1}, combine (n, E, C) float32,
    aux_loss)."""
    experts, slots, weights, kept, aux = top_k_route(
        gate_logits, num_experts, capacity, k)
    # one_hot of a slot at or past capacity is all zeros, as jnp's
    choice = (F.one_hot(experts, num_experts).float()[..., None]
              * (slots[..., None] == torch.arange(
                  capacity, device=slots.device)).float()[..., None, :]
              * kept[..., None, None].float())          # (n, choices, E, C)
    dispatch = choice.sum(1)
    combine = (weights[..., None, None] * choice).sum(1)
    return dispatch, combine, aux


def _flat_slots(experts, slots, capacity):
    return experts * capacity + slots.clamp(max=capacity - 1)


def _dispatch(tok, experts, slots, kept, num_experts, capacity):
    """(num_experts, capacity, d): each kept (token, choice) at its
    (expert, slot), zeros in empty slots. Dropped choices go to a spare
    row past the last slot, which is cut off, so no boolean mask (and no
    device-to-host sync) is needed."""
    n, d = tok.shape
    spare = num_experts * capacity
    idx = torch.where(kept, experts * capacity + slots,
                      torch.full_like(slots, spare))
    src = tok[:, None, :].expand(n, experts.shape[1], d).reshape(-1, d)
    buf = tok.new_zeros((spare + 1, d)).index_copy(0, idx.flatten(), src)
    return buf[:spare].reshape(num_experts, capacity, d)


def _combine(out, experts, slots, kept, weights):
    """(tokens, d_out): each token's choices' expert outputs, weighted,
    summed in choice order; dropped choices add nothing."""
    num_experts, capacity, d_out = out.shape
    got = out.reshape(num_experts * capacity, d_out)[
        _flat_slots(experts, slots, capacity)]            # (n, choices, d)
    w = torch.where(kept, weights, torch.zeros_like(weights)).to(out.dtype)
    y = got[:, 0] * w[:, :1]
    for c in range(1, got.shape[1]):
        y = y + got[:, c] * w[:, c:c + 1]
    return y


def _route_dispatch(tok, gate_w, k, capacity_factor):
    """Route ``tok`` (tokens, d) by ``tok @ gate_w``, with the capacity
    computed over all its tokens, and gather it into the experts'
    (E, C, d) buffers. Returns (buffers, route, aux_loss); ``route`` is
    what :func:`_combine` takes after the expert outputs."""
    num_experts = gate_w.shape[-1]
    cap = expert_capacity(tok.shape[0], num_experts, k, capacity_factor)
    experts, slots, weights, kept, aux = top_k_route(
        tok @ gate_w, num_experts, cap, k)
    return (_dispatch(tok, experts, slots, kept, num_experts, cap),
            (experts, slots, kept, weights), aux)


def moe_ffn(tok, gate_w, we1, we2, capacity_factor=2.0, k=2):
    """The transformer's MoE feed-forward over ``tok`` (tokens, d):
    route by ``tok @ gate_w``, ``gelu(x @ we1[e]) @ we2[e]`` per expert
    (tanh GELU, as ``jax.nn.gelu``), combine. ``we1`` (E, d, f), ``we2``
    (E, f, d). Capacity is computed over all ``tokens`` of the call.
    Returns (out (tokens, d), aux_loss)."""
    buf, route, aux = _route_dispatch(tok, gate_w, k, capacity_factor)
    h = F.gelu(torch.bmm(buf, we1), approximate="tanh")
    return _combine(torch.bmm(h, we2), *route), aux


def moe_apply(x, gate_w, expert_params, expert_fn, mesh=None, axis="ep",
              k=2, capacity_factor=2.0):
    """Apply an MoE layer to tokens ``x`` (tokens, d_model), the JAX
    package's ``moe_apply`` on one device.

    gate_w : (d_model, num_experts) router weights.
    expert_params : parameters stacked on a leading num_experts axis
        (see :func:`stack_expert_params`).
    expert_fn : ``expert_fn(one_expert_params, (C, d)) -> (C, d_out)``,
        run once per expert on its slots.
    mesh : None, or a dict of mesh axis sizes; ``axis`` above 1 raises
        :class:`NotImplementedError` (expert parallelism over
        ``torch.distributed`` is ROADMAP A15).

    Returns (out (tokens, d_out), aux_loss)."""
    if mesh is not None:
        from .transformer import AXES, _check_mesh
        sizes = dict({a: 1 for a in AXES}, **{axis: mesh.get(axis, 1)})
        _check_mesh(sizes)
    exp_in, route, aux = _route_dispatch(x, gate_w, k, capacity_factor)
    exp_out = torch.stack([
        expert_fn(_tree_map(lambda p, e=e: p[e], expert_params), exp_in[e])
        for e in range(gate_w.shape[-1])])
    return _combine(exp_out, *route), aux
