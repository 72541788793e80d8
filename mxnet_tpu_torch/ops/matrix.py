"""Shape and indexing operators (the JAX package's ``ops/matrix.py``):
``Flatten``, ``Reshape`` with MXNet's special codes, ``reshape_like``,
``transpose``, ``expand_dims``, ``slice_axis``, ``pick`` and ``where``;
the rest of that file is ROADMAP A15."""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import alias, register


@register("Flatten")
def _flatten(x):
    return x.reshape(x.shape[0], -1)


alias("flatten", "Flatten")


def infer_reshape(src_shape, target, reverse=False):
    """The output shape of ``Reshape(shape=target)`` on ``src_shape``,
    with the special codes 0 (copy a dim), -1 (infer), -2 (copy the
    rest), -3 (merge two), -4 (split one in two) (reference:
    src/operator/tensor/matrix_op-inl.h InferReshapeShape; the JAX
    package's ``ops/matrix.py`` ``infer_reshape``)."""
    tgt = list(target)
    groups = []
    i = 0
    while i < len(tgt):
        if tgt[i] == -4:
            if i + 2 >= len(tgt):
                raise MXNetError("reshape: -4 needs two following entries")
            groups.append((tgt[i], tgt[i + 1], tgt[i + 2]))
            i += 3
        else:
            groups.append((tgt[i],))
            i += 1
    src = list(src_shape)
    if reverse:
        src = src[::-1]
        groups = groups[::-1]
    out = []
    src_i = 0
    infer_idx = -1
    for g in groups:
        t = g[0]
        if t > 0:
            out.append(t)
            src_i += 1
        elif t == 0:
            if src_i >= len(src):
                raise MXNetError("reshape: 0 out of bounds")
            out.append(src[src_i])
            src_i += 1
        elif t == -1:
            if infer_idx >= 0:
                raise MXNetError("reshape: more than one -1")
            infer_idx = len(out)
            out.append(-1)
            src_i += 1
        elif t == -2:
            out.extend(src[src_i:])
            src_i = len(src)
        elif t == -3:
            if src_i + 1 >= len(src):
                raise MXNetError("reshape: -3 needs two source dims")
            out.append(src[src_i] * src[src_i + 1])
            src_i += 2
        elif t == -4:
            if src_i >= len(src):
                raise MXNetError("reshape: -4 out of source dims")
            d1, d2 = (g[2], g[1]) if reverse else (g[1], g[2])
            d = src[src_i]
            if d1 == -1 and d2 == -1:
                raise MXNetError("reshape: -4 with two -1s")
            if d1 == -1:
                d1 = d // d2
            if d2 == -1:
                d2 = d // d1
            out.extend([d1, d2])
            src_i += 1
        else:
            raise MXNetError("reshape: invalid code %d" % t)
    total = 1
    for s in src_shape:
        total *= s
    if infer_idx >= 0:
        known = 1
        for j, v in enumerate(out):
            if j != infer_idx:
                known *= v
        out[infer_idx] = total // known
    if reverse:
        out = out[::-1]
    return tuple(out)


@register("Reshape", attr_defaults={"shape": None, "reverse": False})
def _reshape(x, shape=None, reverse=False):
    return x.reshape(infer_reshape(tuple(x.shape), shape, reverse))


alias("reshape", "Reshape")


@register("reshape_like")
def _reshape_like(x, y):
    return x.reshape(y.shape)


@register("transpose", attr_defaults={"axes": None})
def _transpose(x, axes=None):
    if not axes:
        axes = tuple(range(x.dim() - 1, -1, -1))
    return x.permute(*axes)


@register("expand_dims", attr_defaults={"axis": 0})
def _expand_dims(x, axis=0):
    return x.unsqueeze(axis)


@register("slice_axis", attr_defaults={"axis": 0, "begin": 0, "end": None})
def _slice_axis(x, axis=0, begin=0, end=None):
    return x[(slice(None),) * (axis % x.dim()) + (slice(begin, end),)]


@register("pick", attr_defaults={"axis": -1, "keepdims": False,
                                 "mode": "clip"})
def _pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """``x``'s entry at ``index`` along ``axis``; indices are truncated
    to integers and clipped into range."""
    axis = axis % x.dim()
    idx = torch.clamp(index.long(), 0, x.shape[axis] - 1)
    if idx.dim() < x.dim():
        idx = idx.unsqueeze(axis)
    out = torch.gather(x, axis, idx)
    return out if keepdims else out.squeeze(axis)


@register("where")
def _where(condition, x, y):
    return torch.where(condition.bool(), x, y)
