"""Reductions (the JAX package's ``ops/reduce.py``): ``sum``, ``mean``,
``max``, ``min`` over ``axis`` (an int, a tuple or all axes) with
``keepdims`` and ``exclude``, and ``norm`` (L1 / L2); the rest is
ROADMAP A15."""
from __future__ import annotations

import torch

from .registry import register


def _axes(ndim, axis, exclude=False):
    if axis is None or axis == ():
        axes = tuple(range(ndim))
    elif isinstance(axis, int):
        axes = (axis % ndim,)
    else:
        axes = tuple(a % ndim for a in axis)
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _amax(x, dim, keepdim):
    return torch.amax(x, dim=dim, keepdim=keepdim)


def _amin(x, dim, keepdim):
    return torch.amin(x, dim=dim, keepdim=keepdim)


def _reduce(name, f):
    def _g(x, axis=None, keepdims=False, exclude=False):
        axes = _axes(x.dim(), axis, exclude)
        if not axes:
            return x.clone()
        return f(x, dim=axes, keepdim=bool(keepdims))
    register(name, attr_defaults={"axis": None, "keepdims": False,
                                  "exclude": False})(_g)


_reduce("sum", torch.sum)
_reduce("mean", torch.mean)
_reduce("max", _amax)
_reduce("min", _amin)


@register("norm", attr_defaults={"ord": 2, "axis": None, "keepdims": False})
def _norm(x, ord=2, axis=None, keepdims=False):
    axes = _axes(x.dim(), axis)
    if ord == 1:
        return torch.sum(torch.abs(x), dim=axes, keepdim=bool(keepdims))
    return torch.sqrt(torch.sum(torch.square(x), dim=axes,
                                keepdim=bool(keepdims)))
