"""Random sampling into NDArrays (reference: python/mxnet/ndarray/random.py;
the subset the initializers use). Draws come from
:func:`mxnet_tpu_torch.random.generator` of the target's device."""
from __future__ import annotations

import torch

from .. import random as _random
from .ndarray import NDArray, _as_shape, _device, to_torch_dtype

__all__ = ["uniform", "normal"]


def _target(shape, dtype, ctx, out):
    if out is not None:
        return out
    return NDArray(torch.empty(_as_shape(shape), dtype=to_torch_dtype(dtype),
                               device=_device(ctx)))


def uniform(low=0.0, high=1.0, shape=(), dtype="float32", ctx=None,
            out=None):
    """U[low, high) into ``out`` (in place) or a new array."""
    out = _target(shape, dtype, ctx, out)
    with torch.no_grad():
        out._data.uniform_(low, high,
                           generator=_random.generator(out.context))
    return out


def normal(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None,
           out=None):
    """N(loc, scale^2) into ``out`` (in place) or a new array."""
    out = _target(shape, dtype, ctx, out)
    with torch.no_grad():
        out._data.normal_(loc, scale,
                          generator=_random.generator(out.context))
    return out
