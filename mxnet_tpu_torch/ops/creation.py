"""Array-creation operators (the JAX package's ``ops/creation.py``;
reference: src/operator/tensor/init_op.cc): ``_zeros``, ``_ones``,
``_full``, ``_arange``, ``_linspace``, ``_eye``.

They take no array input, so each takes the device to create on as its
``ctx`` attr: the NDArray layer passes the current context (``cuda:0``
unless asked otherwise), a Symbol's evaluation the device of its bound
arrays, and shape inference ``"meta"``.
"""
from __future__ import annotations

import torch

from .registry import register


def _dt(dtype):
    from ..ndarray.ndarray import to_torch_dtype
    return to_torch_dtype(dtype)


def _dev(ctx):
    return torch.device("cpu" if ctx is None else ctx)


def _shape(shape):
    return (int(shape),) if isinstance(shape, int) else \
        tuple(int(s) for s in shape)


@register("_zeros", differentiable=False,
          attr_defaults={"shape": (), "dtype": "float32", "ctx": None})
def _zeros(shape=(), dtype="float32", ctx=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=_dev(ctx))


@register("_ones", differentiable=False,
          attr_defaults={"shape": (), "dtype": "float32", "ctx": None})
def _ones(shape=(), dtype="float32", ctx=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=_dev(ctx))


@register("_full", differentiable=False,
          attr_defaults={"shape": (), "value": 0.0, "dtype": "float32",
                         "ctx": None})
def _full(shape=(), value=0.0, dtype="float32", ctx=None):
    return torch.full(_shape(shape), value, dtype=_dt(dtype),
                      device=_dev(ctx))


@register("_arange", differentiable=False,
          attr_defaults={"start": 0.0, "stop": None, "step": 1.0,
                         "repeat": 1, "dtype": "float32", "ctx": None})
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            ctx=None):
    """``jnp.arange(start, stop, step)`` in ``dtype``, each value
    ``repeat`` times: ``ceil((stop - start) / step)`` values
    ``start + i * step``, computed in float64 before the cast."""
    if stop is None:
        start, stop = 0.0, start
    n = max(0, -(-(float(stop) - float(start)) // float(step)))
    out = (float(start) + float(step) * torch.arange(
        int(n), dtype=torch.float64, device=_dev(ctx))).to(_dt(dtype))
    if repeat > 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register("_linspace", differentiable=False,
          attr_defaults={"start": 0.0, "stop": 1.0, "num": 50,
                         "endpoint": True, "dtype": "float32", "ctx": None})
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32",
              ctx=None):
    num = int(num)
    div = (num - 1) if endpoint else num
    step = (float(stop) - float(start)) / div if div > 0 else 0.0
    out = float(start) + step * torch.arange(num, dtype=torch.float64,
                                             device=_dev(ctx))
    if endpoint and num > 1:
        out[-1] = float(stop)
    return out.to(_dt(dtype))


@register("_eye", differentiable=False,
          attr_defaults={"N": 0, "M": 0, "k": 0, "dtype": "float32",
                         "ctx": None})
def _eye(N=0, M=0, k=0, dtype="float32", ctx=None):
    n, m, k = int(N), int(M) or int(N), int(k)
    rows = torch.arange(n, device=_dev(ctx)).unsqueeze(1)
    cols = torch.arange(m, device=_dev(ctx)).unsqueeze(0)
    return (cols - rows == k).to(_dt(dtype))
