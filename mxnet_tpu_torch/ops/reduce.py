"""Reductions and orderings (the JAX package's ``ops/reduce.py``):
``sum``, ``mean``, ``prod``, ``max``, ``min``, ``nansum``, ``nanprod``
over ``axis`` (an int, a tuple or all axes) with ``keepdims`` and
``exclude``; ``norm`` (L1 / L2); ``argmax`` / ``argmin`` /
``argmax_channel``; ``sort`` / ``argsort`` / ``topk``;
``L2Normalization`` and ``_histogram``.

Types follow the JAX package's (``jnp`` with 64-bit types off): a sum
or product of a signed integer type narrower than 64 bits (or of bool)
is int32, of an unsigned one uint32; a mean of integers is the float32
mean. Indices come back in the input's float type (argmax) or in
``dtype`` (argsort, topk). Orderings are stable, so ties keep the lower
index first, as ``lax.top_k`` and ``jnp.argsort`` do, on the card too.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import alias, register


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


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def _acc_type(dtype):
    """(the type to accumulate in, the result type) of a sum or product:
    jnp's with 64-bit types off."""
    if dtype.is_floating_point or dtype == torch.int64:
        return dtype, dtype
    if dtype in _UNSIGNED:
        return torch.int64, torch.uint32
    return torch.int64, torch.int32


def _sum(x, dim, keepdim):
    acc, res = _acc_type(x.dtype)
    return torch.sum(x, dim=dim, keepdim=keepdim, dtype=acc).to(res)


def _nansum(x, dim, keepdim):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return _sum(x, dim, keepdim)


def _prod(x, dim, keepdim):
    acc, res = _acc_type(x.dtype)
    out = x.to(acc)
    for d in sorted(dim, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out.to(res)


def _nanprod(x, dim, keepdim):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, dim, keepdim)


def _mean(x, dim, keepdim):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=dim, keepdim=keepdim)


def _amax(x, dim, keepdim):
    return torch.amax(x, dim=dim, keepdim=keepdim)


def _amin(x, dim, keepdim):
    return torch.amin(x, dim=dim, keepdim=keepdim)


def _reduce(name, f):
    def _g(x, axis=None, keepdims=False, exclude=False):
        axes = _axes(x.dim(), axis, exclude)
        if not axes:
            return f(x.unsqueeze(0), (0,), False)
        return f(x, axes, bool(keepdims))
    register(name, attr_defaults={"axis": None, "keepdims": False,
                                  "exclude": False})(_g)


_reduce("sum", _sum)
_reduce("mean", _mean)
_reduce("prod", _prod)
_reduce("max", _amax)
_reduce("min", _amin)
_reduce("nansum", _nansum)
_reduce("nanprod", _nanprod)
alias("sum_axis", "sum")
alias("max_axis", "max")
alias("min_axis", "min")


@register("norm", attr_defaults={"ord": 2, "axis": None, "keepdims": False})
def _norm(x, ord=2, axis=None, keepdims=False):
    axes = _axes(x.dim(), axis)
    if ord == 1:
        return torch.sum(torch.abs(x), dim=axes, keepdim=bool(keepdims))
    return torch.sqrt(torch.sum(torch.square(x), dim=axes,
                                keepdim=bool(keepdims)))


def _arg(f):
    def _g(x, axis=None, keepdims=False):
        if axis is None:
            out = f(x.reshape(-1), 0)
            out = out.reshape((1,) * x.dim()) if keepdims else out
        else:
            out = f(x, axis % x.dim())
            if keepdims:
                out = out.unsqueeze(axis % x.dim())
        return out.to(x.dtype)
    return _g


def _first_max(x, dim):
    """The index of the first maximum along ``dim`` (a NaN is the
    maximum, as ``jnp.argmax``'s)."""
    if x.is_floating_point():
        nan = torch.isnan(x)
        x = torch.where(nan, torch.full_like(x, float("inf")), x)
        best = torch.where(nan.any(dim, keepdim=True), float("inf"),
                           x.amax(dim, keepdim=True))
    else:
        best = x.amax(dim, keepdim=True)
    return _first_true(x == best, dim)


def _first_min(x, dim):
    if x.is_floating_point():
        nan = torch.isnan(x)
        x = torch.where(nan, torch.full_like(x, -float("inf")), x)
        best = torch.where(nan.any(dim, keepdim=True), -float("inf"),
                           x.amin(dim, keepdim=True))
    else:
        best = x.amin(dim, keepdim=True)
    return _first_true(x == best, dim)


def _first_true(hit, dim):
    """The first index along ``dim`` where ``hit`` holds: ties go to the
    lower index on every device (torch's CUDA argmax promises nothing
    about ties)."""
    n = hit.shape[dim]
    idx = torch.arange(n, device=hit.device).view(
        [n if i == dim else 1 for i in range(hit.dim())])
    return torch.where(hit, idx, n).amin(dim)


register("argmax", differentiable=False,
         attr_defaults={"axis": None, "keepdims": False})(_arg(_first_max))
register("argmin", differentiable=False,
         attr_defaults={"axis": None, "keepdims": False})(_arg(_first_min))


@register("argmax_channel", differentiable=False)
def _argmax_channel(x):
    return _first_max(x, 1).to(x.dtype)


@register("sort", attr_defaults={"axis": -1, "is_ascend": True})
def _sort(x, axis=-1, is_ascend=True):
    if axis is None:
        x, axis = x.reshape(-1), 0
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else out.flip(axis)


@register("argsort", differentiable=False,
          attr_defaults={"axis": -1, "is_ascend": True, "dtype": "float32"})
def _argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    from ..ndarray.ndarray import to_torch_dtype
    if axis is None:
        x, axis = x.reshape(-1), 0
    idx = torch.sort(x, dim=axis, stable=True).indices
    if not is_ascend:
        idx = idx.flip(axis)
    return idx.to(to_torch_dtype(dtype))


def _topk_num_outputs(attrs):
    return 2 if dict(attrs).get("ret_typ", "indices") == "both" else 1


@register("topk", differentiable=False, num_outputs=_topk_num_outputs,
          attr_defaults={"axis": -1, "k": 1, "ret_typ": "indices",
                         "is_ascend": False, "dtype": "float32"})
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    """The ``k`` largest (smallest with ``is_ascend``) along ``axis``:
    their values, indices, both, or a 0/1 mask of them in ``x``'s type.
    Equal values keep the lower index first (``lax.top_k``'s order): a
    stable sort of ``x``, or of ``-x`` for the smallest."""
    from ..ndarray.ndarray import to_torch_dtype
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = axis % x.dim()
    xm = x.movedim(axis, -1)
    key = xm if is_ascend else -xm
    idx = torch.sort(key, dim=-1, stable=True).indices[..., :int(k)]
    if ret_typ == "mask":
        mask = torch.zeros_like(xm).scatter_(
            -1, idx, torch.ones_like(idx, dtype=x.dtype))
        return mask.movedim(-1, axis)
    vals = torch.gather(xm, -1, idx).movedim(-1, axis)
    idx = idx.movedim(-1, axis).to(to_torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx
    if ret_typ == "both":
        return vals, idx
    raise MXNetError("topk ret_typ %r (value, indices, both, mask)"
                     % (ret_typ,))


@register("L2Normalization", attr_defaults={"eps": 1e-10, "mode": "instance"})
def _l2_normalization(x, eps=1e-10, mode="instance"):
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, x.dim()))
    return x / torch.sqrt(torch.sum(torch.square(x), dim=axes,
                                    keepdim=True) + eps)


@register("_histogram", num_outputs=2, differentiable=False,
          attr_defaults={"bin_cnt": None, "range": None})
def _histogram(data, bins=None, bin_cnt=None, range=None):
    """(int32 counts, bin edges): by the edges ``bins`` (a second input)
    or ``bin_cnt`` uniform bins over ``range`` (default the data's min
    and max); the last bin's right edge is inclusive, values outside
    are dropped."""
    flat = data.reshape(-1)
    if bins is not None:
        edges = bins
        n = edges.shape[0] - 1
        lo, hi = edges[0], edges[-1]
        idx = torch.searchsorted(edges.contiguous(), flat.contiguous(),
                                 right=True) - 1
    else:
        if bin_cnt is None:
            raise MXNetError("_histogram needs bins input or bin_cnt attr")
        n = int(bin_cnt)
        if range is not None:
            lo = torch.tensor(range[0], dtype=flat.dtype, device=flat.device)
            hi = torch.tensor(range[1], dtype=flat.dtype, device=flat.device)
        else:
            lo, hi = flat.min(), flat.max()
        edges = lo + (hi - lo) * torch.arange(
            n + 1, dtype=flat.dtype, device=flat.device) / n
        width = (hi - lo) / n
        idx = torch.floor((flat - lo) / torch.clamp(width, min=1e-30))
    idx = torch.where(flat == hi, n - 1, idx.to(torch.int64))
    idx = torch.where((flat >= lo) & (flat <= hi), idx, n)
    counts = torch.zeros(n + 1, dtype=torch.int32, device=flat.device)
    counts.index_add_(0, idx.clamp(0, n),
                      torch.ones_like(idx, dtype=torch.int32))
    return counts[:n], edges


alias("histogram", "_histogram")
