"""Elementwise operators.

Counterpart of the JAX package's ``ops/elemwise.py``, for the operators
the imperative API and Gluon's losses use: the unary functions, the
``broadcast_*`` binary family (with its ``elemwise_*`` / ``_plus``
aliases), the ``_*_scalar`` family the NDArray operators dispatch to,
``clip``, ``zeros_like`` / ``ones_like``, ``Cast`` and ``BlockGrad``.
Comparisons give 0/1 in the inputs' type and no gradient, as there. A
scalar takes the tensor's type before the operation (JAX's
``jnp.asarray(scalar, dtype=x.dtype)``). The rest of the file is ROADMAP
A15.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import alias, register


_UNARY = {
    "abs": torch.abs,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "log": torch.log,
    "tanh": torch.tanh,
    "negative": torch.neg,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
}

for _name, _f in _UNARY.items():
    register(_name)(lambda x, _f=_f: _f(x))


@register("_copy")
def _copy(x):
    return x.clone()


alias("identity", "_copy")


@register("stop_gradient")
def _stop_gradient(x):
    return x.detach()


alias("BlockGrad", "stop_gradient")


def _cmp(f):
    def _g(a, b):
        return f(a, b).to(torch.result_type(a, b))
    return _g


_BINARY = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.div,
    "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_equal": _cmp(torch.eq),
    "broadcast_not_equal": _cmp(torch.ne),
    "broadcast_greater": _cmp(torch.gt),
    "broadcast_greater_equal": _cmp(torch.ge),
    "broadcast_lesser": _cmp(torch.lt),
    "broadcast_lesser_equal": _cmp(torch.le),
}

for _name, _f in _BINARY.items():
    register(_name)(lambda a, b, _f=_f: _f(a, b))

for _ew, _bc in [("elemwise_add", "broadcast_add"),
                 ("elemwise_sub", "broadcast_sub"),
                 ("elemwise_mul", "broadcast_mul"),
                 ("elemwise_div", "broadcast_div"),
                 ("_plus", "broadcast_add"), ("_minus", "broadcast_sub"),
                 ("_mul", "broadcast_mul"), ("_div", "broadcast_div"),
                 ("_maximum", "broadcast_maximum"),
                 ("_minimum", "broadcast_minimum"),
                 ("_power", "broadcast_power"),
                 ("broadcast_plus", "broadcast_add"),
                 ("broadcast_minus", "broadcast_sub"),
                 ("_greater", "broadcast_greater"),
                 ("_greater_equal", "broadcast_greater_equal"),
                 ("_lesser", "broadcast_lesser"),
                 ("_lesser_equal", "broadcast_lesser_equal")]:
    alias(_ew, _bc)


def _as_type_of(x, scalar):
    """``scalar`` in ``x``'s type, as a Python number."""
    if x.dtype.is_floating_point:
        return float(scalar)
    return int(scalar)


def _scalar_op(name, f):
    def _g(x, scalar=0.0):
        return f(x, _as_type_of(x, scalar))
    register(name, attr_defaults={"scalar": 0.0})(_g)


def _rscalar(f):
    def _g(x, s):
        return f(torch.full_like(x, s), x)
    return _g


_scalar_op("_plus_scalar", torch.add)
_scalar_op("_minus_scalar", torch.sub)
_scalar_op("_rminus_scalar", lambda x, s: s - x)
_scalar_op("_mul_scalar", torch.mul)
_scalar_op("_div_scalar", torch.div)
_scalar_op("_rdiv_scalar", lambda x, s: s / x)
_scalar_op("_mod_scalar", torch.remainder)
_scalar_op("_rmod_scalar", _rscalar(torch.remainder))
_scalar_op("_power_scalar", torch.pow)
_scalar_op("_rpower_scalar", _rscalar(torch.pow))
for _name, _f in (("_equal_scalar", torch.eq), ("_not_equal_scalar", torch.ne),
                  ("_greater_scalar", torch.gt),
                  ("_greater_equal_scalar", torch.ge),
                  ("_lesser_scalar", torch.lt),
                  ("_lesser_equal_scalar", torch.le)):
    _scalar_op(_name, lambda x, s, _f=_f: _f(x, s).to(x.dtype))


@register("clip", attr_defaults={"a_min": 0.0, "a_max": 0.0})
def _clip(x, a_min=0.0, a_max=0.0):
    return torch.clamp(x, a_min, a_max)


@register("zeros_like")
def _zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like")
def _ones_like(x):
    return torch.ones_like(x)


@register("Cast", attr_defaults={"dtype": "float32"})
def _cast(x, dtype="float32"):
    """``x`` as ``dtype`` with the reference's conversions (XLA's
    convert): a float becomes an integer by truncation toward zero,
    saturated to the type's range, NaN to 0; integers wrap, as there;
    bool and the float types among themselves as ``Tensor.to``, except
    that a NaN cast to bfloat16 is XLA's quiet NaN with the input's
    sign (0x7FC0 / 0xFFC0), where ``Tensor.to`` gives 0xFFFF on the
    CPU."""
    from ..ndarray.ndarray import to_torch_dtype
    dt = to_torch_dtype(dtype)
    if dt == torch.bfloat16 and x.is_floating_point() and x.dtype != dt:
        return _to_bfloat16(x)
    if not x.is_floating_point() or dt.is_floating_point or dt == torch.bool:
        return x.to(dt)
    info = torch.iinfo(dt)
    # float64 holds every 32-bit integer exactly, so the clamp is exact
    y = torch.nan_to_num(torch.trunc(x.double()), nan=0.0)
    out = y.clamp(info.min, info.max).to(dt)
    if info.bits == 64:     # int64's max rounds up to 2^63 in float64
        out = torch.where(y >= 2.0 ** 63, info.max, out)
    return out


def _to_bfloat16(x):
    """``x.to(bfloat16)`` (round to nearest even) with each NaN made
    0x7FC0, or 0xFFC0 where its sign bit is set: elementwise selects (no
    host synchronisation) that keep the cast's gradient."""
    # 0xFFC0 as an int16 is -64
    nans = torch.where(torch.signbit(x.detach()), -64, 0x7FC0).to(
        torch.int16).view(torch.bfloat16)
    return torch.where(torch.isnan(x), nans, x.to(torch.bfloat16))


alias("cast", "Cast")

