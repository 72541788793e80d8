"""Elementwise operators.

Counterpart of the JAX package's ``ops/elemwise.py``: the 44 unary
functions, the ``broadcast_*`` binary family (with its ``elemwise_*`` /
``_plus`` aliases), the ``_*_scalar`` family the NDArray operators
dispatch to, the logical family, ``clip``, ``smooth_l1``,
``hard_sigmoid``, ``add_n``, ``SoftmaxActivation``, ``zeros_like`` /
``ones_like``, ``shape_array`` / ``size_array``, ``Cast``,
``BlockGrad`` and ``MakeLoss``. Comparisons and logical ops give 0/1 in
the inputs' type and no gradient, as there. A scalar takes the tensor's
type before the operation (JAX's ``jnp.asarray(scalar, dtype=x.dtype)``).
``round`` and ``rint`` round half to even, as ``jnp.round`` does (not
reference MXNet's half away from zero); ``gamma`` is ``exp(gammaln)``,
as the JAX op's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import alias, register


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _sign(x):
    """``jnp.sign``: NaN stays NaN and a zero keeps its sign bit, where
    ``torch.sign`` gives +0 for both (C.14); the gradient is 0."""
    keep = (x == 0) | torch.isnan(x)
    return torch.where(keep, x.detach(), torch.sign(x))


def _mod(a, b):
    """``jnp.mod``: the floored remainder, where an integer divisor of 0
    gives 0 (``jnp.mod`` divides by 1 there; ``torch.remainder`` raises
    on the CPU and gives garbage on the card) (C.13)."""
    if a.is_floating_point() or (torch.is_tensor(b) and
                                 b.is_floating_point()):
        return torch.remainder(a, b)
    if not torch.is_tensor(b):
        return torch.remainder(a, b if b != 0 else 1)
    return torch.remainder(a, torch.where(b == 0, torch.ones_like(b), b))


_UNARY = {
    "abs": torch.abs,
    "sign": _sign,
    "rint": torch.round,
    "round": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "negative": torch.neg,
    "reciprocal": torch.reciprocal,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,
    "softrelu": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
}

for _name, _f in _UNARY.items():
    register(_name)(lambda x, _f=_f: _f(x))


@register("logical_not")
def _logical_not(x):
    return (x == 0).to(x.dtype)


@register("_copy")
def _copy(x):
    return x.clone()


alias("identity", "_copy")


@register("stop_gradient")
def _stop_gradient(x):
    return x.detach()


alias("BlockGrad", "stop_gradient")


@register("make_loss")
def _make_loss(x):
    return x


alias("MakeLoss", "make_loss")


def _cmp(f):
    def _g(a, b):
        return f(a, b).to(torch.result_type(a, b))
    return _g


def _logical(f):
    return _cmp(lambda a, b: f(a != 0, b != 0))


_BINARY = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.div,
    "broadcast_mod": _mod,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_equal": _cmp(torch.eq),
    "broadcast_not_equal": _cmp(torch.ne),
    "broadcast_greater": _cmp(torch.gt),
    "broadcast_greater_equal": _cmp(torch.ge),
    "broadcast_lesser": _cmp(torch.lt),
    "broadcast_lesser_equal": _cmp(torch.le),
    "broadcast_hypot": torch.hypot,
    "broadcast_logical_and": _logical(torch.logical_and),
    "broadcast_logical_or": _logical(torch.logical_or),
    "broadcast_logical_xor": _logical(torch.logical_xor),
    "arctan2": torch.atan2,
}

# indicator-valued ops carry no gradient (the reference registers them
# without FGradient)
_INDICATOR = {"broadcast_equal", "broadcast_not_equal", "broadcast_greater",
              "broadcast_greater_equal", "broadcast_lesser",
              "broadcast_lesser_equal", "broadcast_logical_and",
              "broadcast_logical_or", "broadcast_logical_xor"}

for _name, _f in _BINARY.items():
    register(_name, differentiable=_name not in _INDICATOR)(
        lambda a, b, _f=_f: _f(a, b))

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
                 ("_lesser_equal", "broadcast_lesser_equal"),
                 ("_add", "broadcast_add"), ("_sub", "broadcast_sub"),
                 ("_mod", "broadcast_mod"), ("_equal", "broadcast_equal"),
                 ("_not_equal", "broadcast_not_equal"),
                 ("_hypot", "broadcast_hypot")]:
    alias(_ew, _bc)


def _as_type_of(x, scalar):
    """``scalar`` in ``x``'s type, as a Python number."""
    if x.dtype.is_floating_point:
        return float(scalar)
    return int(scalar)


def _scalar_op(name, f, differentiable=True):
    def _g(x, scalar=0.0):
        return f(x, _as_type_of(x, scalar))
    register(name, attr_defaults={"scalar": 0.0},
             differentiable=differentiable)(_g)


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
_scalar_op("_mod_scalar", _mod)
_scalar_op("_rmod_scalar", _rscalar(_mod))
_scalar_op("_power_scalar", torch.pow)
_scalar_op("_rpower_scalar", _rscalar(torch.pow))
_scalar_op("_maximum_scalar", lambda x, s: torch.maximum(
    x, torch.full_like(x, s)))
_scalar_op("_minimum_scalar", lambda x, s: torch.minimum(
    x, torch.full_like(x, s)))
_scalar_op("_hypot_scalar", lambda x, s: torch.hypot(
    x, torch.full_like(x, s)))
for _name, _f in (("_equal_scalar", torch.eq), ("_not_equal_scalar", torch.ne),
                  ("_greater_scalar", torch.gt),
                  ("_greater_equal_scalar", torch.ge),
                  ("_lesser_scalar", torch.lt),
                  ("_lesser_equal_scalar", torch.le),
                  ("_logical_and_scalar", lambda x, s: (x != 0) & (s != 0)),
                  ("_logical_or_scalar", lambda x, s: (x != 0) | (s != 0)),
                  ("_logical_xor_scalar", lambda x, s: (x != 0) ^ (s != 0))):
    _scalar_op(_name, lambda x, s, _f=_f: _f(x, s).to(x.dtype),
               differentiable=False)


@register("clip", attr_defaults={"a_min": 0.0, "a_max": 0.0})
def _clip(x, a_min=0.0, a_max=0.0):
    return torch.clamp(x, a_min, a_max)


@register("smooth_l1", attr_defaults={"scalar": 1.0})
def _smooth_l1(x, scalar=1.0):
    """``0.5 (s x)^2`` where ``|x| < 1/s^2``, else ``|x| - 0.5/s^2``
    (reference: elemwise_binary_scalar_op_extended.cc)."""
    s2 = scalar * scalar
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


@register("hard_sigmoid", attr_defaults={"alpha": 0.2, "beta": 0.5})
def _hard_sigmoid(x, alpha=0.2, beta=0.5):
    """``max(0, min(1, alpha * x + beta))``."""
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


def _logical_family(name, f):
    """The elementwise twins of ``broadcast_logical_*``."""
    register("_" + name, differentiable=False)(_logical(f))
    alias(name, "_" + name)


_logical_family("logical_and", torch.logical_and)
_logical_family("logical_or", torch.logical_or)
_logical_family("logical_xor", torch.logical_xor)


@register("add_n")
def _add_n(*args):
    """The sum of any number of same-shape arrays (reference:
    elemwise_sum.cc ElementWiseSum)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


alias("ElementWiseSum", "add_n")


@register("SoftmaxActivation", attr_defaults={"mode": "instance"})
def _softmax_activation(x, mode="instance"):
    """Softmax over all but the batch axis (``instance``), or over the
    channels at each position (``channel``)."""
    if mode == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


@register("zeros_like")
def _zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like")
def _ones_like(x):
    return torch.ones_like(x)


@register("shape_array", differentiable=False)
def _shape_array(x):
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


@register("size_array", differentiable=False)
def _size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


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

