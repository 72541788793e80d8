"""Symbol package: graph construction and the generated op namespace
(reference: python/mxnet/symbol/__init__.py)."""
from .symbol import AUX_STATES, Group, Symbol, Variable, load, load_json, var
from . import register as _register

_register.populate(__name__)



def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, dtype="float32", name=None):
    """A symbol of zeros of ``shape`` (the JAX package's ``sym.zeros``),
    created on the executor's device."""
    return _zeros(shape=_shape(shape), dtype=dtype, name=name)  # noqa: F821


def ones(shape, dtype="float32", name=None):
    """A symbol of ones of ``shape`` (the JAX package's ``sym.ones``)."""
    return _ones(shape=_shape(shape), dtype=dtype, name=name)  # noqa: F821
