"""NDArray package (reference: python/mxnet/ndarray/__init__.py): the
array wrapper, creation helpers, random sampling, ``save`` / ``load``
(``utils``; the reference binary layout in ``mxnet_format``) and one
function per registered op (``nd.relu``, ``nd.sum``, ...; ``register``),
``nd.Custom`` among them, and ``nd.contrib``."""
from .ndarray import (NDArray, arange, array, concat, empty, full, invoke_op,
                      ones, stack, waitall, zeros)
from . import random
from .utils import load, save
from .. import ops as _ops  # noqa: F401  (fills the op registry)
from . import register as _register

_register.populate(__name__)
from . import contrib  # noqa: E402  (the _contrib_* ops, once registered)

__all__ = ["NDArray", "arange", "array", "concat", "empty", "full",
           "invoke_op", "load", "ones", "random", "save", "stack", "waitall",
           "zeros", "contrib"]
