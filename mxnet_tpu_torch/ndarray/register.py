"""Generate the NDArray op namespace from the registry (reference:
python/mxnet/ndarray/register.py; the JAX package's
``ndarray/register.py``): one function per registered op, taking
positional NDArray inputs, keyword attrs, keyword NDArrays as further
inputs (in keyword order) and ``out=``. Names that the ``ndarray``
package already defines (``array``, ``zeros``, ...) are left alone."""
from __future__ import annotations

import sys

from ..ops import registry as _reg
from .ndarray import NDArray, invoke_op

__all__ = ["make_op_func", "populate"]


def make_op_func(opdef):
    def op_func(*args, out=None, name=None, **kwargs):
        arrays = list(args)
        attrs = {}
        for k, v in kwargs.items():
            if isinstance(v, NDArray):
                arrays.append(v)
            else:
                attrs[k] = v
        return invoke_op(opdef.name, arrays, attrs, out=out)

    op_func.__name__ = opdef.name
    op_func.__qualname__ = opdef.name
    op_func.__doc__ = opdef.doc
    return op_func


def populate(target_module_name):
    """Install a function for every registered op not yet defined in the
    module ``target_module_name``."""
    mod = sys.modules[target_module_name]
    for name in _reg.list_ops():
        if not hasattr(mod, name):
            setattr(mod, name, make_op_func(_reg.get_op(name)))
