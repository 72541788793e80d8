"""The Symbol op namespace, generated from the registry (reference:
python/mxnet/symbol/register.py): ``sym.Convolution(...)`` and friends
build graph nodes."""
from __future__ import annotations

import sys

from ..ops import registry as _reg
from .symbol import _apply_op

__all__ = ["make_op_func", "populate"]


def make_op_func(opdef):
    def op_func(*args, name=None, attr=None, **kwargs):
        out = _apply_op(opdef, args, kwargs, name)
        if attr:
            out._set_attr(**attr)
        return out

    op_func.__name__ = opdef.name
    op_func.__qualname__ = opdef.name
    op_func.__doc__ = opdef.doc
    return op_func


def populate(target_module_name):
    target = sys.modules[target_module_name]
    for name in _reg.list_ops():
        setattr(target, name, make_op_func(_reg.get_op(name)))
