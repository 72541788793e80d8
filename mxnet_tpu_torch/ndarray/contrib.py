"""``nd.contrib``: every registered ``_contrib_*`` op under its public
name (``nd.contrib.flash_attention``, ``nd.contrib.CTCLoss``, ...),
reference: python/mxnet/ndarray/contrib.py."""
from __future__ import annotations

from ..ops import registry as _reg
from .register import make_op_func

__all__ = []
for _name in _reg.list_ops():
    if _name.startswith("_contrib_"):
        _pub = _name[len("_contrib_"):]
        globals()[_pub] = make_op_func(_reg.get_op(_name))
        globals()[_pub].__name__ = _pub
        __all__.append(_pub)
