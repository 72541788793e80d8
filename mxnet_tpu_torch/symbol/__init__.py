"""Symbol package: graph construction and the generated op namespace
(reference: python/mxnet/symbol/__init__.py)."""
from .symbol import AUX_STATES, Group, Symbol, Variable, load, load_json, var
from . import register as _register

_register.populate(__name__)
