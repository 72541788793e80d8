"""Declarative operator registry.

Counterpart of the JAX package's ``ops/registry.py``: every operator is a
plain function on tensors, ``fn(*tensors, **attrs) -> tensor | tuple``,
registered with its metadata. Gradients come from ``torch.autograd``
through the function (or a ``torch.autograd.Function`` where the op's
gradient is not the derivative of its forward, as SoftmaxOutput's); the
symbol layer infers shapes by running the function on ``device="meta"``
tensors. PyTorch runs eagerly, so there is no per-op jit cache.

The port registers the operators of the ResNet training path; any other
name raises :class:`MXNetError` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["OpDef", "register", "alias", "get_op", "list_ops", "invoke"]

_REGISTRY = {}


class OpDef(object):
    """Metadata for one operator.

    name : canonical op name (MXNet-compatible, e.g. ``FullyConnected``).
    fn : ``fn(*tensors, **attrs)``; its positional parameters that are
        not attrs are the op's array inputs, in order.
    num_outputs : int, or callable(attrs) -> int.
    attr_defaults : attr name -> default; every other positional
        parameter of ``fn`` is an input.
    """

    __slots__ = ("name", "fn", "num_outputs", "attr_defaults", "doc")

    needs_rng = False       # no random op is ported yet (ROADMAP A15)

    def __init__(self, name, fn, num_outputs=1, attr_defaults=None,
                 doc=None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.attr_defaults = dict(attr_defaults or {})
        self.doc = doc or (fn.__doc__ if fn else None)

    def n_outputs(self, attrs):
        if callable(self.num_outputs):
            return self.num_outputs(attrs)
        return self.num_outputs

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name, **kwargs):
    """Decorator: register a function on tensors as an operator."""
    def _wrap(fn):
        if name in _REGISTRY:
            raise MXNetError("operator %r already registered" % name)
        _REGISTRY[name] = OpDef(name, fn, **kwargs)
        return fn
    return _wrap


def alias(new_name, existing_name):
    """Register ``new_name`` as an alias of an existing op."""
    op = get_op(existing_name)
    _REGISTRY[new_name] = OpDef(new_name, op.fn, num_outputs=op.num_outputs,
                                attr_defaults=op.attr_defaults, doc=op.doc)
    return _REGISTRY[new_name]


def get_op(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise MXNetError(
            "operator %r is not ported to mxnet_tpu_torch yet (the rest of "
            "the op registry is ROADMAP A15)" % name) from None


def list_ops():
    return sorted(_REGISTRY)



def invoke(name, tensors, attrs=None):
    """Apply op ``name`` to tensors; always returns a tuple."""
    out = get_op(name).fn(*tensors, **(attrs or {}))
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)
