"""Declarative operator registry.

Counterpart of the JAX package's ``ops/registry.py``: every operator is a
plain function on tensors, ``fn(*tensors, **attrs) -> tensor | tuple``,
registered with its metadata. Gradients come from ``torch.autograd``
through the function (or a ``torch.autograd.Function`` where the op's
gradient is not the derivative of its forward, as SoftmaxOutput's); the
symbol layer infers shapes by running the function on ``device="meta"``
tensors. PyTorch runs eagerly, so there is no per-op jit cache.

An op that draws random numbers (``needs_rng``, Dropout) takes the
``torch.Generator`` to draw from as its first argument, where the JAX
op takes its PRNG key: the caller passes the port's generator of the
tensors' device (``random.generator``), never torch's global one. An op
that is not ``differentiable`` (indices, comparisons, ``one_hot``) gives
outputs detached from the autograd graph, so that the gradients through
it are zero, as the JAX package's, and never torch's own (through
``topk``'s values, say).

Any name not registered raises :class:`MXNetError` naming the ROADMAP
item that ports it.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["OpDef", "register", "alias", "get_op", "list_ops", "apply",
           "invoke"]

_REGISTRY = {}


class OpDef(object):
    """Metadata for one operator.

    name : canonical op name (MXNet-compatible, e.g. ``FullyConnected``).
    fn : ``fn(*tensors, **attrs)``; its positional parameters that are
        not attrs are the op's array inputs, in order.
    num_outputs : int, or callable(attrs) -> int.
    needs_rng : ``fn`` takes a leading ``torch.Generator`` (``gen``).
    differentiable : False for integer-valued and discrete ops: their
        outputs carry no gradient.
    mutate_inputs : indices of the inputs the op updates in place (the
        optimizer updates): output i is input ``mutate_inputs[i]``.
    attr_defaults : attr name -> default; every other positional
        parameter of ``fn`` is an input.
    """

    __slots__ = ("name", "fn", "num_outputs", "needs_rng", "differentiable",
                 "mutate_inputs", "attr_defaults", "doc")

    def __init__(self, name, fn, num_outputs=1, needs_rng=False,
                 differentiable=True, mutate_inputs=(), attr_defaults=None,
                 doc=None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.needs_rng = needs_rng
        self.differentiable = differentiable
        self.mutate_inputs = tuple(mutate_inputs)
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
                                needs_rng=op.needs_rng,
                                differentiable=op.differentiable,
                                mutate_inputs=op.mutate_inputs,
                                attr_defaults=op.attr_defaults, doc=op.doc)
    return _REGISTRY[new_name]


# ops of the JAX package queued under another ROADMAP item than A15
_QUEUED = {"SyncBatchNorm": "A8.3"}


def get_op(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise MXNetError(
            "operator %r is not ported to mxnet_tpu_torch yet (ROADMAP %s)"
            % (name, _QUEUED.get(name, "A15"))) from None


def list_ops():
    return sorted(_REGISTRY)


def apply(op, tensors, attrs, gen=None):
    """``op.fn`` on ``tensors`` with ``attrs``, as a tuple of outputs:
    ``gen`` leads the inputs of a ``needs_rng`` op (the port's generator
    of the first tensor's device when None), and the outputs of an op
    that is not differentiable are detached."""
    if op.needs_rng:
        if gen is None:
            from .. import random as _random
            dev = next(t.device for t in tensors
                       if isinstance(t, torch.Tensor))
            gen = None if dev.type == "meta" else _random.generator(dev)
        out = op.fn(gen, *tensors, **attrs)
    else:
        out = op.fn(*tensors, **attrs)
    outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    if not op.differentiable:
        outs = tuple(o.detach() for o in outs)
    return outs


def invoke(name, tensors, attrs=None):
    """Apply op ``name`` to tensors; always returns a tuple."""
    return apply(get_op(name), tensors, dict(attrs or {}))
