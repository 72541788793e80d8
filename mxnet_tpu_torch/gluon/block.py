"""Gluon ``Block`` and ``HybridBlock``.

Counterpart of the JAX package's ``gluon/block.py`` (reference:
python/mxnet/gluon/block.py): name scopes and automatic prefixes,
child and parameter registration, ``collect_params``, ``initialize``,
forward hooks, and ``save_parameters`` / ``load_parameters`` (the
reference's binary ``.params`` layout, ``ndarray/mxnet_format.py``, keyed
by the structural names ``features.0.weight``; either package loads what
the other writes). ``HybridBlock.forward`` gathers the block's
parameters and calls ``hybrid_forward(F, x, ..., **params)`` with ``F``
the ``ndarray`` namespace, finishing a deferred initialization from the
first batch.

PyTorch runs eagerly: ``hybridize()`` is accepted and marks the blocks,
and a hybridized block computes what the eager one does, by the same
code. The JAX package's jit trace (its ``CachedOp``), ``export`` and
``SymbolBlock`` raise ``NotImplementedError`` (ROADMAP A12.1).
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _load_into)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "CachedOp"]

_NOT_PORTED = ("%s is not ported to mxnet_tpu_torch: PyTorch runs the "
               "block eagerly, and the hybridize -> Symbol trace is ROADMAP "
               "A12.1")


class _BlockScope(object):
    """Name-manager scope for automatic prefixes (reference:
    gluon/block.py:35 _BlockScope)."""

    _current = threading.local()
    _global_counter = {}

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                count = _BlockScope._global_counter.get(hint, 0)
                _BlockScope._global_counter[hint] = count + 1
                prefix = "%s%d_" % (hint, count)
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block(object):
    """Base building block (reference: gluon/block.py:127); subclasses
    implement ``forward(*args)`` on NDArrays."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}
        self._forward_hooks = []
        self._forward_pre_hooks = []

    def _alias(self):
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)) and \
                    not isinstance(existing, type(value)):
                raise TypeError(
                    "Changing attribute type for %s from %s to %s is not "
                    "allowed." % (name, type(existing), type(value)))
        if isinstance(value, Block):
            self._children[name] = value
        elif isinstance(value, Parameter):
            self._reg_params[name] = value
        super(Block, self).__setattr__(name, value)

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block
        return block

    def register_forward_hook(self, hook):
        self._forward_hooks.append(hook)
        return hook

    def register_forward_pre_hook(self, hook):
        self._forward_pre_hooks.append(hook)
        return hook

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """Every Parameter of this block and its children, optionally
        those whose name matches the regex ``select`` (reference:
        gluon/block.py:148)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self.params.items()
                        if pattern.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def __repr__(self):
        lines = [self.__class__.__name__ + "("]
        for name, child in self._children.items():
            lines.append("  (%s): %s" % (name,
                                         repr(child).replace("\n", "\n  ")))
        lines.append(")")
        return "\n".join(lines)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default ``cuda:0``)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    # -- save / load -------------------------------------------------------
    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename):
        """Save the parameters, keyed by structure (``features.0.weight``),
        in the reference's binary layout (reference: block.py:315)."""
        from ..ndarray import utils as nd_utils
        nd_utils.save(filename, {k: v.data() for k, v in
                                 self._collect_params_with_prefix().items()},
                      format="mxnet")

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Load what ``save_parameters`` of either package wrote
        (reference: block.py:357)."""
        from ..ndarray import utils as nd_utils
        _load_into(self._collect_params_with_prefix(),
                   nd_utils.load(filename), filename, ctx, allow_missing,
                   ignore_extra)

    # -- execution ---------------------------------------------------------
    def __call__(self, *args):
        for hook in self._forward_pre_hooks:
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A Block written with ``hybrid_forward(F, x, ..., **params)``
    (reference: gluon/block.py:750)."""

    def __init__(self, prefix=None, params=None):
        super(HybridBlock, self).__init__(prefix=prefix, params=params)
        self._active = False

    def hybridize(self, active=True, **kwargs):
        """Accepted: the block keeps running eagerly, with the same
        numbers (the Symbol trace is ROADMAP A12.1)."""
        self._active = active
        super(HybridBlock, self).hybridize(active, **kwargs)

    def infer_shape(self, *args):
        """Complete deferred parameter shapes from the inputs; layers
        whose parameter shapes follow their input override it."""
        raise DeferredInitializationError(
            "%s has parameters of unknown shape and no infer_shape"
            % type(self).__name__)

    def forward(self, x, *args):
        from .. import ndarray as F
        try:
            params = {n: p.data() for n, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(x, *args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            params = {n: p.data() for n, p in self._reg_params.items()}
        return self.hybrid_forward(F, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        raise NotImplementedError(_NOT_PORTED % "HybridBlock.export")


class SymbolBlock(HybridBlock):
    """A Symbol as a Block (reference: gluon/block.py:954): not ported."""

    def __init__(self, outputs, inputs, params=None):
        raise NotImplementedError(_NOT_PORTED % "SymbolBlock")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        raise NotImplementedError(_NOT_PORTED % "SymbolBlock.imports")


class CachedOp(object):
    """The JAX package's traced whole-block program: not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED % "CachedOp")

