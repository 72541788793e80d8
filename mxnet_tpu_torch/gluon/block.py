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
first batch; ``summary`` prints a table of the layers' output shapes
and parameter counts, as the JAX package's does.

``hybridize()`` traces the block once per train/predict mode into a
Symbol: ``hybrid_forward(F, ...)`` with ``F`` the ``symbol`` namespace
and each parameter as ``Parameter.var()``, the trace ``export`` also
writes (reference: gluon/block.py:750 ``_build_cache``). A ``CachedOp``
then evaluates that Symbol with ``symbol._graph_eval_fn``: directly on
CPU tensors (a different code path from the eager ``hybrid_forward``),
and on CUDA tensors as CUDA graphs captured once per key and replayed
(``_graphs.py``); nothing falls back to the eager code. In training
mode the graph's BatchNorm nodes give their batch statistics and the
CachedOp updates the moving statistics in place, once a call.
``export`` writes ``-symbol.json`` (the JAX package's format) and
``-NNNN.params`` keyed ``arg:`` / ``aux:``; ``SymbolBlock.imports``
runs such files (from either package) as a block, always through a
CachedOp.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

from ..base import MXNetError
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _load_into)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "CachedOp"]


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

    def summary(self, *inputs):
        """Print a table of every block's output shape and parameter
        count from one forward of ``inputs`` (reference: gluon/block.py
        summary; the JAX package's text)."""
        rows = []

        def make_hook(name):
            def hook(block, _in, out):
                first = out[0] if isinstance(out, (list, tuple)) else out
                n_params = sum(_shape_size(p.shape)
                               for p in block._reg_params.values()
                               if p.shape)
                rows.append((name, type(block).__name__,
                             tuple(getattr(first, "shape", ())), n_params))
            return hook

        handles = []

        def attach(block, path):
            h = block.register_forward_hook(make_hook(path or block.name))
            handles.append((block, h))
            for cname, child in block._children.items():
                attach(child, (path + "." if path else "") + cname)

        attach(self, "")
        try:
            self(*inputs)
        finally:
            for block, h in handles:
                block._forward_hooks.remove(h)
        header = ("%-28s %-20s %-20s %10s" %
                  ("Layer (path)", "Type", "Output Shape", "Params"))
        lines = [header, "-" * len(header)]
        total = 0
        for name, typ, shape, n in rows:
            total += n
            lines.append("%-28s %-20s %-20s %10d" % (name, typ, shape, n))
        lines.append("-" * len(header))
        lines.append("Total params: %d" % total)
        print("\n".join(lines))


def _shape_size(shape):
    n = 1
    for s in shape:
        n *= max(s, 0)
    return n


_local = threading.local()


class _EagerScope(object):
    """Hybridized blocks run their eager code inside this scope (the
    deferred-initialization pass)."""

    def __enter__(self):
        _local.eager = getattr(_local, "eager", 0) + 1
        return self

    def __exit__(self, *exc):
        _local.eager -= 1


def _in_eager_scope():
    return getattr(_local, "eager", 0) > 0


def _is_symbol(x):
    from ..symbol.symbol import Symbol
    return isinstance(x, Symbol)


class HybridBlock(Block):
    """A Block written with ``hybrid_forward(F, x, ..., **params)``
    (reference: gluon/block.py:750); ``hybridize()`` runs it as a traced
    Symbol through a :class:`CachedOp`."""

    def __init__(self, prefix=None, params=None):
        super(HybridBlock, self).__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None

    def hybridize(self, active=True, **kwargs):
        """Run this block (and its children) as a traced Symbol through a
        CachedOp (``active``), or eagerly again; either way the CachedOp
        is rebuilt at the next call."""
        self._active = active
        self._cached_op = None
        super(HybridBlock, self).hybridize(active, **kwargs)

    def cast(self, dtype):
        self._cached_op = None
        super(HybridBlock, self).cast(dtype)

    def infer_shape(self, *args):
        """Complete deferred parameter shapes from the inputs; layers
        whose parameter shapes follow their input override it."""
        raise DeferredInitializationError(
            "%s has parameters of unknown shape and no infer_shape"
            % type(self).__name__)

    def forward(self, x, *args):
        """``hybrid_forward`` on NDArrays, or through the CachedOp when
        hybridized; Symbol inputs (a trace walking nested blocks)
        dispatch on the ``symbol`` namespace with each parameter's
        variable (reference: the JAX package's block.py:499-513)."""
        if _is_symbol(x):
            from .. import symbol as F
            params = {n: p.var() for n, p in self._reg_params.items()}
            return self.hybrid_forward(F, x, *args, **params)
        if self._active and not _in_eager_scope():
            if self._cached_op is None:
                self._finish_deferred(x, *args)
                self._cached_op = CachedOp(self)
            return self._cached_op(x, *args)
        from .. import ndarray as F
        try:
            params = {n: p.data() for n, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(x, *args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            params = {n: p.data() for n, p in self._reg_params.items()}
        return self.hybrid_forward(F, x, *args, **params)

    def _finish_deferred(self, *args):
        """Finish every deferred parameter before the first trace: one
        eager forward in predict mode, unrecorded, initializes them in the
        order an eager call would (and changes no running statistic)."""
        from .. import autograd
        try:
            for p in self.collect_params().values():
                p._check_initialized()
        except DeferredInitializationError:
            with _EagerScope(), autograd.pause(train_mode=False):
                self.forward(*args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _cached_graph(self, n_inputs):
        """(symbol, input names, whether the forward returns a list)."""
        names = ["data%d" % i if i else "data" for i in range(n_inputs)]
        out = self._trace(names)
        is_list = isinstance(out, (list, tuple))
        if is_list:
            from ..symbol import Group
            out = Group(list(out))
        return out, names, is_list

    def _cached_params(self):
        """The parameters a traced Symbol names, by variable name."""
        return {p.name: p for p in self.collect_params().values()}

    def _trace(self, names):
        """Run the block's ``forward`` (through ``Block.__call__``, so past
        a subclass's own ``__call__`` signature) on variables ``names``;
        auto-named nodes count from 0 in the trace, whatever was named
        before it."""
        from .. import symbol as sym_mod
        from ..symbol.symbol import _name_mgr
        saved, _name_mgr._counter = _name_mgr._counter, {}
        try:
            return Block.__call__(self, *[sym_mod.var(n) for n in names])
        finally:
            _name_mgr._counter = saved

    def _trace_symbol(self, n_inputs=1):
        """This block as a Symbol of inputs ``data``, ``data1``, ...:
        calling it with Symbol inputs routes every nested forward through
        the symbol dispatch above."""
        return self._cached_graph(n_inputs)[0]

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` and ``path-%04d.params`` for serving
        (reference: gluon/block.py:870 export): the traced Symbol, and
        every parameter it names keyed ``arg:<name>`` or ``aux:<name>``
        by its place in the Symbol. Either package imports the files
        (``SymbolBlock.imports``, ``model.load_checkpoint``,
        ``serving.Predictor``). Returns the Symbol."""
        from ..ndarray import utils as nd_utils
        sym = self._trace_symbol()
        sym.save("%s-symbol.json" % path)
        args = set(sym.list_arguments())
        aux = set(sym.list_auxiliary_states())
        saved = {}
        for name, p in self.collect_params().items():
            if name in args:
                saved["arg:%s" % name] = p.data()
            elif name in aux:
                saved["aux:%s" % name] = p.data()
        nd_utils.save("%s-%04d.params" % (path, epoch), saved,
                      format="mxnet")
        return sym


class SymbolBlock(HybridBlock):
    """A Symbol as a Block (reference: gluon/block.py:954 SymbolBlock):
    every variable of ``outputs`` that is not one of ``inputs`` is a
    parameter (``grad_req`` "null" for the auxiliary states), with a
    shape completed from the first batch when no file gave it. It always
    runs through a :class:`CachedOp`; called with Symbols (a traced net
    that composes it), it substitutes them for its inputs."""

    def __init__(self, outputs, inputs, params=None):
        super(SymbolBlock, self).__init__(prefix="", params=params)
        from .. import symbol as sym_mod
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(list(outputs))
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self._outputs_sym = outputs
        self._input_names = [i.name if _is_symbol(i) else str(i)
                             for i in inputs]
        aux = set(outputs.list_auxiliary_states())
        for name in outputs.list_arguments() + sorted(aux):
            if name not in self._input_names:
                self._reg_params[name] = self.params.get(
                    name, allow_deferred_init=True,
                    grad_req="null" if name in aux else "write")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of ``symbol_file`` with ``input_names`` as its
        inputs and, with ``param_file``, its parameters set from it on
        ``ctx`` (default ``cuda:0``), each in the file's type (reference:
        gluon/block.py SymbolBlock.imports)."""
        from .. import initializer as init_mod
        from .. import symbol as sym_mod
        from ..ndarray import utils as nd_utils
        sym = sym_mod.load(symbol_file)
        if not isinstance(input_names, (list, tuple)):
            input_names = [input_names]
        block = SymbolBlock(sym, [sym_mod.var(n) for n in input_names])
        if param_file is None:
            return block
        loaded = {(k[4:] if k.startswith(("arg:", "aux:")) else k): v
                  for k, v in nd_utils.load(param_file).items()}
        for name, p in block._reg_params.items():
            if name not in loaded:
                continue
            arr = loaded[name]
            if p._data is None:
                p.dtype = arr.dtype
                p.shape = tuple(arr.shape)
                p.initialize(ctx=ctx, default_init=init_mod.Zero())
            p.set_data(arr)
        return block

    def forward(self, x, *args):
        if _is_symbol(x):
            return self._outputs_sym(
                **dict(zip(self._input_names, (x,) + args)))
        try:
            for p in self._reg_params.values():
                p._check_initialized()
        except DeferredInitializationError:
            self._infer_from_inputs((x,) + args)
        if self._cached_op is None:
            self._cached_op = CachedOp(self)
        if _in_eager_scope():
            return self._cached_op.eager(x, *args)
        return self._cached_op(x, *args)

    def _cached_graph(self, n_inputs):
        if n_inputs != len(self._input_names):
            raise MXNetError("SymbolBlock takes %d inputs (%s), got %d"
                             % (len(self._input_names), self._input_names,
                                n_inputs))
        return (self._outputs_sym, list(self._input_names),
                len(self._outputs_sym._entries) > 1)

    def _cached_params(self):
        return dict(self._reg_params)

    def _infer_from_inputs(self, args):
        """Complete deferred parameters from the inputs' shapes (the
        Symbol's ``infer_shape``); a parameter without an initializer
        gets the default Uniform, on the inputs' device."""
        sym = self._outputs_sym
        arg_shapes, _, aux_shapes = sym.infer_shape(
            **{n: x.shape for n, x in zip(self._input_names, args)})
        for n, s in list(zip(sym.list_arguments(), arg_shapes)) + \
                list(zip(sym.list_auxiliary_states(), aux_shapes)):
            p = self._reg_params.get(n)
            if p is not None and p._data is None:
                p._set_shape_from(s)
                if p._deferred_init is None:
                    p.initialize(ctx=args[0].context)
                else:
                    p._finish_deferred_init()

    def hybrid_forward(self, F, *args, **kwargs):
        raise AttributeError("SymbolBlock has no hybrid_forward")


class CachedOp(object):
    """A hybridized block's forward as its traced Symbol (reference:
    src/imperative/cached_op.cc; the JAX package's CachedOp, whose one
    jitted program per mode is a set of CUDA graphs here).

    The Symbol is traced once per (train/predict mode, number of
    inputs). A call binds the block's parameters and the inputs to the
    Symbol's variables and evaluates it with ``_graph_eval_fn``: on CPU
    tensors directly (:meth:`eager`), on CUDA tensors through the block's
    CUDA graphs (``_graphs.GraphRunner``). Under ``autograd.record()``
    the outputs carry the gradients to the parameters and inputs; in
    training mode the moving statistics of the graph's BatchNorm nodes
    are updated in place, once a call. ``traces`` counts the traces,
    ``runner.captures`` the CUDA-graph captures and ``stat_updates`` the
    calls that updated moving statistics."""

    def __init__(self, block):
        from ._graphs import GraphRunner
        self._block = block
        self._graphs = {}
        self.traces = 0
        self.stat_updates = 0
        self.runner = GraphRunner(block.name or type(block).__name__)

    def _graph(self, n_inputs):
        """(train mode, the trace of this mode): a ``_Trace``."""
        from .. import autograd
        train = autograd.is_training()
        key = (train, n_inputs)
        if key not in self._graphs:
            with autograd._RecordingScope(False, train):
                sym, names, is_list = self._block._cached_graph(n_inputs)
            self._graphs[key] = _Trace(self._block, sym, names, is_list,
                                       train)
            self.traces += 1
        return train, self._graphs[key]

    def __call__(self, *inputs):
        from .. import autograd
        train, tr = self._graph(len(inputs))
        env, aux, xs = tr.bind(inputs)
        if xs[0].device.type != "cuda":
            return self._eval(tr, env, aux, xs)
        outs, stats = self.runner(tr.fn, env, tr.names, xs, aux, train,
                                  autograd.is_recording())
        self.stat_updates += bool(stats)
        return self._wrap(outs, tr.is_list)

    def eager(self, *inputs):
        """The Symbol evaluated directly, on any device (what a call does
        on CPU tensors)."""
        _, tr = self._graph(len(inputs))
        env, aux, xs = tr.bind(inputs)
        return self._eval(tr, env, aux, xs)

    def _eval(self, tr, env, aux, xs):
        import torch
        from .. import autograd
        from ..symbol.symbol import update_moving_stats
        env.update(zip(tr.names, xs))
        with torch.set_grad_enabled(autograd.is_recording()):
            outs, stats = tr.fn(env)
        if stats:
            update_moving_stats(stats, aux)
            self.stat_updates += 1
        return self._wrap(outs, tr.is_list)

    @staticmethod
    def _wrap(outs, is_list):
        from ..ndarray.ndarray import NDArray
        outs = [NDArray(o) for o in outs]
        return outs if is_list else outs[0]


class _Trace(object):
    """One traced Symbol of a CachedOp: its evaluation function, input
    names, and the parameters its other variables name (fixed at the
    trace, so that a call does not walk the block again)."""

    def __init__(self, block, sym, names, is_list, train):
        from ..symbol.symbol import _graph_eval_fn
        self.sym, self.names, self.is_list = sym, names, is_list
        self.fn = _graph_eval_fn(sym, train)
        params = block._cached_params()
        self.params = []
        for n in sym.list_inputs():
            if n in names:
                continue
            if n not in params:
                raise MXNetError("hybridized block %s: no parameter for "
                                 "the variable %r" % (block.name, n))
            self.params.append((n, params[n]))

    def bind(self, inputs):
        """(parameter tensors by name, those of the auxiliary states,
        the input tensors)."""
        from ..ndarray.ndarray import NDArray
        env = {n: p.data()._data for n, p in self.params}
        aux = {n: env[n] for n, p in self.params if p.grad_req == "null"}
        xs = [x._data if isinstance(x, NDArray) else x for x in inputs]
        return env, aux, xs

