"""Symbolic executor.

Counterpart of the JAX package's ``executor.py``. The bound graph runs
eagerly on the executor's device (``cuda:0`` unless a CPU context is
passed): ``forward`` evaluates it, ``backward`` takes
``torch.autograd.grad`` of the outputs with ones (or the given head
gradients) as cotangents, and ``train_step`` is the fused step of
``Module.fit``: the graph, ``torch.autograd.grad``, then ONE fused-update
launch over every parameter (the optimizer's rule, in place), then the
in-place update of the BatchNorm moving statistics. Where the JAX
package donates the weight and state buffers to one XLA program, here
the kernel writes them in place after autograd has returned and the
graph is gone, so no saved tensor of the graph sees the new values.
Arguments keep the type they were bound with (int8 weights of a quantized
graph included): inputs staged by ``forward(**kwargs)`` are cast to it.
An input that lies on another device is copied onto the executor's and
counted in :data:`INPUT_COPIES`; one already there (a batch a
``PrefetchingIter`` staged on the card) is bound as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import default_device
from .ndarray.ndarray import NDArray, zeros
from .symbol.symbol import _graph_eval_fn

__all__ = ["Executor", "INPUT_COPIES"]

# inputs forward / train_step copied from another device onto the
# executor's since the last reset (read by chip_smoke.py: a staged batch
# arrives on the card and adds nothing)
INPUT_COPIES = {"count": 0}


class Executor(object):
    """Bound computation graph (reference: executor.py Executor)."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self._ctx = default_device(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        if isinstance(args, dict):
            missing = [n for n in arg_names if n not in args]
            if missing:
                raise MXNetError("bind missing arguments: %s" % missing)
            self.arg_arrays = [args[n] for n in arg_names]
        else:
            if len(args) != len(arg_names):
                raise MXNetError("bind expects %d args, got %d"
                                 % (len(arg_names), len(args)))
            self.arg_arrays = list(args)
        self.arg_dict = dict(zip(arg_names, self.arg_arrays))
        aux_states = aux_states or []
        if isinstance(aux_states, dict):
            self.aux_arrays = [aux_states[n] for n in aux_names]
        else:
            self.aux_arrays = list(aux_states)
        if len(self.aux_arrays) != len(aux_names):
            raise MXNetError("bind expects %d aux states, got %d"
                             % (len(aux_names), len(self.aux_arrays)))
        self.aux_dict = dict(zip(aux_names, self.aux_arrays))
        if isinstance(grad_req, str):
            reqs = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            reqs = dict(zip(arg_names, grad_req))
        else:
            reqs = {n: grad_req.get(n, "null") for n in arg_names}
        self._grad_req = reqs
        if args_grad is None:
            self.grad_arrays = [
                zeros(a.shape, ctx=self._ctx, dtype=a.dtype)
                if reqs[n] != "null" else None
                for n, a in zip(arg_names, self.arg_arrays)]
        elif isinstance(args_grad, dict):
            self.grad_arrays = [args_grad.get(n) for n in arg_names]
        else:
            self.grad_arrays = list(args_grad)
        self.grad_dict = dict(zip(arg_names, self.grad_arrays))
        self._arg_names = arg_names
        self._aux_names = aux_names
        self._fns = {}
        self._graph = None      # (names, leaves, outputs) for backward
        self.outputs = []

    # -- execution ---------------------------------------------------------
    def _fn(self, is_train):
        fn = self._fns.get(is_train)
        if fn is None:
            fn = self._fns[is_train] = _graph_eval_fn(self._symbol, is_train)
        return fn

    def _env(self):
        env = {n: a._data for n, a in zip(self._arg_names, self.arg_arrays)}
        env.update({n: a._data
                    for n, a in zip(self._aux_names, self.aux_arrays)})
        return env

    def _stage_input(self, name, value):
        """Bind one input (NDArray or host array) on this executor's
        device, in the bound argument's dtype."""
        if name not in self.arg_dict:
            raise MXNetError("unknown forward argument %r" % name)
        target = self.arg_dict[name]
        t = value._data if isinstance(value, NDArray) \
            else torch.as_tensor(np.asarray(value))
        if t.device != self._ctx:
            INPUT_COPIES["count"] += 1
        target._set_data(t.to(self._ctx, target._data.dtype))

    def _run(self, is_train, grad_names):
        """Evaluate the graph; with ``grad_names``, on leaves that share
        the arguments' storage and record the graph for autograd."""
        env = self._env()
        leaves = {n: env[n].detach().requires_grad_() for n in grad_names}
        env.update(leaves)
        with torch.set_grad_enabled(bool(grad_names)):
            outs, stats = self._fn(is_train)(env)
        return leaves, outs, stats

    def _update_aux(self, stats):
        """Moving statistics, in place, grouped by momentum:
        ``old = momentum * old + (1 - momentum) * batch``."""
        groups = {}
        for mm, mv, mom, mean, var in stats:
            olds, news = groups.setdefault(mom, ([], []))
            olds += [self.aux_dict[mm]._data, self.aux_dict[mv]._data]
            news += [mean, var]
        with torch.no_grad():
            for mom, (olds, news) in groups.items():
                torch._foreach_mul_(olds, mom)
                torch._foreach_add_(olds, torch._foreach_mul(news, 1 - mom))

    def forward(self, is_train=False, **kwargs):
        """Run the graph (reference: GraphExecutor::RunOps). In training
        mode the BatchNorm moving statistics are updated, and when any
        argument wants a gradient the graph is kept for ``backward``."""
        for k, v in kwargs.items():
            self._stage_input(k, v)
        is_train = bool(is_train)
        names = tuple(n for n in self._arg_names
                      if self._grad_req[n] != "null") if is_train else ()
        leaves, outs, stats = self._run(is_train, names)
        self._graph = (names, leaves, outs) if names else None
        self._update_aux(stats)
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def _cotangents(self, outs, out_grads):
        if out_grads is None:
            return [torch.ones_like(o) for o in outs]
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        return [(g._data if isinstance(g, NDArray)
                 else torch.as_tensor(np.asarray(g))).to(o.device, o.dtype)
                for g, o in zip(out_grads, outs)]

    @staticmethod
    def _grads(outs, leaves, cts):
        grads = torch.autograd.grad(outs, leaves, cts, allow_unused=True)
        # an input the outputs do not reach (fix_gamma's gamma) gets zeros
        return [torch.zeros_like(x) if g is None else g
                for g, x in zip(grads, leaves)]

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the outputs w.r.t. the bound arguments, written
        or accumulated per grad_req. Uses the graph of the last training
        forward, or runs the forward again (moving statistics untouched,
        as the JAX package's backward recomputes it)."""
        if not self.outputs:
            raise MXNetError("call forward(is_train=True) before backward")
        names = tuple(n for n in self._arg_names
                      if self._grad_req[n] != "null")
        if not names:
            return
        graph, self._graph = self._graph, None
        if graph is None or graph[0] != names:
            leaves, outs, _ = self._run(True, names)
        else:
            _, leaves, outs = graph
        grads = self._grads(outs, [leaves[n] for n in names],
                            self._cotangents(outs, out_grads))
        for n, g in zip(names, grads):
            tgt = self.grad_dict[n]
            if tgt is None:
                continue
            tgt._set_data(tgt._data + g if self._grad_req[n] == "add"
                          else g)

    def train_step(self, rule, update_names, states, hyper, feed=None,
                   out_grads=None):
        """One training step: the graph, its gradients, the optimizer's
        fused rule over every parameter in ``update_names`` (one call,
        one kernel launch on the card), the moving statistics.

        rule : ``rule(weights, grads, states, hypers)`` over lists of
            tensors, in place (``Optimizer.fused_rule()``).
        update_names : the arguments to update; each bound with
            grad_req='write'.
        states : name -> tuple of NDArray state buffers, updated in place.
        hyper : name -> the optimizer's ``fused_hyper`` dict.
        feed : input name -> NDArray / host array, staged like
            ``forward(**kwargs)``.
        out_grads : head gradients (default ones, as ``backward``)."""
        update_names = tuple(update_names)
        for n in update_names:
            if self._grad_req.get(n) != "write":
                raise MXNetError(
                    "train_step requires grad_req='write' for %r (got %r)"
                    % (n, self._grad_req.get(n)))
        for k, v in (feed or {}).items():
            self._stage_input(k, v)
        self._graph = None
        leaves, outs, stats = self._run(True, update_names)
        grads = self._grads(outs, [leaves[n] for n in update_names],
                            self._cotangents(outs, out_grads))
        outs = [o.detach() for o in outs]
        del leaves           # autograd is done: nothing holds the graph
        rule([self.arg_dict[n]._data for n in update_names], grads,
             [tuple(a._data for a in states[n]) for n in update_names],
             [hyper[n] for n in update_names])
        self._update_aux(stats)
        self.outputs = [NDArray(o) for o in outs]
        return self.outputs

    # -- parameter management ---------------------------------------------
    def alias_args(self, other, names):
        """Share argument / auxiliary NDArray objects with executor
        ``other`` (the reference's shared-executor memory): both then read
        the same tensors, as the bucket ladder of ``Predictor.reshape``
        does with the weights."""
        for n in names:
            if n in other.arg_dict:
                shared = other.arg_dict[n]
                self.arg_arrays[self._arg_names.index(n)] = shared
                self.arg_dict[n] = shared
            elif n in other.aux_dict:
                shared = other.aux_dict[n]
                self.aux_arrays[self._aux_names.index(n)] = shared
                self.aux_dict[n] = shared

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arrays, in place (reference:
        executor.py copy_params_from)."""
        for src, dst_dict, kind in ((arg_params, self.arg_dict, "arguments"),
                                    (aux_params or {}, self.aux_dict,
                                     "auxiliary states")):
            for name, array in src.items():
                if name in dst_dict:
                    _copy_into(dst_dict[name], array, name)
                elif not allow_extra_params:
                    raise ValueError("Find name \"%s\" that is not in the %s"
                                     % (name, kind))

def _copy_into(dst, src, name):
    """``dst[:] = src`` keeping ``dst``'s tensor (and so its storage)."""
    if tuple(src.shape) != dst.shape:
        raise MXNetError("%s: shape %s, bound %s" % (name, tuple(src.shape),
                                                     dst.shape))
    data = src._data if isinstance(src, NDArray) \
        else torch.as_tensor(np.asarray(src))
    with torch.no_grad():
        dst._data.copy_(data)
