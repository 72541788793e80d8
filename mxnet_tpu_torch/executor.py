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
A graph that draws random numbers (Dropout) draws from the port's
generator of the executor's device; ``train_step`` draws once a step,
for its forward and backward alike, and a ``backward`` that has to run
the forward again replays the draws of the last training ``forward``
from the generator state saved then (the JAX package keeps that
forward's key, executor.py:363, :422).
Arguments keep the type they were bound with (int8 weights of a quantized
graph included): inputs staged by ``forward(**kwargs)`` are cast to it.
An input that lies on another device is copied onto the executor's and
counted in :data:`INPUT_COPIES`; one already there (a batch a
``PrefetchingIter`` staged on the card) is bound as it is.

Observability, as the JAX executor: the spans ``executor.forward`` /
``executor.train_step`` under a sampled trace; a cost record per forward
mode (``health.symbol_cost`` at the bound shapes; the fused step counts
three forwards) behind ``forward_cost`` / ``fused_cost`` and the
``executor/mfu`` gauge; and the numerics sentinel
(``MXNET_NUMERICS=step|full``): the loss proxy, the global gradient norm
and the nonfinite count reduced on the device after the gradients
(``torch._foreach_norm``, one multi-tensor launch), copied to the host
behind an event and read one step later (``flush_numerics`` reads the
last), where ``health.check_numerics`` applies the policy.
"""
from __future__ import annotations

import numpy as np
import torch

from . import health as _health
from . import telemetry as _tm
from . import tracing as _tr
from .base import MXNetError
from .context import default_device
from .ndarray.ndarray import NDArray, zeros
from .symbol.symbol import _graph_eval_fn, update_moving_stats

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
        self._rng_state = None  # generator state before the last forward
        self.outputs = []
        self._fwd_cost = {}             # is_train -> cost record
        self._fused_cost_rec = None
        self._numerics_state = {}
        self._pending_sentinel = None
        self._last_step_end = None      # (host time, CUDA event or None)
        self._wall_pending = None       # (event, event) not yet read
        self._deduced = None            # simple_bind's shape deduction

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

    def _run(self, is_train, grad_names, rng_state=None):
        """Evaluate the graph; with ``grad_names``, on leaves that share
        the arguments' storage and record the graph for autograd. A graph
        that draws random numbers draws from the device's generator
        (whose state before the draws is kept in ``_rng_state``), or from
        a private generator set to ``rng_state``."""
        from . import random as _random
        env = self._env()
        leaves = {n: env[n].detach().requires_grad_() for n in grad_names}
        env.update(leaves)
        fn = self._fn(is_train)
        gen = None
        if fn.needs_rng:
            if rng_state is None:
                gen = _random.generator(self._ctx)
                self._rng_state = gen.get_state()
            else:
                gen = torch.Generator(device=self._ctx)
                gen.set_state(rng_state)
        with torch.set_grad_enabled(bool(grad_names)):
            outs, stats = fn(env, gen)
        return leaves, outs, stats

    def _update_aux(self, stats):
        """Moving statistics, in place (``symbol.update_moving_stats``)."""
        update_moving_stats(stats, {n: a._data
                                    for n, a in self.aux_dict.items()})

    def forward(self, is_train=False, **kwargs):
        """Run the graph (reference: GraphExecutor::RunOps). In training
        mode the BatchNorm moving statistics are updated, and when any
        argument wants a gradient the graph is kept for ``backward``."""
        for k, v in kwargs.items():
            self._stage_input(k, v)
        is_train = bool(is_train)
        names = tuple(n for n in self._arg_names
                      if self._grad_req[n] != "null") if is_train else ()
        with _tr.child_span("executor.forward",
                            attrs={"is_train": is_train}):
            leaves, outs, stats = self._run(is_train, names)
        if is_train not in self._fwd_cost:
            self._fwd_cost[is_train] = _health.capture_cost(
                "executor_forward", _health.next_cost_key("fwd"),
                self._count_cost)
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
            leaves, outs, _ = self._run(True, names, self._rng_state)
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
        numerics = _health.numerics_mode()
        with _tr.child_span("executor.train_step"):
            leaves, outs, stats = self._run(True, update_names)
            grads = self._grads(outs, [leaves[n] for n in update_names],
                                self._cotangents(outs, out_grads))
            outs = [o.detach() for o in outs]
            del leaves       # autograd is done: nothing holds the graph
            sentinel = (self._sentinel(grads, outs, numerics)
                        if numerics != "off" else None)
            rule([self.arg_dict[n]._data for n in update_names], grads,
                 [tuple(a._data for a in states[n]) for n in update_names],
                 [hyper[n] for n in update_names])
            self._update_aux(stats)
        self.outputs = [NDArray(o) for o in outs]
        if self._fused_cost_rec is None:
            fwd = _health.capture_cost(
                "fused_step", _health.next_cost_key("step"),
                self._count_cost)
            if fwd is not None:
                # forward + backward: three forwards' FLOPs and bytes
                self._fused_cost_rec = dict(fwd, flops=3 * fwd["flops"],
                                            bytes=3 * fwd["bytes"])
        if _tm._enabled:
            _tm.counter("executor/fused_step_total",
                        "Completed fused train steps").inc()
        self._note_step_wall()
        # the sentinel verdict is read one step behind: step N's vector
        # lands on the host behind an event while step N+1 is queued, so
        # the host never waits for the step in flight (flush_numerics()
        # drains the last one at epoch end)
        pending, self._pending_sentinel = self._pending_sentinel, None
        if sentinel is not None:
            self._pending_sentinel = (sentinel, numerics, update_names)
        if pending is not None:
            self._check_sentinel(*pending)
        return self.outputs

    # -- health --------------------------------------------------------------
    def _count_cost(self):
        """``health.symbol_cost`` of one forward at the bound shapes."""
        shapes, sizes = {}, {}
        for d in (self.arg_dict, self.aux_dict):
            for n, a in d.items():
                shapes[n] = tuple(a._data.shape)
                sizes[n] = a._data.element_size()
        return _health.symbol_cost(self._symbol, shapes, sizes,
                                   self._deduced)

    def _note_step_wall(self):
        """``executor/mfu`` from the interval between consecutive step
        ends: on the card the device time between two events recorded
        after each step (read once the later one has completed, so the
        host never waits), on the host the host clock. Nothing while
        telemetry is off or the step has no cost record."""
        rec = self._fused_cost_rec
        if rec is None or not _tm._enabled:
            self._last_step_end = self._wall_pending = None
            return
        now = _tm.monotonic()
        ev = None
        if self._ctx.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self._ctx))
        last, self._last_step_end = self._last_step_end, (now, ev)
        if last is None:
            return
        if ev is None:
            _health.note_executor_step(rec, now - last[0])
            return
        pend = self._wall_pending
        if pend is not None and pend[1].query():
            _health.note_executor_step(
                rec, pend[0].elapsed_time(pend[1]) / 1e3)
            pend = None
        if pend is None:
            self._wall_pending = (last[1], ev)

    def _sentinel(self, grads, outs, numerics):
        """The step's packed sentinel on the device: [loss, grad norm,
        nonfinite (, per-parameter norms, per-parameter nonfinite
        counts)], copied to the host behind an event on the card."""
        f32 = torch.float32
        flo = [g for g in grads if g.is_floating_point()]
        it = iter(torch._foreach_norm(flo, 2, dtype=f32) if flo else ())
        dev = outs[0].device
        zero = torch.zeros((), dtype=f32, device=dev)
        per = [next(it) if g.is_floating_point() else zero for g in grads]
        sq = torch.stack(per).square() if per else zero.reshape(1)
        loss = outs[0].float().mean()
        if numerics == "full":
            nf = torch.stack([(~torch.isfinite(g)).sum().to(f32)
                              if g.is_floating_point() else zero
                              for g in grads])
            bad = nf.sum()
        else:
            # a nonfinite element makes its parameter's norm nonfinite:
            # the figure counts the affected parameters
            bad = (~torch.isfinite(sq)).sum().to(f32)
        head = torch.stack([loss, sq.sum().sqrt(), bad])
        vec = head if numerics == "step" else torch.cat(
            [head, sq.sqrt(), nf])
        if vec.device.type != "cuda":
            return (vec, None)
        host = torch.empty(vec.shape, dtype=f32, pin_memory=True)
        host.copy_(vec, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(vec.device))
        return (host, ev)

    def _check_sentinel(self, sentinel, numerics, update_names):
        """Read one step's sentinel (waiting only for that step) and
        apply the numerics policy."""
        vec, ev = sentinel
        if ev is not None:
            ev.synchronize()
        vals = vec.tolist()
        report = {"loss": float(vals[0]), "grad_norm": float(vals[1]),
                  "nonfinite": int(vals[2])}
        if numerics == "full":
            p = len(update_names)
            report["per_param"] = {
                n: {"norm": float(vals[3 + i]),
                    "nonfinite": int(vals[3 + p + i])}
                for i, n in enumerate(update_names)}
        _health.check_numerics(report, state=self._numerics_state)

    def flush_numerics(self):
        """Read the deferred sentinel of the last fused step (applies the
        policy to a trip on a run's final step); ``Module.fit`` calls it
        at each epoch end."""
        pending, self._pending_sentinel = self._pending_sentinel, None
        if pending is not None:
            self._check_sentinel(*pending)

    def fused_cost(self):
        """Cost record of the fused step (three forwards), or None."""
        return self._fused_cost_rec

    def forward_cost(self, is_train=False):
        """Cost record of the forward in this mode (the serve engine
        prices its bucket batches with it), counted on first use."""
        is_train = bool(is_train)
        if is_train not in self._fwd_cost:
            self._fwd_cost[is_train] = _health.capture_cost(
                "executor_forward", _health.next_cost_key("fwd"),
                self._count_cost)
        return self._fwd_cost[is_train]

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
