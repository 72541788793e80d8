"""CUDA graphs of a hybridized block's traced Symbol.

A ``CachedOp`` (``block.py``) evaluates its block's Symbol with
``symbol._graph_eval_fn``. On CUDA tensors it does so through this
module: the evaluation is captured into CUDA graphs once per key and
replayed on every later call with that key, one host launch where the
eager forward takes hundreds. This is the port's counterpart of the JAX
package's one jitted program per mode (``CachedOp._ensure_mode`` and
jit's shape cache); ``torch.cuda.make_graphed_callables`` is the model
for the autograd side.

* **Key**: train mode, recording, the inputs' shapes, types, devices
  and whether they want gradients, each parameter's storage
  (``data_ptr``, shape, type) and the device's random generator. New
  storage (``initialize(force_reinit=True)``, ``cast``, a deferred
  ``set_data``) is a new key, and the captures of the old storage are
  dropped; ``set_data`` in place keeps the key, and the graphs read the
  new values.
* **Capture** (``_Capture``): a static buffer per input; a warm-up on a
  side stream first (cuBLAS / cuDNN workspaces, the kernel libraries'
  ``_build.load``, a backward when recording), which changes no state:
  its moving-statistics update goes to copies. Then the forward graph:
  the evaluation and, in training mode, the BatchNorm moving-statistics
  update in place (``new = momentum * old + (1 - momentum) * batch``,
  once a call). Under ``autograd.record()`` also the backward graph (the
  gradients of the outputs with respect to the parameters and inputs
  that want them), in the same memory pool. The port's generator of the
  device is registered with both, so an op that draws random numbers
  draws new ones on every replay. A capture that fails raises
  :class:`MXNetError` naming the block and the error; nothing is then
  run eagerly in its place.
* **Replay**: the inputs are copied into the static buffers and the
  forward graph replays; outputs are cloned (the next replay overwrites
  the graph's own). Recording, the replay sits in a
  ``torch.autograd.Function`` whose backward copies the incoming
  gradients into the graph's static buffers, replays the backward graph
  and returns a copy (the graph gathers the gradients into one flat
  buffer, and each is a view of one copy of it a replay), so no leaf's
  gradient aliases a static buffer. A
  second backward without ``retain_graph`` raises, as an eager one does.
  A capture whose forward was replayed under ``record()`` stays busy
  until its backward runs (or its autograd graph is freed), and a
  further recorded call takes another capture of the same key, so two
  forwards before one backward each keep their own activations.
* **Launch counts**: what a capture's kernel wrappers counted is taken
  back and added again on every replay (``ops/cuda/_launches.py``).

The optimizer's update stays outside: ``Trainer.step`` is no part of
the graphs (the fused update kernel copies its table of pointers and
hyperparameters from pinned host memory at every launch; a captured
copy would replay a stale host buffer).
"""
from __future__ import annotations

import weakref

import torch

from ..base import MXNetError
from ..symbol.symbol import update_moving_stats

__all__ = ["GraphRunner"]


class _Capture(object):
    """One captured evaluation: static inputs, the forward graph and,
    when recording, the backward graph, in one private memory pool."""

    def __init__(self, label, fn, env, in_names, xs, aux, record):
        from .. import random as _random
        from ..ops.cuda import _launches
        self.busy = False
        self.generation = 0
        dev = xs[0].device
        self.static_in = [torch.empty_like(x) for x in xs]
        with torch.no_grad():
            for s, x in zip(self.static_in, xs):
                s.copy_(x)
        # the differentiable inputs: parameters, then inputs, wanting grad
        self.diff_params = [n for n, t in env.items()
                            if record and t.requires_grad]
        wants = set(self.diff_params)
        self.diff_in = [i for i, x in enumerate(xs)
                        if record and x.requires_grad]
        self.record = bool(self.diff_params or self.diff_in)

        def leaves():
            """The graph's view of the parameters and static inputs: new
            leaves on the same storage, so that their autograd nodes are
            made on the stream that uses them (a parameter's own node
            lives as long as the parameter, on the stream of its first
            use)."""
            senv = {n: t.detach().requires_grad_() if n in wants else t
                    for n, t in env.items()}
            ins = [s.detach().requires_grad_() if i in self.diff_in else s
                   for i, s in enumerate(self.static_in)]
            senv.update(zip(in_names, ins))
            return senv, [senv[n] for n in self.diff_params] + \
                [ins[i] for i in self.diff_in]

        # warm-up on a side stream: the same work as the graphs, with the
        # moving-statistics update applied to copies
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(side):
                senv, wrt = leaves()
                with torch.set_grad_enabled(self.record):
                    outs, stats = fn(senv)
                if stats:
                    update_moving_stats(stats, {
                        n: aux[n].clone() for st in stats for n in st[:2]})
                diff = [o for o in outs if o.requires_grad]
                if self.record and diff:
                    torch.autograd.grad(diff, wrt, [torch.ones_like(o)
                                                    for o in diff],
                                        allow_unused=True)
                del outs, stats, diff, senv, wrt
        except Exception as e:
            raise MXNetError("hybridized block %s: the warm-up before the "
                             "CUDA graph capture failed: %s" % (label, e)) \
                from e
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        senv, wrt = leaves()

        gen = _random.generator(dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.fwd = torch.cuda.CUDAGraph()
        self.bwd = None
        self.fwd_launches = self.bwd_launches = {}
        before = _launches.snapshot()
        try:
            outs, stats = self._capture(label, "forward", self.fwd, gen,
                                        lambda: self._fwd_body(
                                            fn, senv, aux, self.record))
            self.fwd_launches = _launches.delta(before, _launches.snapshot())
            self.stats = len(stats)
            self.outs = list(outs)
            self.diff_outs = [i for i, o in enumerate(self.outs)
                              if o.requires_grad]
            self.record = self.record and bool(self.diff_outs)
            if self.record:
                self.static_gout = [torch.zeros_like(self.outs[i])
                                    for i in self.diff_outs]
                self.bwd = torch.cuda.CUDAGraph()
                mid = _launches.snapshot()
                self._capture(label, "backward", self.bwd, gen,
                              lambda: self._bwd_body(wrt))
                self.bwd_launches = _launches.delta(mid,
                                                    _launches.snapshot())
        finally:
            # a capture launches nothing: take its counts back
            _launches.add(_launches.delta(before, _launches.snapshot()), -1)
        self.outs = [o.detach() for o in self.outs]
        self._gen = gen         # the key holds its id

    def _capture(self, label, what, graph, gen, body):
        """``body()`` captured into ``graph`` in this capture's pool; a
        failure raises MXNetError with the first error it met (ending a
        broken capture raises another, which says less)."""
        first = []
        try:
            graph.register_generator_state(gen)
            with torch.cuda.graph(graph, pool=self.pool):
                try:
                    return body()
                except Exception as e:
                    first.append(e)
                    raise
        except Exception as e:
            err = first[0] if first else e
            raise MXNetError("hybridized block %s: CUDA graph capture of its "
                             "%s failed (nothing was run in its place): %s: "
                             "%s" % (label, what, type(err).__name__, err)) \
                from err

    @staticmethod
    def _fwd_body(fn, senv, aux, record):
        with torch.set_grad_enabled(record):
            outs, stats = fn(senv)
        if stats:
            update_moving_stats(stats, aux)
        return outs, stats

    def _bwd_body(self, wrt):
        """The gradients of the differentiable outputs, gathered into one
        flat buffer (one copy a replay hands them out; each gradient is a
        view of it)."""
        gin = torch.autograd.grad([self.outs[i] for i in self.diff_outs],
                                  wrt, self.static_gout, allow_unused=True)
        self.gin_shapes = [None if g is None else g.shape for g in gin]
        present = [g for g in gin if g is not None]
        self.flat = torch.cat([g.reshape(-1) for g in present]) \
            if present and len({g.dtype for g in present}) == 1 else None
        self.static_gin = gin

    def grads(self):
        """Copies of the last backward replay's gradients: views of one
        new buffer, or one copy each when their types differ."""
        if self.flat is None:
            return [None if g is None else g.clone() for g in self.static_gin]
        flat = self.flat.clone()
        out, at = [], 0
        for shape in self.gin_shapes:
            if shape is None:
                out.append(None)
                continue
            n = shape.numel()
            out.append(flat[at:at + n].view(shape))
            at += n
        return out

    def _forward(self, xs):
        from ..ops.cuda import _launches
        with torch.no_grad():
            for s, x in zip(self.static_in, xs):
                s.copy_(x)
        self.fwd.replay()
        _launches.add(self.fwd_launches)
        return tuple(o.clone() for o in self.outs)

    def run(self, env, xs):
        """Outputs of one replay; recording, connected to the autograd
        graph of ``env``'s parameters and ``xs``."""
        if not self.record:
            return self._forward(xs)
        wrt = [env[n] for n in self.diff_params] + \
            [xs[i] for i in self.diff_in]
        return _Graphed.apply(self, xs, *wrt)

    def release(self, generation):
        if self.generation == generation:
            self.busy = False


class _Token(object):
    """Lives as long as one recorded replay's autograd node."""


class _Graphed(torch.autograd.Function):
    """A recorded replay: the forward graph forward, the backward graph
    backward."""

    @staticmethod
    def forward(ctx, cap, xs, *wrt):
        outs = cap._forward(xs)
        cap.generation += 1
        cap.busy = True
        ctx.cap, ctx.generation = cap, cap.generation
        ctx.token = _Token()
        weakref.finalize(ctx.token, cap.release, cap.generation)
        # a saved tensor makes a second backward without retain_graph
        # raise, as it does through an eager graph
        ctx.save_for_backward(outs[cap.diff_outs[0]])
        ctx.mark_non_differentiable(*[o for i, o in enumerate(outs)
                                      if i not in cap.diff_outs])
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        from ..ops.cuda import _launches
        ctx.saved_tensors       # raises after the graph was freed
        cap = ctx.cap
        if cap.generation != ctx.generation:
            raise MXNetError(
                "backward through a hybridized block's CUDA graph whose "
                "activations a later call overwrote (a retained graph "
                "differentiated again after another recorded call)")
        with torch.no_grad():
            for s, i in zip(cap.static_gout, cap.diff_outs):
                if grads[i] is None:
                    s.zero_()
                else:
                    s.copy_(grads[i])
        cap.bwd.replay()
        _launches.add(cap.bwd_launches)
        cap.busy = False
        return (None, None) + tuple(cap.grads())


class GraphRunner(object):
    """The CUDA graphs of one CachedOp, by key; ``captures`` counts the
    captures made."""

    def __init__(self, label):
        self._label = label
        self._sets = {}
        self.captures = 0

    def __call__(self, fn, env, in_names, xs, aux, train, record):
        """(outputs of a replay, the number of BatchNorm nodes whose
        moving statistics it updated)."""
        from .. import random as _random
        dev = xs[0].device
        # a parameter's shape and type stay with its storage (cast and
        # a new shape come with new storage)
        storage = tuple(t.data_ptr() for t in env.values())
        key = (bool(train), bool(record),
               tuple((tuple(x.shape), x.dtype, str(x.device),
                      record and x.requires_grad) for x in xs),
               storage, tuple(record and t.requires_grad
                              for t in env.values()),
               id(_random.generator(dev)))
        # captures of storage that is gone would hold it alive: drop them
        for k in [k for k in self._sets if k[3] != storage]:
            del self._sets[k]
        caps = self._sets.setdefault(key, [])
        cap = next((c for c in caps if not c.busy), None)
        if cap is None:
            cap = _Capture(self._label, fn, env, in_names, xs, aux, record)
            caps.append(cap)
            self.captures += 1
        return cap.run(env, xs), cap.stats
