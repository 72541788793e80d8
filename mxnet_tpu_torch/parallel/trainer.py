"""Fused training steps over a device mesh.

Counterpart of the JAX package's ``parallel/trainer.py``: one step of a
Symbol's forward, backward and SGD-momentum update, ``make_train_step``,
and ``ShardedTrainer``, which initializes the state, stages batches and
runs steps. The JAX step is one jitted program whose state buffers are
donated; here the step evaluates the graph with
``symbol._graph_eval_fn``, takes ``torch.autograd.grad`` of every output
with ones as head gradients, and updates the parameters, momenta and
BatchNorm moving statistics in place, with no host sync. ``run_steps``,
the JAX package's ``lax.scan`` over k staged batches, runs the k steps
as ONE CUDA graph on the card, captured once per (k, shapes, types,
state storage, random-key mode) and replayed on the static stack that
``stage_many`` writes; on CPU tensors it is a loop of k steps.

The update is the JAX trainer's own rule, ``g = grad + wd * p; m =
momentum * m + g; p = p - lr * m`` (with ``momentum`` 0, ``m = g`` and
the state untouched), in that order with ``torch._foreach_*`` ops. It is
not the optimizer's ``sgd_fused_update`` rule (``mom = momentum * mom -
lr * (g + wd * w)``), which keeps another state and rounds otherwise; the
JAX package computes this one in XLA, with no Pallas kernel.

Only a one-device mesh is ported (``parallel/mesh.py``): a dp or tp
axis above 1 raises naming ROADMAP A13 / A15.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..base import MXNetError
from ..io import mix_seed
from ..symbol.symbol import _graph_eval_fn, update_moving_stats
from .mesh import check_axis

__all__ = ["make_train_step", "ShardedTrainer", "fold_in"]


def fold_in(key, i):
    """The seed of step ``i`` of a ``run_steps`` call given the int seed
    ``key`` (the analog of ``jax.random.fold_in``)."""
    return mix_seed(key, i)


def _generator(key, device):
    """The generator a step draws from: ``key`` itself (a
    ``torch.Generator``), a new one seeded with the int ``key``, or for
    None the port's generator of ``device``."""
    if key is None:
        from .. import random as _random
        return _random.generator(device)
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def _loss_and_probs(outputs, label):
    """``-mean(log(max(p[label], 1e-10)))`` over output 0's
    probabilities, in float32 (the JAX package's metric-side CE; the
    gradient comes from the output op's own backward)."""
    picked = outputs[0].gather(1, label.long()[:, None])[:, 0]
    return -torch.log(torch.clamp(picked, min=1e-10)).mean()


def _sgd_momentum(ps, grads, ms, lr, momentum, wd):
    """The JAX trainer's update, in place over lists of tensors: ``g =
    grad + wd * p; m = momentum * m + g; p = p - lr * m``; with
    ``momentum`` 0, ``p = p - lr * g`` and ``ms`` untouched."""
    with torch.no_grad():
        if wd:
            g = torch._foreach_mul(ps, wd)
            torch._foreach_add_(g, grads)
        else:
            g = list(grads)
        if momentum > 0.0:
            torch._foreach_mul_(ms, momentum)
            torch._foreach_add_(ms, g)
            g = ms
        torch._foreach_sub_(ps, torch._foreach_mul(g, lr))


def make_train_step(symbol, data_name="data", label_name="softmax_label",
                    lr=0.05, momentum=0.9, wd=0.0, compute_dtype=None):
    """``step(params, moms, aux, data, label, key=None) -> (params, moms,
    aux, loss)``: one training step over name -> tensor dicts, updated in
    place and returned with the loss (a float32 0-d tensor on the
    device). Returns ``(step, param_names)``.

    Every output's head gradient is ones (the loss heads' own backward
    carries the loss gradient); a parameter the outputs do not reach
    (``fix_gamma``'s gamma) gets a zero gradient, so weight decay still
    moves it. ``compute_dtype="bfloat16"``: floating parameters and the
    data are cast to bf16 for the forward (the label is not, and the
    auxiliary states stay float32), the outputs come back float32, and
    the gradients reach the float32 master weights through the casts.
    The moving statistics take the batch ones, float32 whatever the
    compute type (``symbol.update_moving_stats``). ``key``: a
    ``torch.Generator`` or an int seed for the graph's draws (Dropout);
    None draws from the port's generator of the data's device."""
    cdt = torch.bfloat16 if compute_dtype in ("bfloat16", torch.bfloat16) \
        else None
    if compute_dtype is not None and cdt is None:
        raise MXNetError("compute_dtype %r: the port's trainer computes in "
                         "float32 or bfloat16" % (compute_dtype,))
    fn = _graph_eval_fn(symbol, is_train=True)
    param_names = [n for n in symbol.list_arguments()
                   if n not in (data_name, label_name)]
    lr, momentum, wd = float(lr), float(momentum), float(wd)

    def step(params, moms, aux, data, label, key=None):
        gen = _generator(key, data.device) if fn.needs_rng else None
        leaves = [params[n].detach().requires_grad_() for n in param_names]
        with torch.enable_grad():
            env = {n: p.to(cdt) if cdt is not None and p.is_floating_point()
                   else p for n, p in zip(param_names, leaves)}
            env.update(aux)
            env[data_name] = data.to(cdt) if cdt is not None else data
            env[label_name] = label
            outs, stats = fn(env, gen)
            outs = [o.float() for o in outs]
        diff = [o for o in outs if o.requires_grad]
        grads = torch.autograd.grad(diff, leaves,
                                    [torch.ones_like(o) for o in diff],
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        with torch.no_grad():
            loss = _loss_and_probs(outs, label)
        del env, outs, diff, leaves
        _sgd_momentum([params[n] for n in param_names], grads,
                      [moms[n] for n in param_names], lr, momentum, wd)
        update_moving_stats(stats, aux)
        return params, moms, aux, loss

    step.needs_rng = fn.needs_rng
    return step, param_names


class _Graph(object):
    """k steps captured as one CUDA graph over the trainer's state and a
    staged stack. ``gens``: None (the graph draws nothing) or the
    generator of each step, registered with the graph so that every
    replay draws anew."""

    def __init__(self, step, params, moms, aux, data, label, gens):
        dev = data.device
        k = data.shape[0]
        self.gens = gens
        gens = gens or [None] * k
        # warm-up on a side stream (cuDNN / cuBLAS workspaces and plans),
        # over copies of the state and from a scratch generator: the
        # state and the registered generators stay as they are
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            scratch = None if gens[0] is None else torch.Generator(device=dev)
            step(*[{n: t.clone() for n, t in d.items()}
                   for d in (params, moms, aux)], data[0], label[0], scratch)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.graph = torch.cuda.CUDAGraph()
        for g in {id(g): g for g in gens if g is not None}.values():
            self.graph.register_generator_state(g)
        first = []
        try:
            with torch.cuda.graph(self.graph):
                try:
                    for i in range(k):
                        loss = step(params, moms, aux, data[i], label[i],
                                    gens[i])[3]
                    self.loss = loss
                except Exception as e:
                    first.append(e)
                    raise
        except Exception as e:
            # the first error says what failed; ending a broken capture
            # raises another
            err = first[0] if first else e
            raise MXNetError("run_steps: the CUDA graph capture of %d steps "
                             "failed (nothing was run in its place): %s: %s"
                             % (k, type(err).__name__, err)) from err


class ShardedTrainer(object):
    """Trainer over a device mesh (the JAX package's data- and
    tensor-parallel trainer; the port runs it on one device).

    ``init`` makes the state, ``stage`` / ``stage_many`` put batches on
    the mesh's device, ``step`` runs one step and ``run_steps`` k steps
    over a staged stack. The state is three name -> tensor dicts
    (parameters, momenta, auxiliary states) that the steps update in
    place and return, as the JAX trainer donates them. ``dp_axis``,
    ``tp_axis`` and ``tp_min_size`` are the JAX trainer's; at one device
    they shard nothing (a tp axis above 1 raises naming A15)."""

    def __init__(self, symbol, mesh, data_name="data",
                 label_name="softmax_label", lr=0.05, momentum=0.9, wd=0.0,
                 dp_axis="dp", tp_axis=None, tp_min_size=2048,
                 compute_dtype=None):
        for name, size in mesh.shape.items():
            check_axis(name, size)
        if tp_axis is not None:
            check_axis(tp_axis, mesh.shape.get(tp_axis, 1))
        self._symbol = symbol
        self._device = mesh.device
        self._data_name = data_name
        self._label_name = label_name
        self._step_raw, self._param_names = make_train_step(
            symbol, data_name, label_name, lr=lr, momentum=momentum, wd=wd,
            compute_dtype=compute_dtype)
        self._aux_names = symbol.list_auxiliary_states()
        self._stacks = {}       # (data shape, label shape) -> static stack
        self._graphs = {}       # key -> _Graph
        self.captures = 0

    # -- state -------------------------------------------------------------
    def init(self, data_shape, label_shape, initializer=None, seed=0):
        """(params, moms, aux) on the mesh's device: parameter shapes from
        ``infer_shape``, values from ``initializer`` (default
        ``Xavier(magnitude=2.0)``, drawing from the port's generator of
        the device: seed it with ``mx.random.seed``; ``seed`` is accepted
        for the JAX package's signature), zero momenta, auxiliary states
        ones for names ending in ``_var`` and zeros otherwise."""
        from ..initializer import InitDesc, Xavier
        from ..ndarray.ndarray import zeros
        initializer = initializer or Xavier(magnitude=2.0)
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(
            **{self._data_name: data_shape, self._label_name: label_shape})
        shape_of = dict(zip(self._symbol.list_arguments(), arg_shapes))
        params = {}
        for n in self._param_names:
            arr = zeros(shape_of[n], ctx=self._device)
            initializer(InitDesc(n), arr)
            params[n] = arr._data
        moms = {n: torch.zeros_like(p) for n, p in params.items()}
        aux = {n: (torch.ones if n.endswith("_var") else torch.zeros)(
            tuple(shp), dtype=torch.float32, device=self._device)
            for n, shp in zip(self._aux_names, aux_shapes)}
        return params, moms, aux

    # -- staging -----------------------------------------------------------
    def _to_device(self, x):
        """``x`` as float32 on the device: a tensor already there as it
        is (cast if need be), a host array by one pinned, non-blocking
        copy."""
        t = self._source(x)
        return t.to(self._device, non_blocking=True)

    def _source(self, x):
        """``x`` as a float32 tensor to copy from: on the device if it is
        there already, else on the host (pinned when the device is a
        card)."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        t = t.to(torch.float32)
        if self._device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t

    def stage(self, data, label):
        """One batch on the device (one copy each; no copy for tensors
        already there). ``step`` stages what it is given the same way."""
        return self._to_device(data), self._to_device(label)

    @staticmethod
    def _restage(static, src):
        """Write a new stack into the static one, in place: the captured
        graphs read its storage."""
        static.copy_(src, non_blocking=True)

    def stage_many(self, data, label):
        """``k`` batches stacked on a leading axis, ``data`` (k, batch,
        ...) and ``label`` (k, batch), for :meth:`run_steps`. On the card
        they are written into the trainer's static stack of that shape
        (the buffers its CUDA graphs read), which is returned: a later
        ``stage_many`` of the same shape overwrites it."""
        if self._device.type != "cuda":
            return self._to_device(data), self._to_device(label)
        srcs = [self._source(x) for x in (data, label)]
        key = tuple(tuple(s.shape) for s in srcs)
        stack = self._stacks.get(key)
        if stack is None:
            stack = self._stacks[key] = tuple(
                torch.empty(s.shape, dtype=torch.float32, device=self._device)
                for s in srcs)
        for static, src in zip(stack, srcs):
            if src is not static:
                self._restage(static, src)
        return stack

    # -- steps -------------------------------------------------------------
    def step(self, params, moms, aux, data, label, key=None):
        """One training step; ``data`` / ``label`` host arrays or tensors
        (staged unless already on the device). Returns (params, moms,
        aux, loss), the state updated in place."""
        data, label = self.stage(data, label)
        return self._step_raw(params, moms, aux, data, label, key)

    def run_steps(self, params, moms, aux, data, label, key=None):
        """``k`` steps over a stack staged by :meth:`stage_many` (``data``
        (k, batch, ...)); returns (params, moms, aux, the last step's
        loss). On the card the k steps are one CUDA graph replay. Step i
        draws from a generator seeded ``fold_in(key, i)`` for an int
        ``key``; for a ``torch.Generator`` (None: the port's generator of
        the device) every step draws from it in turn, as k ``step`` calls
        with that key would."""
        data, label = self.stage_many(data, label)
        k = data.shape[0]
        raw = self._step_raw
        folded = isinstance(key, numbers.Integral)
        if self._device.type != "cuda":
            loss = None
            for i in range(k):
                step_key = fold_in(key, i) if folded else key
                params, moms, aux, loss = raw(params, moms, aux, data[i],
                                              label[i], step_key)
            return params, moms, aux, loss
        gens = None
        if raw.needs_rng and not folded:
            gens = [_generator(key, self._device)] * k
        storage = tuple(t.data_ptr() for d in (params, moms, aux)
                        for t in d.values())
        gkey = (k, tuple(data.shape), tuple(label.shape), data.dtype,
                data.data_ptr(), label.data_ptr(), storage,
                "folded" if folded else id(gens[0]) if gens else None)
        # graphs over storage that is gone would keep it alive
        for stale in [g for g in self._graphs if g[6] != storage]:
            del self._graphs[stale]
        graph = self._graphs.get(gkey)
        if graph is None:
            if raw.needs_rng and folded:
                gens = [torch.Generator(device=self._device)
                        for _ in range(k)]
            graph = self._graphs[gkey] = _Graph(raw, params, moms, aux, data,
                                                label, gens)
            self.captures += 1
        if raw.needs_rng and folded:
            for i, g in enumerate(graph.gens):
                g.manual_seed(fold_in(key, i))
        graph.graph.replay()
        return params, moms, aux, graph.loss.clone()
