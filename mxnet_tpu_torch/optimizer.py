"""Optimizers: SGD and Adam, with the fused update rules.

Counterpart of the JAX package's ``optimizer.py``. ``Optimizer`` keeps
the bookkeeping as there (learning-rate schedule, per-parameter lr/wd
multipliers, per-index update counts, ``fused_hyper``); the update math
is the fused rule of ``ops/cuda/fused_update.py``. A rule here takes
whole lists, ``rule(weights, grads, states, hypers)``, and updates the
tensors in place: ``fused_rule()`` returns the hand-written kernel's
wrapper (``sgd_fused_update`` / ``adam_fused_update``, one launch over
every parameter on the card; the plain version for CPU tensors only).
``MXNET_PALLAS_FUSED_UPDATE=0``, which selects the XLA rules in the JAX
package, raises here: the port has no other route on the card. The
unfused path (``update(index, ...)``) calls the same rule on a list of
one, so the fused and unfused steps compute the same function, as the
JAX package holds them bitwise equal (tests/test_fused_step.py).

Multi-precision and weights other than float32 are refused. The other
optimizers (NAG, Signum, AdaGrad, RMSProp, ...) come with ROADMAP A8.5.
``Updater.get_states`` / ``set_states`` read and write the JAX package's
optimizer-state files.
"""
from __future__ import annotations

import io
import logging
import pickle

import numpy
import torch

from .base import MXNetError
from .config import get as _cfg
from .ndarray.ndarray import NDArray, zeros
from .ops.cuda import fused_update as _fu

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register", "fused_state_arrays", "fused_apply"]


def fused_state_arrays(state):
    """An optimizer state (None | NDArray | tuple) as the flat tuple of
    NDArray buffers a fused rule updates."""
    if state is None:
        return ()
    if isinstance(state, NDArray):
        return (state,)
    return tuple(state)


class Optimizer(object):
    """Base optimizer (reference: python/mxnet/optimizer.py:444)."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        """Register a subclass under its lowercased name."""
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            logging.warning("New optimizer %s is overriding existing "
                            "optimizer %s", klass.__name__, name)
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise MXNetError("optimizer %r is not ported to mxnet_tpu_torch "
                         "(sgd and adam are; the other rules are ROADMAP "
                         "A8.5)" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        if multi_precision:
            raise NotImplementedError("multi_precision (low-precision "
                                      "weights with float32 master copies) "
                                      "is not ported yet (ROADMAP A8.4)")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = False
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise MXNetError("param_idx2name should be a dict of param "
                             "indexes to names.")
        self.idx2name = param_idx2name.copy()
        self.sym_info = ((sym.attr_dict(), sym.list_arguments())
                         if sym is not None else ())
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    @property
    def learning_rate(self):
        """The current learning rate, the scheduler's at ``num_update``
        when one is set (reference: optimizer.py learning_rate)."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        """Set the learning rate; refused while a scheduler sets it."""
        if self.lr_scheduler is not None:
            raise UserWarning(
                "LRScheduler of the optimizer has already been defined. "
                "Note that set_learning_rate can mutate the value of the "
                "learning rate of the optimizer only when the LRScheduler "
                "of the optimizer is undefined.")
        self.lr = lr

    def create_state(self, index, weight):
        """Create the state for ``weight``. Override."""

    def update(self, index, weight, grad, state):
        """Update one weight in place (the unfused path): the fused rule
        on a list of one, with this index's hypers."""
        rule = self.fused_rule()
        if rule is None:
            raise NotImplementedError("%s has no update rule"
                                      % type(self).__name__)
        if weight.dtype != numpy.float32:
            raise MXNetError("%s: weight dtype %s; mxnet_tpu_torch updates "
                             "float32 weights only (ROADMAP A8.4)"
                             % (type(self).__name__, weight.dtype))
        rule([weight._data], [grad._data],
             [tuple(s._data for s in fused_state_arrays(state))],
             [self.fused_hyper(index)])

    def fused_rule(self):
        """``rule(weights, grads, states, hypers)`` over lists of tensors,
        in place; None when the optimizer has none."""
        return None

    def fused_hyper(self, index):
        """This step's scalar hyperparameters for ``index``; advances the
        same update-count / lr-schedule bookkeeping as ``update``."""
        self._update_count(index)
        h = {"lr": float(self._get_lr(index)),
             "wd": float(self._get_wd(index)),
             "rescale_grad": float(self.rescale_grad)}
        if self.clip_gradient is not None and self.clip_gradient > 0:
            h["clip_gradient"] = float(self.clip_gradient)
        return h

    def set_lr_mult(self, args_lr_mult):
        """Per-parameter learning-rate multipliers (``__lr_mult__`` attrs
        of the symbol, then ``args_lr_mult``)."""
        self.lr_mult = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Per-parameter weight-decay multipliers. Names not ending in
        ``_weight`` or ``_gamma`` (biases, betas) get 0."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd


def _kernel_rule(wrapper):
    """``wrapper``, the kernel's; the knob cannot pin another route."""
    if not _cfg("MXNET_PALLAS_FUSED_UPDATE"):
        raise MXNetError("MXNET_PALLAS_FUSED_UPDATE=0: mxnet_tpu_torch has "
                         "no update rule but the fused-update kernel (its "
                         "plain version runs for CPU tensors only); unset "
                         "the knob or set it to 1")
    return wrapper


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum (reference: optimizer.py SGD)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def fused_rule(self):
        return _kernel_rule(_fu.sgd_fused_update)

    def fused_hyper(self, index):
        h = super().fused_hyper(index)
        h["momentum"] = float(self.momentum)
        return h


@register
class Adam(Optimizer):
    """Adam (reference: optimizer.py Adam); the learning rate is
    bias-corrected per index on the host."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))

    def fused_rule(self):
        return _kernel_rule(_fu.adam_fused_update)

    def fused_hyper(self, index):
        h = super().fused_hyper(index)
        t = self._index_update_count[index]
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        h["lr"] = float(h["lr"] * (numpy.sqrt(coef2) / coef1))
        h["beta1"] = float(self.beta1)
        h["beta2"] = float(self.beta2)
        h["one_minus_beta1"] = 1.0 - float(self.beta1)
        h["one_minus_beta2"] = 1.0 - float(self.beta2)
        h["epsilon"] = float(self.epsilon)
        return h


class Updater(object):
    """Applies an optimizer to (index, grad, weight) triples, keeping
    each index's state (reference: optimizer.py Updater).

    ``get_states()`` / ``set_states()`` read and write the JAX package's
    optimizer-state file: a pickle of ``{index: state}``, each state
    None, a numpy array or a tuple of them. A loaded state becomes an
    NDArray on its weight's device at first use."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def ensure_state(self, index, weight):
        """The state of ``index``, created on first use (or moved onto
        ``weight``'s device after ``set_states``); shared by the
        per-parameter path and the fused train step."""
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            self.states[index] = _state_on(self.states[index],
                                           weight.context)
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update(index, weight, grad,
                              self.ensure_state(index, weight))

    def get_states(self, dump_optimizer=False):
        """The states as the bytes of an optimizer-state file."""
        if dump_optimizer:
            raise MXNetError(
                "get_states(dump_optimizer=True) would pickle the optimizer "
                "object, which the other package cannot read; the state "
                "file holds {index: state} only")
        return pickle.dumps({i: _state_numpy(s)
                             for i, s in self.states.items()})

    def set_states(self, states):
        """Load the bytes of an optimizer-state file (``get_states``'
        form). Refuses a file that names any class but numpy's arrays,
        such as one saved with ``dump_optimizer=True``."""
        loaded = _StateUnpickler(io.BytesIO(states)).load()
        if not isinstance(loaded, dict):
            raise MXNetError("optimizer-state file holds %s, not "
                             "{index: state}" % type(loaded).__name__)
        self.states = loaded
        self.states_synced = dict.fromkeys(loaded, False)


# what an optimizer-state pickle may name: numpy's array reconstruction
_STATE_GLOBALS = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode")}


class _StateUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) not in _STATE_GLOBALS:
            raise MXNetError(
                "optimizer-state file names %s.%s: only {index: numpy "
                "state} files are read (a file saved with "
                "dump_optimizer=True pickles the optimizer object of "
                "another package)" % (module, name))
        return super().find_class(module, name)


def _state_numpy(state):
    if isinstance(state, NDArray):
        return state.asnumpy()
    if isinstance(state, (tuple, list)):
        return type(state)(_state_numpy(s) for s in state)
    return state


def _state_on(state, device):
    if isinstance(state, numpy.ndarray):
        return NDArray(torch.from_numpy(numpy.array(state)).to(device))
    if isinstance(state, NDArray):
        return state.as_in_context(device)
    if isinstance(state, (tuple, list)):
        return type(state)(_state_on(s, device) for s in state)
    return state


def get_updater(optimizer):
    return Updater(optimizer)


def fused_apply(optimizer, items):
    """Update every ``(index, weight, grad, state)`` of ``items`` in place
    through ONE call of ``optimizer.fused_rule()``: one launch of the
    update kernel on CUDA tensors, the plain version on CPU tensors
    (reference: the JAX package's ``optimizer.fused_apply``, one donated
    XLA program; Gluon's ``Trainer.step`` calls it)."""
    rule = optimizer.fused_rule()
    if rule is None:
        raise NotImplementedError("%s has no update rule"
                                  % type(optimizer).__name__)
    for _i, w, _g, _s in items:
        if w.dtype != numpy.float32:
            raise MXNetError("%s: weight dtype %s; mxnet_tpu_torch updates "
                             "float32 weights only (ROADMAP A8.4)"
                             % (type(optimizer).__name__, w.dtype))
    hypers = [optimizer.fused_hyper(i) for i, _w, _g, _s in items]
    with torch.no_grad():       # the weights are autograd leaves
        rule([w._data for _i, w, _g, _s in items],
             [g._data for _i, _w, g, _s in items],
             [tuple(a._data for a in fused_state_arrays(s))
              for _i, _w, _g, s in items], hypers)
