"""Optimizers, with the fused update rules.

Counterpart of the JAX package's ``optimizer.py``: its 15 optimizers
under the same names. ``Optimizer`` keeps the bookkeeping as there
(learning-rate schedule, per-parameter lr/wd multipliers, per-index
update counts, ``fused_hyper``); the update math is the fused rule of
``ops/cuda/fused_update.py``. A rule here takes whole lists,
``rule(weights, grads, states, hypers, masters=None)``, and updates the
tensors in place: ``fused_rule()`` returns the hand-written kernel's
wrapper (``sgd_fused_update``, ``adam_fused_update``, ``nag_fused_update``,
..., one launch over every parameter on the card; the plain version for
CPU tensors only). ``MXNET_PALLAS_FUSED_UPDATE=0``, which selects the
XLA rules in the JAX package, raises here: the port has no other route
on the card. The unfused path (``update(index, ...)``) calls the same
rule on a list of one, so the fused and unfused steps compute the same
function, as the JAX package holds them bitwise equal
(tests/test_fused_step.py). ``Nadam``, ``SGLD``, ``DCASGD`` and
``LBSGD`` have no fused rule in the JAX package either: they update per
parameter in plain PyTorch (LBSGD's step through ``sgd_fused_update``).

Weights may be float32, bfloat16 or float16; a rule rounds every
operation to the weight's type, as the JAX rule does. With
``multi_precision`` a float16 weight (float16 only, as in the JAX
package: a bfloat16 weight takes its plain update) keeps a float32
master copy: its state is ``(state, weight32)``, the rule runs in
float32 on the master and the weight becomes the master rounded
(``create_state_multi_precision`` / ``update_multi_precision``;
:func:`apply_all` does a whole list in one launch).
``Updater.get_states`` / ``set_states`` read and write the JAX package's
optimizer-state files.
"""
from __future__ import annotations

import io
import logging
import math
import pickle

import numpy
import torch

from .base import MXNetError
from .config import get as _cfg
from .ndarray.ndarray import NDArray, array, zeros
from .ops.cuda import fused_update as _fu

__all__ = ["Optimizer", "SGD", "Signum", "NAG", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "Ftrl", "FTML", "Adamax", "Nadam", "SGLD", "DCASGD",
           "LBSGD", "Test", "Updater", "get_updater", "create", "register",
           "fused_state_arrays", "fused_apply", "apply_all"]


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
        raise ValueError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
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
        self.multi_precision = multi_precision
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

    def _mastered(self, weight):
        """Whether ``weight`` trains on a float32 master copy."""
        return self.multi_precision and weight.dtype == numpy.float16

    def create_state_multi_precision(self, index, weight):
        """``create_state``, except that with ``multi_precision`` a
        float16 weight gets a float32 master copy and the state
        ``(state of the master, master)`` (reference: optimizer.py
        create_state_multi_precision)."""
        if self._mastered(weight):
            master = weight.astype(numpy.float32)
            return (self.create_state(index, master), master)
        if weight.dtype == numpy.float16:
            logging.warning("Accumulating with float16 in optimizer can lead "
                            "to poor accuracy or slow convergence. Consider "
                            "using multi_precision=True option.")
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        """Update one weight in place (the unfused path): the fused rule
        on a list of one, with this index's hypers."""
        self._rule_call([(index, weight, grad, state)], master=False)

    def update_multi_precision(self, index, weight, grad, state):
        """``update``, on the float32 master copy of a float16 weight
        with ``multi_precision`` (its state ``(state, master)``)."""
        if self.fused_rule() is not None:
            self._rule_call([(index, weight, grad, state)], master=True)
        elif self._mastered(weight):
            inner, master = state
            self.update(index, master, grad.astype(numpy.float32), inner)
            with torch.no_grad():
                weight._data.copy_(master._data)
        else:
            self.update(index, weight, grad, state)

    def _rule_call(self, items, master):
        """One call of the fused rule over ``items`` ((index, weight,
        grad, state)), a float16 weight on its master copy where
        ``master`` and ``multi_precision``."""
        rule = self.fused_rule()
        if rule is None:
            raise NotImplementedError("%s has no update rule"
                                      % type(self).__name__)
        ws, gs, states, masters = [], [], [], []
        for _i, w, g, s in items:
            m = None
            if master and self._mastered(w):
                s, m = s
                m = m._data
            ws.append(w._data)
            gs.append(g._data)
            states.append(tuple(a._data for a in fused_state_arrays(s)))
            masters.append(m)
        hypers = [self.fused_hyper(i) for i, _w, _g, _s in items]
        with torch.no_grad():       # the weights are autograd leaves
            rule(ws, gs, states, hypers,
                 masters if any(m is not None for m in masters) else None)

    def fused_rule(self):
        """``rule(weights, grads, states, hypers, masters=None)`` over
        lists of tensors, in place; None when the optimizer has none."""
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

    def _prep_grad(self, grad, weight=None, wd=0.0):
        """The unfused optimizers' gradient: ``grad * rescale_grad`` (+
        ``wd * weight`` where given), clipped whenever ``clip_gradient``
        is set, as their JAX ``update`` does."""
        g = grad * self.rescale_grad
        if weight is not None:
            g = g + wd * weight
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g


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


def _zeros_like(weight):
    return zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)


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
        return _zeros_like(weight)

    def fused_rule(self):
        return _kernel_rule(_fu.sgd_fused_update)

    def fused_hyper(self, index):
        h = super().fused_hyper(index)
        h["momentum"] = float(self.momentum)
        return h


@register
class Signum(Optimizer):
    """Sign-of-gradient SGD with momentum (reference: optimizer.py
    Signum); signSGD without."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def fused_rule(self):
        return _kernel_rule(_fu.signum_fused_update)

    def fused_hyper(self, index):
        h = super().fused_hyper(index)
        h["momentum"] = float(self.momentum)
        h["one_minus_momentum"] = 1.0 - float(self.momentum)
        h["wdlh_coef"] = 1.0 - h["lr"] * float(self.wd_lh)
        h["lr_wd"] = h["lr"] * h["wd"]
        return h


@register
class NAG(Optimizer):
    """Nesterov accelerated gradient (reference: optimizer.py NAG)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def fused_rule(self):
        return _kernel_rule(_fu.nag_fused_update)

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
        return (_zeros_like(weight), _zeros_like(weight))

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


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference: optimizer.py AdaGrad)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def fused_rule(self):
        return _kernel_rule(_fu.adagrad_fused_update)

    def fused_hyper(self, index):
        h = super().fused_hyper(index)
        h["eps"] = float(self.float_stable_eps)
        if self.clip_gradient is not None:
            # the JAX update() clips whenever clip_gradient is set
            h["clip_gradient"] = float(self.clip_gradient)
        return h


@register
class RMSProp(Optimizer):
    """RMSProp, plain (Tieleman) or centered (Graves) (reference:
    optimizer.py RMSProp)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:       # n, g, delta
            return tuple(_zeros_like(weight) for _ in range(3))
        return _zeros_like(weight)

    def fused_rule(self):
        return _kernel_rule(_fu.rmsprop_fused_update)

    def fused_hyper(self, index):
        h = super().fused_hyper(index)
        h["gamma1"] = float(self.gamma1)
        h["one_minus_gamma1"] = 1.0 - float(self.gamma1)
        h["epsilon"] = float(self.epsilon)
        if self.centered:
            h["gamma2"] = float(self.gamma2)
        if self.clip_weights is not None and self.clip_weights > 0:
            h["clip_weights"] = float(self.clip_weights)
        return h


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference: optimizer.py AdaDelta)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def fused_rule(self):
        return _kernel_rule(_fu.adadelta_fused_update)

    def fused_hyper(self, index):
        h = super().fused_hyper(index)
        h["rho"] = float(self.rho)
        h["one_minus_rho"] = 1.0 - float(self.rho)
        h["epsilon"] = float(self.epsilon)
        if self.clip_gradient is not None:
            h["clip_gradient"] = float(self.clip_gradient)
        return h


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference: optimizer.py Ftrl)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))    # z, n

    def fused_rule(self):
        return _kernel_rule(_fu.ftrl_fused_update)

    def fused_hyper(self, index):
        h = super().fused_hyper(index)
        h["lamda1"] = float(self.lamda1)
        h["beta"] = float(self.beta)
        return h


@register
class FTML(Optimizer):
    """FTML (reference: optimizer.py FTML); the step's coefficients are
    folded per index on the host."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return tuple(_zeros_like(weight) for _ in range(3))   # d, v, z

    def fused_rule(self):
        return _kernel_rule(_fu.ftml_fused_update)

    def fused_hyper(self, index):
        h = super().fused_hyper(index)
        t = self._index_update_count[index]
        h["beta1"] = float(self.beta1)
        h["one_minus_beta1"] = 1.0 - float(self.beta1)
        h["beta2"] = float(self.beta2)
        h["one_minus_beta2"] = 1.0 - float(self.beta2)
        h["epsilon"] = float(self.epsilon)
        h["d_coef"] = (1.0 - self.beta1 ** t) / h["lr"]
        h["v_coef"] = 1.0 - self.beta2 ** t
        return h


@register
class Adamax(Optimizer):
    """AdaMax, Adam with the infinity norm (reference: optimizer.py
    Adamax)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def fused_rule(self):
        return _kernel_rule(_fu.adamax_fused_update)

    def fused_hyper(self, index):
        h = super().fused_hyper(index)
        t = self._index_update_count[index]
        h["lr"] = float(h["lr"] / (1.0 - self.beta1 ** t))
        h["beta1"] = float(self.beta1)
        h["one_minus_beta1"] = 1.0 - float(self.beta1)
        h["beta2"] = float(self.beta2)
        if self.clip_gradient is not None:
            h["clip_gradient"] = float(self.clip_gradient)
        return h


@register
class Nadam(Optimizer):
    """Nesterov Adam (reference: optimizer.py Nadam); per parameter, in
    plain PyTorch (no fused rule in the JAX package either)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        w = weight._data
        with torch.no_grad():
            g = self._prep_grad(grad._data, w, wd)
            momentum_t = self.beta1 * (
                1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
            momentum_t_1 = self.beta1 * (
                1.0 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
            self.m_schedule = self.m_schedule * momentum_t
            m_schedule_next = self.m_schedule * momentum_t_1
            m, v = state[0]._data, state[1]._data
            m.copy_(self.beta1 * m + (1.0 - self.beta1) * g)
            v.copy_(self.beta2 * v + (1.0 - self.beta2) * g * g)
            grad_prime = g / (1.0 - self.m_schedule)
            m_prime = m / (1.0 - m_schedule_next)
            v_prime = v / (1.0 - self.beta2 ** t)
            m_bar = (1.0 - momentum_t) * grad_prime + momentum_t_1 * m_prime
            w.copy_(w - lr * m_bar / (_fu._sqrt(v_prime) + self.epsilon))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference: optimizer.py
    SGLD); per parameter, in plain PyTorch, the noise drawn from the
    port's generator of the weight's device."""

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        from . import random as _random
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        with torch.no_grad():
            g = self._prep_grad(grad._data)
            noise = torch.randn(w.shape, generator=_random.generator(
                w.device), dtype=w.dtype, device=w.device) * math.sqrt(lr)
            w.copy_(w - lr / 2 * (g + wd * w) + noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference: optimizer.py
    DCASGD); per parameter, in plain PyTorch."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = weight.copy()
        if self.momentum == 0.0:
            return (None, prev)
        return (_zeros_like(weight), prev)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        mom, prev = state
        with torch.no_grad():
            g = self._prep_grad(grad._data)
            delta = -lr * (g + wd * w + self.lamda * g * g
                           * (w - prev._data))
            if mom is not None:
                mom._data.copy_(mom._data * self.momentum + delta)
                delta = mom._data
            prev._data.copy_(w)
            w.copy_(w + delta)


@register
class LBSGD(Optimizer):
    """Large-batch SGD (reference: optimizer.py LBSGD): per parameter,
    the gradient accumulates over ``batch_scale`` micro-batches, then one
    momentum-SGD step (``sgd_fused_update`` on a list of one) at the
    learning rate scaled by the warm-up strategy ('linear', 'power2',
    'sqrt' toward ``batch_scale`` over ``warmup_epochs``) or by the LARS
    trust ratio (``warmup_strategy='lars'``)."""

    def __init__(self, momentum=0.0, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = int(batch_scale)
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self._cum = {}                     # index -> [cum_grad, n]

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def _warmup_mult(self, nup):
        nwup = self.warmup_epochs * self.updates_per_epoch
        maxmult = float(self.batch_scale)
        if nup >= nwup:
            return maxmult
        if nwup <= 1:
            return 1.0
        if self.warmup_strategy == "linear":
            return 1.0 + (maxmult - 1) * nup / nwup
        if self.warmup_strategy == "power2":
            return 1.0 + (maxmult - 1) * (nup * nup) / (nwup * nwup)
        if self.warmup_strategy == "sqrt":
            return 1.0 + (maxmult - 1) * math.sqrt(float(nup) / nwup)
        return 1.0

    def _lars(self, weight, grad, wd):
        w2 = float((weight * weight).sum())
        g2 = float((grad * grad).sum())
        lars = math.sqrt(w2 / (g2 + wd * w2 + 1e-18))
        return min(max(lars, 0.01), 100.0)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = grad._data
        if self.batch_scale > 1:
            # the micro-batch count runs on for the whole run, so the
            # warm-up advances; the sum restarts at each macro-batch
            cum = self._cum.get(index)
            if cum is None:
                self._cum[index] = cum = [g.clone(), 1]
            elif cum[1] % self.batch_scale == 0:
                cum[0] = g.clone()
                cum[1] += 1
            else:
                cum[0] = cum[0] + g
                cum[1] += 1
            if cum[1] % self.batch_scale != 0:
                return                      # an accumulating micro-batch
            g = cum[0] / self.batch_scale
            nup = self.init_updates + cum[1]
        else:
            nup = self.init_updates + self.num_update
        if self.warmup_strategy == "lars":
            lr = lr * self._lars(weight._data, g, wd)
        else:
            lr = lr * self._warmup_mult(nup)
        h = {"lr": float(lr), "wd": float(wd),
             "rescale_grad": float(self.rescale_grad)}
        if self.clip_gradient is not None and self.clip_gradient > 0:
            h["clip_gradient"] = float(self.clip_gradient)
        if state is not None:
            h["momentum"] = float(self.momentum)
        with torch.no_grad():
            _fu.sgd_fused_update([weight._data], [g],
                                 [tuple(a._data for a in
                                        fused_state_arrays(state))], [h])


@register
class Test(Optimizer):
    """Test optimizer: accumulating SGD (reference: optimizer.py Test)."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def fused_rule(self):
        return _kernel_rule(_fu.test_fused_update)

    def fused_hyper(self, index):
        # update()'s: the raw lr, no scheduler, multipliers or counts
        return {"lr": float(self.lr),
                "rescale_grad": float(self.rescale_grad)}


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
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            self.states[index] = _state_on(self.states[index],
                                           weight.context)
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(
            index, weight, grad, self.ensure_state(index, weight))

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
    ("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode"),
    # bfloat16 states: numpy has no bfloat16; both packages carry it as
    # ml_dtypes' (what NDArray.asnumpy returns)
    ("ml_dtypes", "bfloat16")}


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
        return array(state, ctx=device, dtype=state.dtype)
    if isinstance(state, NDArray):
        return state.as_in_context(device)
    if isinstance(state, (tuple, list)):
        return type(state)(_state_on(s, device) for s in state)
    return state


def get_updater(optimizer):
    return Updater(optimizer)


def apply_all(optimizer, items):
    """Update every ``(index, weight, grad, state)`` of ``items`` in place
    through ONE call of ``optimizer.fused_rule()`` (one launch of the
    update kernel on CUDA tensors, the plain version on CPU tensors), a
    float16 weight of a ``multi_precision`` optimizer on its float32
    master copy (its state ``(state, master)``). False, and nothing
    done, when the optimizer has no fused rule."""
    if optimizer.fused_rule() is None:
        return False
    optimizer._rule_call(items, master=True)
    return True


def fused_apply(optimizer, items):
    """The JAX package's ``optimizer.fused_apply``: :func:`apply_all`,
    declining (False, nothing done) for an optimizer without a fused rule
    or with ``multi_precision``, as the JAX one does; Gluon's ``Trainer``
    then takes :func:`apply_all` or the per-parameter updates."""
    if optimizer.multi_precision:
        return False
    return apply_all(optimizer, items)
