"""Gluon ``Trainer``.

Counterpart of the JAX package's ``gluon/trainer.py`` (reference:
python/mxnet/gluon/trainer.py): applies an optimizer to a list of
Parameters after ``autograd.backward``. On one device, with kvstore
``None``, ``"device"`` or ``"local"`` (there is nothing to reduce),
``step(batch_size)`` sets ``rescale_grad = scale / batch_size`` and runs
``optimizer.apply_all``: every parameter's update in ONE call of the
optimizer's fused rule, which on CUDA tensors is one launch of its kernel
(``sgd_fused_update``, ``adam_fused_update``, ...; the plain version
runs for CPU tensors only). With ``multi_precision`` the float16
weights update on their float32 master copies in that same launch. An
optimizer without a fused rule (Nadam, SGLD, DCASGD, LBSGD) updates
parameter by parameter, as in the JAX package. Other kvstores, several
devices and sparse gradients are ROADMAP A12.6 / A13.
"""
from __future__ import annotations

import pickle

import numpy as np

from ..base import MXNetError
from .. import optimizer as opt_mod
from ..ndarray.ndarray import NDArray, array
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_KVSTORES = (None, "device", "local")


class Trainer(object):
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got %s." % type(params))
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError("got %s instead of Parameter" % type(p))
        if kvstore not in _KVSTORES or compression_params or \
                update_on_kvstore:
            raise MXNetError(
                "Trainer(kvstore=%r%s): mxnet_tpu_torch trains on one device "
                "(kvstore None, 'device' or 'local'); kvstores across "
                "devices and workers are ROADMAP A12.6 / A13" % (
                    kvstore, ", compression / update_on_kvstore"
                    if compression_params or update_on_kvstore else ""))
        self._params = list(params)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params and list(optimizer_params) != ["rescale_grad"]:
                raise ValueError(
                    "optimizer_params must be None if optimizer is an "
                    "instance of Optimizer instead of str")
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._states = [None] * len(self._params)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    def _items(self, ignore_stale_grad):
        """``(index, weight, grad, state)`` of every trained parameter,
        each state created on first use."""
        items = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if p._data is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError("Parameter %s has not been initialized"
                                 % p.name)
            if self._states[i] is None:
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(i, p.data())
            items.append((i, p.data(), p.grad(), self._states[i]))
        return items

    def step(self, batch_size, ignore_stale_grad=False):
        """Update every parameter from its gradient, normalized by
        ``batch_size`` (reference: trainer.py:254 step)."""
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        items = self._items(ignore_stale_grad)
        if items and not opt_mod.apply_all(self._optimizer, items):
            for i, weight, grad, state in items:
                self._optimizer.update_multi_precision(i, weight, grad,
                                                       state)

    def save_states(self, fname):
        """Write the optimizer states (reference: trainer.py save_states;
        the JAX package's pickle, plus the per-index update counts)."""
        with open(fname, "wb") as f:
            pickle.dump({"optimizer": type(self._optimizer).__name__,
                         "num_update": self._optimizer.num_update,
                         "index_update_count":
                             dict(self._optimizer._index_update_count),
                         "states": [_to_numpy(s) for s in self._states]}, f)

    def load_states(self, fname):
        """Read what ``save_states`` of either package wrote; states land
        on their parameter's device."""
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        opt = self._optimizer
        opt.num_update = blob.get("num_update", 0)
        opt._index_update_count = dict(blob.get("index_update_count", {}))
        self._states = [
            _from_numpy(s, p.data().context if p._data is not None
                        else "cpu")
            for s, p in zip(blob["states"], self._params)]


def _to_numpy(s):
    if s is None:
        return None
    if isinstance(s, NDArray):
        return s.asnumpy()
    if isinstance(s, (list, tuple)):
        return [_to_numpy(x) for x in s]
    return s


def _from_numpy(s, ctx):
    if s is None:
        return None
    if isinstance(s, np.ndarray):
        return array(s, ctx=ctx, dtype=s.dtype)
    if isinstance(s, (list, tuple)):
        return tuple(_from_numpy(x, ctx) for x in s)
    return s
