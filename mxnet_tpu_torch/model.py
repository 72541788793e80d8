"""Model helpers (the JAX package's ``model.py``): whether the fused
train step may run, the kvstore choice for one device, and the
per-parameter update loop of the unfused path. Checkpoint files
(``save_checkpoint``/``load_checkpoint``) come with ROADMAP A8.2, and
kvstores with ROADMAP A13."""
from __future__ import annotations

from collections import namedtuple

from .config import get as _cfg

__all__ = ["BatchEndParam", "fused_step_supported", "_create_kvstore",
           "_update_params"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def fused_step_supported(optimizer, kvstore, update_on_kvstore,
                         compression_params=None):
    """Whether the fused train step (Executor.train_step) may replace the
    forward / backward / per-parameter update sequence: the knob is on,
    updates run on the worker, and the optimizer has a fused rule."""
    if not _cfg("MXNET_FUSED_STEP"):
        return False
    if update_on_kvstore or kvstore is not None or compression_params:
        return False
    if optimizer is None:
        return False
    return optimizer.fused_rule() is not None


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore) for ``kvstore`` over ``num_device``
    devices (reference: model.py:77). On one device ``local`` and
    ``device`` need no store, as in the JAX package; every real kvstore
    is ROADMAP A13."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, str) and num_device == 1 \
            and "dist" not in kvstore:
        return None, False
    raise NotImplementedError(
        "kvstore %r over %d device(s) is not ported yet: mxnet_tpu_torch "
        "trains on one device without a kvstore (ROADMAP A13)"
        % (getattr(kvstore, "type", kvstore), num_device))


def _update_params(param_arrays, grad_arrays, updater, param_names=None):
    """Apply ``updater`` to each (index, grad, weight) with a gradient
    (reference: model.py:132, one device, no kvstore)."""
    for index, (weight, grad) in enumerate(zip(param_arrays, grad_arrays)):
        if grad is None:
            continue
        updater(index, grad, weight)
