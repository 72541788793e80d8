"""Model helpers (the JAX package's ``model.py``): whether the fused
train step may run, the kvstore choice for one device, the per-parameter
update loop of the unfused path, and checkpoint files
(``save_checkpoint`` / ``load_checkpoint`` / ``load_latest_valid``, in
the JAX package's layout, which both packages load). Kvstores are
ROADMAP A13."""
from __future__ import annotations

from collections import namedtuple

from . import telemetry as _tm
from .config import get as _cfg

__all__ = ["BatchEndParam", "fused_step_supported", "_create_kvstore",
           "_update_params", "save_checkpoint", "load_checkpoint",
           "load_latest_valid"]

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


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True, nbatch=0, states_fname=None,
                    io_cursor=None):
    """Checkpoint to ``prefix-symbol.json`` + ``prefix-%04d.params``
    (reference: model.py:383), crash-consistently: every file goes
    through ``checkpoint.atomic_writer``, and a ``.manifest.json`` sidecar
    records the files' checksums, the epoch/batch position, the random
    state and whether ``states_fname`` (optimizer states) exists."""
    import os
    from .checkpoint import write_manifest
    from .ndarray.utils import save as nd_save
    t0 = _tm.monotonic()
    sym_file = None
    if symbol is not None:
        sym_file = "%s-symbol.json" % prefix
        symbol.save(sym_file)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd_save(param_name, save_dict)
    write_manifest(prefix, epoch,
                   {"params": param_name, "symbol": sym_file,
                    "states": states_fname}, nbatch=nbatch,
                   extra={"io_cursor": io_cursor} if io_cursor else None)
    from . import blackbox as _bb
    _bb.record_event("checkpoint", file=os.path.basename(param_name),
                     seconds=round(_tm.monotonic() - t0, 4))
    _tm.counter("checkpoint/saves_total", "Checkpoints written").inc()
    _tm.histogram("checkpoint/save_seconds",
                  "Wall time of one checkpoint save (params + manifest)"
                  ).observe(_tm.monotonic() - t0)
    _tm.counter("checkpoint/bytes_total",
                "Bytes written to checkpoint params files"
                ).inc(os.path.getsize(param_name))


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of checkpoint ``epoch``
    (reference: model.py:413), on the host. A torn or corrupt params
    file raises :class:`MXNetError` naming it; ``load_latest_valid``
    falls back to the newest checkpoint that verifies."""
    from .checkpoint import split_params
    from .ndarray.utils import load as nd_load
    from .symbol import load as sym_load
    symbol = sym_load("%s-symbol.json" % prefix)
    arg_params, aux_params = split_params(
        nd_load("%s-%04d.params" % (prefix, epoch)))
    return symbol, arg_params, aux_params


def load_latest_valid(prefix):
    """The newest checkpoint under ``prefix`` whose checksums verify, as
    ``(symbol, arg_params, aux_params, epoch)``, or None when there is
    none; the full state is ``checkpoint.load_latest_valid``'s."""
    from .checkpoint import load_latest_valid as _llv
    state = _llv(prefix)
    if state is None:
        return None
    return state.symbol, state.arg_params, state.aux_params, state.epoch
