"""Training callbacks (the JAX package's ``callback.py``): the
checkpoint callbacks ``do_checkpoint`` and ``module_checkpoint``, and
``Speedometer``."""
from __future__ import annotations

import logging
import time

from .model import save_checkpoint

__all__ = ["Speedometer", "do_checkpoint", "module_checkpoint"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """An epoch-end callback that saves ``mod`` every ``period`` epochs
    through ``Module.save_checkpoint``, numbered by completed epochs
    (reference: callback.py module_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """An epoch-end callback that saves the symbol and parameters every
    ``period`` epochs through ``model.save_checkpoint`` (atomic files
    and a checksum manifest), numbered by completed epochs (reference:
    callback.py do_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


class Speedometer(object):
    """Log throughput (samples/sec) and the metric every ``frequent``
    batches, resetting the metric after each log when ``auto_reset``
    (reference: callback.py Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent != 0:
            return
        try:
            speed = self.frequent * self.batch_size / (time.time() - self.tic)
        except ZeroDivisionError:
            speed = float("inf")
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
            msg += "\t%s=%f" * len(name_value)
            logging.info(msg, param.epoch, count, speed,
                         *sum(name_value, ()))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.tic = time.time()
