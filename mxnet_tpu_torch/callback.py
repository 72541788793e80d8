"""Training callbacks (the JAX package's ``callback.py``): ``Speedometer``.
The checkpoint callbacks come with the rest of ROADMAP A8.2 (fit's
checkpoint_prefix and resume, optimizer-state files); until then they
raise."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "module_checkpoint"]


def do_checkpoint(prefix, period=1):
    raise NotImplementedError("do_checkpoint is not ported yet (ROADMAP "
                              "A8.2; model.save_checkpoint is)")


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    raise NotImplementedError("module_checkpoint is not ported yet "
                              "(ROADMAP A8.2; model.save_checkpoint is)")


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
