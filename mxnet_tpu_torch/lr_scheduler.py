"""Learning-rate schedulers.

The JAX package's ``lr_scheduler.py`` (``FactorScheduler``,
``MultiFactorScheduler``; Poly and Cosine come with ROADMAP A8.6).
Schedulers are host-side functions of num_update: the learning rate
reaches the fused update kernel as data in its per-step table, so a
schedule step changes no launch.
"""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]


class LRScheduler(object):
    """Base scheduler: maps num_update -> learning rate."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        if warmup_steps < 0:
            raise ValueError("warmup_steps must be >= 0")
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("warmup_mode must be 'linear' or 'constant'")
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) \
                * num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        return self.warmup_begin_lr

    def __call__(self, num_update):
        raise NotImplementedError()


class FactorScheduler(LRScheduler):
    """lr decays by ``factor`` once per ``step`` updates, floored at
    ``stop_factor_lr``. Computed in closed form from num_update — there is
    no incremental state to corrupt on checkpoint resume."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("step must be a positive update count")
        if factor > 1.0:
            raise ValueError("a decay factor > 1 would grow the lr")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self._decays_logged = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        decays = max(0, (num_update - 1) // self.step)
        lr = self.base_lr * (self.factor ** decays)
        floored = lr < self.stop_factor_lr
        if floored:
            lr = self.stop_factor_lr
        if decays != self._decays_logged:
            self._decays_logged = decays
            logging.info("lr schedule: update %d -> lr %.5e%s", num_update,
                         lr, " (floor reached; holding)" if floored else "")
        return lr


class MultiFactorScheduler(LRScheduler):
    """lr decays by ``factor`` after each milestone in ``step`` (an
    increasing list of update counts). Closed-form: the lr at update t is
    base_lr * factor^(milestones passed)."""

    def __init__(self, step, factor=1.0, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        if any(s < 1 for s in step):
            raise ValueError("milestones must be positive update counts")
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError("milestones must be strictly increasing")
        if factor > 1.0:
            raise ValueError("a decay factor > 1 would grow the lr")
        self.step = step
        self.factor = factor
        self._decays_logged = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        passed = sum(1 for s in self.step if num_update > s)
        lr = self.base_lr * (self.factor ** passed)
        if passed != self._decays_logged:
            self._decays_logged = passed
            logging.info("lr schedule: update %d -> lr %.5e", num_update, lr)
        return lr
