"""Contrib samplers (the JAX package's ``gluon/contrib/data/sampler.py``;
reference: gluon/contrib/data/sampler.py)."""
from __future__ import annotations

from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """i, i + interval, i + 2 * interval, ... for each start i below
    ``interval`` (only i = 0 without ``rollover``) (reference:
    contrib/data/sampler.py IntervalSampler)."""

    def __init__(self, length, interval, rollover=True):
        assert interval <= length
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            for j in range(i, self._length, self._interval):
                yield j

    def __len__(self):
        return self._length if self._rollover \
            else len(range(0, self._length, self._interval))
