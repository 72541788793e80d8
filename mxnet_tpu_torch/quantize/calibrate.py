"""Post-training-quantization calibration: activation-range observers
over a bound executor.

Counterpart of the JAX package's ``quantize/calibrate.py``: calibration
batches run through the fp32 graph's internals (``get_internals``), and
one observer per internal tensor merges its statistics across batches.
One internals executor is bound per distinct batch shape and re-fed
(``quantize/calib_binds_total`` counts the binds); a dict of this call
holds them, where the JAX package routes them through its compiled-
program registry (ROADMAP A6).

* :class:`MinMaxObserver`: running min/max (the reference's ``naive``
  mode). Given a tensor it reduces on the tensor's device and copies two
  scalars to the host; the result is the numpy one (min and max are
  exact).
* :class:`PercentileObserver`: the range clipped at a percentile of |x|
  (``MXNET_QUANT_PERCENTILE``), from a 2048-bin |x| histogram that grows
  by powers of two across batches; numpy on the host, as in the JAX
  package, so both give the same ranges from the same values.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import telemetry as _tm
from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["MinMaxObserver", "PercentileObserver", "make_observer",
           "collect_activation_ranges"]

# a bare array is one batch of a one-input graph (a numpy array has a
# ``.data`` attribute too, so test the type, not the attribute)
_ARRAYS = (np.ndarray, torch.Tensor, NDArray)


def _host(arr):
    """A numpy array of an NDArray, a tensor or an array-like."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    if hasattr(arr, "asnumpy"):
        return arr.asnumpy()
    return np.asarray(arr)


class MinMaxObserver(object):
    """Running min/max over every observed batch (``naive`` ranges)."""

    __slots__ = ("_mn", "_mx")

    def __init__(self):
        self._mn = None
        self._mx = None

    def observe(self, arr):
        t = arr._data if hasattr(arr, "_data") else arr
        if isinstance(t, torch.Tensor):
            if t.numel() == 0:
                return
            lo, hi = torch.aminmax(t.detach())
            mn, mx = (float(v) for v in torch.stack(
                [lo.float(), hi.float()]).cpu().tolist())
        else:
            a = np.asarray(t)
            if a.size == 0:
                return
            mn, mx = float(a.min()), float(a.max())
        self._mn = mn if self._mn is None else min(self._mn, mn)
        self._mx = mx if self._mx is None else max(self._mx, mx)

    def ranges(self):
        if self._mn is None:
            return (0.0, 0.0)
        return (self._mn, self._mx)


class PercentileObserver(object):
    """Clipped range at a percentile of |x|, merged across batches via a
    histogram over ``[0, bound]`` that doubles its bound (folding old
    counts, bin ``i`` -> ``i // factor``) when a batch exceeds it.
    ``ranges()`` is ``(max(min, -amax_p), min(max, amax_p))``, signs kept
    (a non-negative tensor keeps a 0 lower bound)."""

    __slots__ = ("_p", "_bins", "_counts", "_bound", "_mn", "_mx")

    def __init__(self, percentile=None, bins=2048):
        if percentile is None:
            from ..config import get as _cfg
            percentile = _cfg("MXNET_QUANT_PERCENTILE")
        if not 0.0 < float(percentile) <= 100.0:
            raise MXNetError("percentile must be in (0, 100], got %r"
                             % (percentile,))
        self._p = float(percentile)
        self._bins = int(bins)
        self._counts = None
        self._bound = 0.0
        self._mn = None
        self._mx = None

    def observe(self, arr):
        arr = np.asarray(_host(arr), dtype=np.float32)
        if arr.size == 0:
            return
        self._mn = float(arr.min()) if self._mn is None \
            else min(self._mn, float(arr.min()))
        self._mx = float(arr.max()) if self._mx is None \
            else max(self._mx, float(arr.max()))
        a = np.abs(arr.ravel())
        amax = float(a.max())
        if self._counts is None:
            self._bound = amax if amax > 0 else 1.0
            self._counts = np.histogram(
                a, bins=self._bins, range=(0.0, self._bound)
            )[0].astype(np.int64)
            return
        if amax > self._bound:
            factor = 1
            while self._bound * factor < amax:
                factor *= 2
            if factor >= self._bins:
                # the new bin is wider than the whole old range
                folded = np.zeros(1, np.int64)
                folded[0] = self._counts.sum()
            else:
                folded = self._counts.reshape(self._bins // factor,
                                              factor).sum(axis=1)
            self._counts = np.concatenate(
                [folded, np.zeros(self._bins - folded.size, np.int64)])
            self._bound *= factor
        self._counts += np.histogram(a, bins=self._bins,
                                     range=(0.0, self._bound))[0]

    def ranges(self):
        if self._counts is None:
            return (0.0, 0.0)
        cdf = np.cumsum(self._counts)
        total = int(cdf[-1])
        if total == 0:
            return (min(self._mn, 0.0), max(self._mx, 0.0))
        k = int(np.searchsorted(cdf, total * self._p / 100.0))
        amax = (k + 1) * self._bound / self._bins
        mn = 0.0 if self._mn >= 0 else max(self._mn, -amax)
        mx = 0.0 if self._mx <= 0 else min(self._mx, amax)
        return (mn, mx)


_OBSERVERS = {"minmax": MinMaxObserver, "naive": MinMaxObserver,
              "percentile": PercentileObserver,
              "entropy": PercentileObserver}


def make_observer(mode):
    """Observer factory for a calibration-mode name (``minmax`` /
    ``naive`` -> :class:`MinMaxObserver`; ``percentile`` / ``entropy``
    -> :class:`PercentileObserver`), or a callable passed through."""
    if callable(mode):
        return mode
    try:
        return _OBSERVERS[mode]
    except KeyError:
        raise MXNetError(
            "unknown calibration mode %r (expected one of %s, or an "
            "observer factory)" % (mode, sorted(_OBSERVERS))) from None


def collect_activation_ranges(symbol, arg_params, aux_params, calib_data,
                              data_names=("data",), observer="minmax",
                              num_calib_examples=None, ctx=None):
    """Run calibration batches through the graph's internals on ``ctx``
    (default ``cuda:0``) and merge each internal tensor's statistics;
    returns ``{(node_name, out_idx): (min, max)}``.

    ``calib_data`` yields batches (objects with ``.data`` lists, or bare
    arrays for one-input graphs). One internals executor is bound per
    distinct batch shape and reused across batches of that shape; stops
    once ``num_calib_examples`` rows were seen (None: all of them)."""
    factory = make_observer(observer)
    internals = symbol.get_internals()
    data_names = list(data_names)
    observers = {}
    exe_cache = {}
    seen = 0
    if hasattr(calib_data, "reset"):
        calib_data.reset()
    for batch in calib_data:
        data_list = [batch] if isinstance(batch, _ARRAYS) else batch.data
        shapes = {n: tuple(d.shape) for n, d in zip(data_names, data_list)}
        # seed inference with the known parameter shapes
        for k, v in (arg_params or {}).items():
            shapes.setdefault(k, tuple(v.shape))
        key = tuple(sorted(shapes.items()))
        exe = exe_cache.get(key)
        if exe is None:
            exe = internals.simple_bind(ctx=ctx, grad_req="null", **shapes)
            for k, v in (arg_params or {}).items():
                if k in exe.arg_dict:
                    exe.arg_dict[k][:] = v
            for k, v in (aux_params or {}).items():
                if k in exe.aux_dict:
                    exe.aux_dict[k][:] = v
            _tm.counter("quantize/calib_binds_total",
                        "Calibration internals executors bound (one per "
                        "distinct batch shape)").inc()
            exe_cache[key] = exe
        for n, d in zip(data_names, data_list):
            exe.arg_dict[n][:] = d
        outs = exe.forward(is_train=False)
        for (node, oi), val in zip(internals._entries, outs):
            k = (node.name, oi)
            obs = observers.get(k)
            if obs is None:
                obs = observers[k] = factory()
            # MinMaxObserver reduces on the device; the others see numpy
            obs.observe(val._data if isinstance(obs, MinMaxObserver)
                        else val.asnumpy())
        _tm.counter("quantize/calib_batches_total",
                    "Calibration batches run through the bound internals "
                    "executors").inc()
        seen += int(data_list[0].shape[0])
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    if not observers:
        raise MXNetError("calibration saw no batches; calib_data is empty")
    return {k: obs.ranges() for k, obs in observers.items()}
