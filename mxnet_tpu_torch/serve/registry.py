"""Model hot-swap: atomic engine replacement with zero dropped requests,
plus quantized-variant rollout (shadow A/B canary -> int8 flip).

A serving deployment updates weights (a new checkpoint from the training
fleet) without a restart: :meth:`ModelRegistry.swap` builds a NEW
:class:`InferenceEngine` from the new params blob, warms every bucket
(its kernels built before the swap — traffic never waits on one), atomically
replaces the active engine, and gracefully drains the old one. Requests
already queued on the old engine flush through the old weights; requests
arriving after the swap run the new ones; nothing is dropped. The
rollout is observable via ``serving/swaps_total`` and the standard
engine metrics.

Counterpart of the JAX package's ``serve/registry.py``: the same swap,
drain, shadow sampling stream and metrics. Its engines run where the
port's ``serving.Predictor`` binds by default, the card
(``dev_type=None``); ``dev_type=1`` keeps them on the host.

**Quantized serving** rides the same machinery (``quantize/``):

* ``swap(quantized=artifact)`` — hot-swap to a calibrated int8
  :class:`~mxnet_tpu_torch.quantize.ptq.QuantizedParams` artifact (its graph
  differs from the fp32 one, so the artifact carries its own symbol);
  drain semantics are IDENTICAL to a weight swap, and ``swap(bytes)``
  later rolls back to fp32.
* :meth:`enable_shadow` — before flipping, canary the artifact under
  REAL traffic: a configurable fraction of live requests is mirrored
  to a warmed shadow engine, per-request output drift lands in the
  ``quantize/shadow_drift`` histogram (surfaced on ``/metrics``) and a
  ``serve.shadow`` span in the request's trace (``/traces``). Shadow
  compares run on a side thread — they never add latency to, or fail,
  the primary request.
"""
from __future__ import annotations

import random as _random
import threading
from collections import deque

from .. import telemetry as _tm
from .. import tracing as _tr
from ..base import MXNetError
from .engine import EngineClosedError, InferenceEngine, ServeConfig

__all__ = ["ModelRegistry"]

# drift is an output-magnitude delta, not a latency: give the histogram
# magnitude-scaled buckets (a softmax-head drift of 1e-3 and a logit
# drift of 0.5 must land in different cells)
_DRIFT_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0)

# compare-backlog bound: one compare thread drains pairs with blocking
# result() waits, so a shadow engine slower than the primary would
# otherwise grow the queue (and pin every entry's arrays) without limit
# on a long canary — past the bound new mirrors are dropped and counted
_SHADOW_PENDING_MAX = 256


def _resolve_quantized(quantized):
    """(symbol_json, param_bytes) from a QuantizedParams-like artifact,
    an on-disk artifact prefix, or an explicit pair."""
    if isinstance(quantized, str):
        from ..quantize.ptq import QuantizedParams
        quantized = QuantizedParams.load(quantized)
    if hasattr(quantized, "symbol_json") and hasattr(quantized,
                                                    "param_bytes"):
        return quantized.symbol_json, quantized.param_bytes()
    if isinstance(quantized, tuple) and len(quantized) == 2:
        return quantized
    raise MXNetError(
        "quantized= expects a QuantizedParams artifact, an artifact "
        "prefix, or a (symbol_json, param_bytes) pair; got %r"
        % type(quantized).__name__)


class ModelRegistry(object):
    """Owns the live engine for one model and swaps it atomically.

    Parameters mirror :class:`serving.Predictor`: the symbol stays fixed
    across weight swaps (a quantized swap substitutes the artifact's own
    rewritten symbol), the params blob is what rotates.
    """

    def __init__(self, symbol_json, param_bytes, input_shapes,
                 dev_type=None, dev_id=0, input_types=None, config=None):
        self._symbol_json = symbol_json
        self._input_shapes = dict(input_shapes)
        self._dev = (dev_type, dev_id)
        self._input_types = input_types
        self._cfg = config or ServeConfig()
        self._lock = threading.Lock()
        self._decode = None
        self._m_swaps = _tm.counter(
            "serving/swaps_total", "Model hot-swaps completed")
        # shadow A/B state: mirrored requests are sampled from a PRIVATE
        # stream (tracing.py discipline: user random.seed() streams must
        # never diverge because shadow mode is on)
        self._shadow = None
        self._shadow_fraction = 0.0
        self._shadow_rng = _random.Random(0x5AD0)
        self._shadow_pending = deque()
        self._shadow_cond = threading.Condition()
        self._shadow_thread = None
        self._shadow_drifts = deque(maxlen=512)
        self._quantized_active = False
        self._engine = self._build(param_bytes)

    def _build(self, param_bytes, symbol_json=None):
        from ..serving import Predictor
        pred = Predictor(symbol_json or self._symbol_json, param_bytes,
                         dev_type=self._dev[0], dev_id=self._dev[1],
                         input_shapes=self._input_shapes,
                         input_types=self._input_types)
        return InferenceEngine(pred, self._cfg).start()

    # -- engine access -----------------------------------------------------
    def engine(self):
        """The CURRENT engine (atomic read; may be superseded by a
        concurrent swap — use :meth:`submit`/:meth:`predict`, which
        retry across swaps, unless you hold it only briefly)."""
        with self._lock:
            return self._engine

    @property
    def ready(self):
        return self.engine().ready

    @property
    def quantized_active(self):
        """Whether the live engine is serving a quantized variant."""
        return self._quantized_active

    def warmup(self):
        self.engine().warmup()
        return self

    def submit(self, feed, timeout_ms=None, ctx=None):
        """Engine submit that is safe across a concurrent swap: a
        request refused because ITS engine started draining re-routes
        to the replacement instead of surfacing a 503. With shadow mode
        on, a sampled fraction of accepted requests is also mirrored to
        the shadow engine (drift recorded asynchronously; mirror
        failures never surface to the caller)."""
        while True:
            eng = self.engine()
            try:
                req = eng.submit(feed, timeout_ms, ctx=ctx)
                break
            except EngineClosedError:
                if self.engine() is eng:     # closed for real, no swap
                    raise
                # else: swapped between the read and the submit; retry
        shadow = self._shadow
        if shadow is not None \
                and self._shadow_rng.random() < self._shadow_fraction:
            self._mirror(shadow, req, feed, timeout_ms, ctx)
        return req

    def predict(self, feed, timeout_ms=None):
        return self.submit(feed, timeout_ms).result()

    # -- shadow A/B --------------------------------------------------------
    def _mirror(self, shadow, req, feed, timeout_ms, ctx):
        if len(self._shadow_pending) >= _SHADOW_PENDING_MAX:
            # compare thread is behind (shadow slower than primary):
            # shed the sample BEFORE submitting to the shadow engine
            _tm.counter("quantize/shadow_dropped_total",
                        "Shadow mirrors dropped (shadow engine "
                        "saturated, closed, or compare backlog "
                        "full)").inc()
            return
        try:
            sreq = shadow.submit(feed, timeout_ms, ctx=ctx)
        except MXNetError:
            # shadow saturated/closed: the canary drops a sample, the
            # primary request is untouched
            _tm.counter("quantize/shadow_dropped_total",
                        "Shadow mirrors dropped (shadow engine "
                        "saturated, closed, or compare backlog "
                        "full)").inc()
            return
        _tm.counter("quantize/shadow_requests_total",
                    "Requests mirrored to the shadow engine").inc()
        with self._shadow_cond:
            self._shadow_pending.append(
                (req, sreq, ctx if ctx is not None else _tr.active(),
                 _tm.monotonic()))
            self._shadow_cond.notify()

    def enable_shadow(self, quantized, fraction=None):
        """Mirror a fraction of live requests to a shadow engine built
        from ``quantized`` (a QuantizedParams artifact / artifact
        prefix / ``(symbol_json, param_bytes)`` pair) — the int8 canary
        under real traffic.

        The shadow engine is built and WARMED here (its kernel builds and
        first launches land before any mirror runs, so shadow mode adds
        none to live traffic). Each mirrored request's outputs are compared
        against the primary's on a side thread: the max absolute
        element difference lands in ``quantize/shadow_drift`` (exposed
        on ``/metrics``) and as a ``serve.shadow`` span in the
        request's trace. ``fraction`` defaults to
        ``MXNET_SERVE_SHADOW_FRACTION``. Returns the shadow engine.
        """
        from ..config import get as _cfg
        if fraction is None:
            fraction = float(_cfg("MXNET_SERVE_SHADOW_FRACTION"))
        if not 0.0 <= fraction <= 1.0:
            raise MXNetError("shadow fraction must be in [0, 1], got %r"
                             % (fraction,))
        if self._shadow is not None:
            raise MXNetError("shadow mode already enabled; "
                             "disable_shadow() first")
        symbol_json, param_bytes = _resolve_quantized(quantized)
        eng = self._build(param_bytes, symbol_json=symbol_json)
        eng.warmup()
        # register the drift instruments HERE (first registration wins
        # the bucket layout) so they carry magnitude buckets however a
        # scraper races the first mirror
        _tm.histogram(
            "quantize/shadow_drift",
            "Max abs output difference, shadowed quantized engine vs "
            "primary, per mirrored request", buckets=_DRIFT_BUCKETS)
        with self._shadow_cond:
            # a fresh canary must not score pairs left over from a
            # previous one (a mirror that raced disable_shadow would
            # otherwise feed OLD-engine drift into the NEW histogram)
            self._shadow_pending.clear()
            self._shadow_drifts.clear()
            self._shadow_fraction = float(fraction)
            self._shadow = eng
            if self._shadow_thread is None \
                    or not self._shadow_thread.is_alive():
                self._shadow_thread = threading.Thread(
                    target=self._shadow_main, name="mxnet-serve-shadow",
                    daemon=True)
                self._shadow_thread.start()
        return eng

    def disable_shadow(self, drain_timeout=30.0):
        """Stop mirroring and tear the shadow engine down (pending
        comparisons finish first — their drift still lands)."""
        with self._shadow_cond:
            eng, self._shadow = self._shadow, None
            self._shadow_fraction = 0.0
            self._shadow_cond.notify_all()
        if eng is None:
            return
        thread = self._shadow_thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=drain_timeout)
        self._shadow_thread = None
        eng.close(drain=True, timeout=drain_timeout)

    def shadow_report(self):
        """Operator summary of the canary so far: mirrored count and
        drift percentiles over the recent window (the full history
        lives in the ``quantize/shadow_drift`` histogram)."""
        drifts = sorted(self._shadow_drifts)

        def pct(p):
            if not drifts:
                return None
            return drifts[min(len(drifts) - 1,
                              int(p / 100.0 * len(drifts)))]

        fam = _tm.REGISTRY._families.get("quantize/shadow_drift")
        count = sum(c.count for _lv, c in fam.series()) if fam else 0
        return {"active": self._shadow is not None,
                "fraction": self._shadow_fraction,
                "compared_total": count,
                "window": len(drifts),
                "drift_max": drifts[-1] if drifts else None,
                "drift_p50": pct(50), "drift_p99": pct(99)}

    def _shadow_main(self):
        """Compare worker: waits for (primary, shadow) result pairs and
        records drift. Exits once shadow mode is disabled AND the
        pending queue is drained."""
        hist = _tm.histogram(
            "quantize/shadow_drift",
            "Max abs output difference, shadowed quantized engine vs "
            "primary, per mirrored request", buckets=_DRIFT_BUCKETS)
        errs = _tm.counter(
            "quantize/shadow_errors_total",
            "Shadow comparisons that failed (either side errored)")
        while True:
            with self._shadow_cond:
                while not self._shadow_pending:
                    if self._shadow is None:
                        return
                    self._shadow_cond.wait(0.1)
                req, sreq, ctx, t0 = self._shadow_pending.popleft()
            try:
                a = req.result()
                b = sreq.result()
                drift = 0.0
                for x, y in zip(a, b):
                    d = abs(x.astype("float32") - y.astype("float32"))
                    drift = max(drift, float(d.max()) if d.size else 0.0)
            except MXNetError:
                errs.inc()
                continue
            t1 = _tm.monotonic()
            hist.observe(drift,
                         trace_id=ctx.trace_id if ctx is not None else None)
            self._shadow_drifts.append(drift)
            if ctx is not None and ctx.sampled:
                _tr.record_span("serve.shadow", ctx, t0, t1,
                                attrs={"drift": drift})

    # -- decode attachment -------------------------------------------------
    def attach_decode(self, engine):
        """Attach a :class:`~mxnet_tpu_torch.serve.decode.DecodeEngine`
        serving this model's autoregressive traffic. :meth:`swap` then
        DRAINS its decode sessions before the hot-swap (every in-flight
        generation finishes before the flip; pass ``decode_params`` to
        rotate the decode weights inside the same quiesced window), and
        :func:`serve_http` routes ``POST /generate`` to it."""
        self._decode = engine
        return engine

    def decode_engine(self):
        """The attached decode engine, or None."""
        return self._decode

    # -- lifecycle ---------------------------------------------------------
    def swap(self, param_bytes=None, drain_timeout=30.0,
             decode_params=None, quantized=None):
        """Hot-swap the serving variant with zero dropped requests.

        ``param_bytes`` rotates the weights under the registry's fixed
        symbol (the classic weight swap). ``quantized=`` swaps to a
        calibrated int8 artifact instead (QuantizedParams / artifact
        prefix / ``(symbol_json, param_bytes)``): the artifact's own
        rewritten symbol builds the replacement engine, everything else
        — warm-before-flip, decode drain, old-engine drain — is
        UNCHANGED; a later ``swap(param_bytes)`` rolls back to fp32.

        Builds + warms the replacement engine while the old one keeps
        serving, DRAINS any attached decode engine's sessions BEFORE
        the flip (each in-flight generation finishes on the weights it
        started with; new ``/generate`` admissions 503 for the drain
        window), flips the active reference atomically, then drains the
        old engine (its queued requests complete on the old weights).

        ``decode_params``: the decode engine's new
        ``TransformerParams`` (its weights are a separate artifact from
        the predictor blob). When given, they rotate inside the quiesced window — the
        predictor flip and the decode weights move together, so no
        generation and no scoring batch ever mixes versions. When
        omitted, the decode engine keeps its current weights (the drain
        still quiesces decode across the flip); call
        ``DecodeEngine.swap_params`` separately if they rotate on their
        own cadence. Returns the new engine."""
        if (param_bytes is None) == (quantized is None):
            raise MXNetError(
                "swap needs exactly one of param_bytes (fp32 weight "
                "rotation) or quantized= (int8 artifact)")
        if quantized is not None:
            symbol_json, param_bytes = _resolve_quantized(quantized)
            new = self._build(param_bytes, symbol_json=symbol_json)
        else:
            new = self._build(param_bytes)
        try:
            new.warmup()        # kernel builds and plans land BEFORE the flip
        except Exception:
            # failed rollout must not leak the replacement's workers or
            # its device weight copy; the old engine keeps serving
            new.close(drain=False)
            raise
        decode = self._decode
        if decode is not None:
            # decode sessions drain BEFORE the flip: generation state
            # (the KV cache) is weight-coupled in a way stateless
            # predict batches are not
            if not decode.pause(drain=True, timeout=drain_timeout):
                decode.resume()
                new.close(drain=False)
                raise MXNetError(
                    "decode sessions did not drain within %.1fs; "
                    "swap aborted, old weights still serving"
                    % drain_timeout)
            if decode_params is not None:
                # engine is idle (paused + drained): a plain rebind is
                # race-free
                decode._params = decode_params.to(decode._device)
        try:
            with self._lock:
                old, self._engine = self._engine, new
                self._quantized_active = quantized is not None
        finally:
            if decode is not None:
                decode.resume()
        self._m_swaps.inc()
        if quantized is not None:
            _tm.counter("quantize/swaps_total",
                        "Hot-swaps to a quantized int8 variant").inc()
        try:
            from .. import blackbox as _bb
            _bb.record_event("swap", quantized=quantized is not None,
                             decode_rotated=decode_params is not None)
        except Exception:
            pass
        old.close(drain=True, timeout=drain_timeout)
        return new

    def close(self, drain=True, timeout=30.0):
        self.disable_shadow(drain_timeout=timeout)
        if self._decode is not None:
            self._decode.close(drain=drain, timeout=timeout)
        self.engine().close(drain=drain, timeout=timeout)
