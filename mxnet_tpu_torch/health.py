"""Production health layer: live roofline accounting, numerics
sentinels, and an SLO alert engine.

Counterpart of the JAX package's ``health.py``, with its metric names,
rule set, burn-window semantics, ``/alerts`` payload and numerics
policies; the flight recorder it writes to is ``blackbox.py``.

1. **Live MFU / roofline accounting** -- each hot-path program (an
   executor forward, the fused train step, a serve bucket, a decode
   prefill or step bucket) registers a cost record ``{"flops",
   "bytes"}`` once; measured wall times then become ``executor/mfu`` /
   ``executor/hbm_bw_util``, ``serving/mfu{bucket}`` and
   ``decode/mfu{phase,bucket}`` on ``/metrics``. The JAX package reads
   the record from XLA's cost pass (``jitted.lower().cost_analysis()``);
   the port has no compiler pass over the hand-written kernels
   (``torch.utils.flop_counter`` does not see them either), so it counts
   the work itself: :func:`symbol_cost` prices a bound Symbol's ops at
   their inferred shapes (a convolution ``2 N C_out H_out W_out
   (C_in/g) k_h k_w``, a fully connected layer ``2 N in out``, the int8
   ops the same products, every other op its output elements; bytes are
   each op's inputs and outputs once), :func:`transformer_cost` a decode
   prefill or step from the model config and the bucket's tokens and
   context, and the fused train step is its forward times 3.
   :func:`capture_cost` registers a count under the JAX package's
   (kind, key) table, with the counters
   ``health/programs_captured_total`` and
   ``health/cost_analysis_unavailable_total``.
2. **Numerics sentinels** -- ``MXNET_NUMERICS=off|step|full``: the
   fused train step reduces the loss proxy, the global gradient norm and
   the nonfinite count on the device into one small vector, fetched one
   step later (the host never waits on the step in flight);
   :func:`check_numerics` applies the policy (``warn | raise |
   checkpoint-and-raise``) and leaves a flight-recorder record first.
3. **SLO engine** -- declarative :func:`watch` rules evaluated by one
   background daemon thread with multi-window burn-rate semantics,
   surfaced at ``/alerts`` on both ``telemetry.serve()`` and
   ``serve.serve_http``; every transition is recorded as a span, a
   counter and a flight-recorder event. A rule over a series the port
   does not write yet (``kvstore/giveups_total``,
   ``goodput/badput_fraction``) stays ``ok``.

Peaks (the MFU and bandwidth denominators) keep the JAX package's knob
names, ``MXNET_TPU_PEAK_FLOPS`` and ``MXNET_TPU_PEAK_HBM_GBPS``; their
defaults here are the spec-sheet figures of an NVIDIA H100 80GB HBM3
(SXM5, 700 W): 989.4e12 FLOP/s dense bf16 and 3350 GB/s.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque

from .base import MXNetError

__all__ = ["NumericsError", "capture_cost", "register_cost",
           "symbol_cost", "transformer_cost", "next_cost_key",
           "program_cost", "programs",
           "note_executor_step", "note_serve_batch", "note_decode",
           "note_mfu_divergence",
           "peak_flops", "peak_hbm_bytes_per_s", "mfu_summary",
           "numerics_mode", "set_numerics", "numerics_policy",
           "set_numerics_policy", "set_spike_factor", "check_numerics",
           "numerics_trips", "watch", "unwatch", "rules",
           "evaluate_once", "alerts_payload", "alerts_endpoint",
           "alerts_firing", "ensure_evaluator", "set_interval",
           "stop_evaluator", "reset"]

_monotonic = time.perf_counter
_log = logging.getLogger("mxnet_tpu_torch.health")


def _config(name, fallback):
    try:
        from .config import get
        v = get(name)
        return fallback if v is None else v
    except Exception:
        return fallback


def _tm():
    from . import telemetry
    return telemetry


# ---------------------------------------------------------------------------
# pillar 1: roofline accounting from compiled cost analysis
# ---------------------------------------------------------------------------

# (kind, key) -> {"flops", "bytes", "captured_s"} | None (= capture
# attempted and unavailable on this backend: don't retry per call).
# This table is the diagnostics/aggregation view; the AUTHORITATIVE
# record for a program is the one its owner (executor, engine) holds —
# owners pass records by reference, so eviction here never skews a
# gauge. Bounded: oldest entries drop past _COSTS_CAP (long-lived
# serving with repeated swaps must not grow it without bound).
_costs = {}
_costs_lock = threading.Lock()
_COSTS_CAP = 512
_seq = 0


def next_cost_key(prefix):
    """A process-unique cost key (``prefix:N``). Callers must NOT key
    captures by ``id(self)`` — CPython reuses addresses after GC, and
    a reused id would make capture_cost hand a dead program's record
    to a new one."""
    global _seq
    with _costs_lock:
        _seq += 1
        return "%s:%d" % (prefix, _seq)

_KINDS = ("executor_forward", "fused_step", "serve_bucket",
          "decode_prefill", "decode_step")


def peak_flops():
    """Peak FLOP/s for MFU denominators: ``MXNET_TPU_PEAK_FLOPS`` (the
    JAX package's knob), by default the spec-sheet dense bf16 figure of
    an NVIDIA H100 80GB HBM3 (SXM5, 700 W), 989.4e12."""
    return float(_config("MXNET_TPU_PEAK_FLOPS", 989.4e12))


def peak_hbm_bytes_per_s():
    """Peak device-memory bandwidth (``MXNET_TPU_PEAK_HBM_GBPS``, by
    default the H100 80GB HBM3 spec sheet's 3350 GB/s) for the
    bytes-accessed roofline axis."""
    return float(_config("MXNET_TPU_PEAK_HBM_GBPS", 3350.0)) * 1e9


def capture_cost(kind, key, count, args=(), kwargs=None):
    """Register the cost record of one program.

    ``count(*args, **kwargs)`` returns ``{"flops", "bytes"}`` (what
    :func:`symbol_cost` and :func:`transformer_cost` give), the port's
    counterpart of the JAX package's XLA cost pass; it runs once per
    (kind, key). Returns the stored record, or None when the count fails
    or finds no FLOPs (counted in
    ``health/cost_analysis_unavailable_total``: the MFU gauges then
    never appear)."""
    if kind not in _KINDS:
        raise MXNetError("unknown cost kind %r (known: %s)"
                         % (kind, ", ".join(_KINDS)))
    ck = (kind, str(key))
    with _costs_lock:
        if ck in _costs:
            return _costs[ck]
    tm = _tm()
    rec = None
    try:
        got = count(*args, **(kwargs or {}))
        flops = float(got.get("flops", 0.0)) if got else 0.0
        nbytes = float(got.get("bytes", 0.0)) if got else 0.0
        if flops > 0:
            rec = {"flops": flops, "bytes": nbytes,
                   "captured_s": round(time.time(), 3)}
    except Exception as e:           # a graph the counter cannot price
        _log.debug("cost count unavailable for %s/%s: %s", kind, key, e)
    with _costs_lock:
        _costs[ck] = rec
        while len(_costs) > _COSTS_CAP:
            _costs.pop(next(iter(_costs)))
    if rec is None:
        if tm._enabled:
            tm.counter("health/cost_analysis_unavailable_total",
                       "Programs whose cost could not be counted (MFU "
                       "gauges degrade to absent)",
                       ("kind",)).labels(kind).inc()
    elif tm._enabled:
        tm.counter("health/programs_captured_total",
                   "Programs with a cost record registered (flops + "
                   "bytes accessed)", ("kind",)).labels(kind).inc()
    return rec


# ops that only relabel their input's memory: no arithmetic
_FREE_OPS = frozenset((
    "Flatten", "flatten", "Reshape", "reshape", "expand_dims", "squeeze",
    "transpose", "SwapAxis", "swapaxes", "BlockGrad", "stop_gradient",
    "identity", "_copy", "slice", "slice_axis", "slice_like", "crop",
    "Concat", "concat", "split", "SliceChannel", "_contrib_quantized_flatten",
    "zeros_like", "ones_like", "_zeros", "_ones", "_full", "Cast", "cast"))
_CONV_OPS = frozenset(("Convolution", "_contrib_quantized_conv",
                       "_contrib_quantized_conv_int8"))
_FC_OPS = frozenset(("FullyConnected", "_contrib_quantized_fully_connected",
                     "_contrib_quantized_fc_int8"))


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def symbol_cost(symbol, shapes, itemsizes=None, deduced=None):
    """``{"flops", "bytes"}`` of one forward of ``symbol`` with its
    variables at ``shapes`` (name -> shape: every argument and auxiliary
    state, as an executor binds them). ``itemsizes`` (name -> bytes a
    value) prices the variables' bytes, 4 otherwise; op outputs count 4.

    FLOPs: a convolution (float or int8) ``2 * numel(out) * numel(w) /
    C_out`` (= ``2 N C_out H_out W_out (C_in/g) k_h k_w``), a
    deconvolution ``2 * numel(in) * numel(w) / C_in``, a fully
    connected layer ``2 * rows * in * out``,
    ``dot`` / ``batch_dot`` ``2 * numel(out) * K``, every other op the
    elements it writes (0 for ops that only relabel memory). Bytes: each
    op's inputs read once and outputs written once. ``deduced``:
    ``_deduce_shapes``' (leaf shapes, node output shapes) of these
    shapes, where the caller has them (a ``simple_bind`` executor)."""
    from .symbol.symbol import _deduce_shapes, _topo
    itemsizes = itemsizes or {}
    shapes = {k: tuple(int(d) for d in v) for k, v in shapes.items()}
    if deduced is not None and all(
            deduced[0].get(k) == v for k, v in shapes.items()):
        outs = deduced[1]
    else:
        _, outs = _deduce_shapes(symbol, shapes)
    flops = 0.0
    nbytes = 0.0

    def entry(src, oi):
        if src.is_var:
            return shapes[src.name], itemsizes.get(src.name, 4)
        return outs[(id(src), oi)], 4

    for node in _topo(symbol._entries):
        if node.is_var:
            continue
        ins = [entry(s, oi) for s, oi in node.inputs]
        out_shapes = []
        i = 0
        while (id(node), i) in outs:
            out_shapes.append(outs[(id(node), i)])
            i += 1
        out0 = out_shapes[0] if out_shapes else ()
        op = node.op
        if op in _CONV_OPS and len(ins) > 1:
            w = ins[1][0]
            flops += 2.0 * _numel(out0) * _numel(w[1:])
        elif op == "Deconvolution" and len(ins) > 1:
            w = ins[1][0]
            flops += 2.0 * _numel(ins[0][0]) * _numel(w[1:])
        elif op in _FC_OPS and len(ins) > 1:
            w = ins[1][0]
            flops += 2.0 * _numel(out0) * int(w[1])
        elif op in ("dot", "batch_dot") and len(ins) > 1:
            a = ins[0][0]
            ta = bool(node.attrs.get("transpose_a", False))
            k = a[-2] if ta else a[-1]
            flops += 2.0 * _numel(out0) * int(k)
        elif op not in _FREE_OPS:
            flops += float(sum(_numel(s) for s in out_shapes))
        if op in _FREE_OPS:
            continue
        nbytes += sum(_numel(s) * size for s, size in ins)
        nbytes += sum(_numel(s) * 4 for s in out_shapes)
    return {"flops": flops, "bytes": nbytes}


def transformer_cost(cfg, phase, rows, tokens, context, itemsize=4):
    """``{"flops", "bytes"}`` of one decode-path program of a
    ``parallel.transformer.TransformerConfig`` model. ``phase``
    ``"prefill"``: ``rows`` prompts of ``tokens`` (the bucket) positions,
    each attending over the bucket (``context`` = ``tokens``), logits at
    one position a row. ``"step"``: ``rows`` slots of one token, each
    attending over ``context`` positions (the block table's width),
    logits a row. Per layer and token: the q/k/v and output projections
    ``2 d (d + 2 d_kv) + 2 d d``, the FFN ``4 d d_ff`` (top_k of them and
    the router's ``2 d E`` for a mixture of experts), attention ``4 d
    context``; the tied output projection ``2 d V`` a logit row. Bytes:
    the weights once, the K/V cache written (prefill) or read over the
    context (step), the activations in and out."""
    if phase not in ("prefill", "step"):
        raise MXNetError("phase must be 'prefill' or 'step', got %r"
                         % (phase,))
    d, f, V, L = (int(cfg.d_model), int(cfg.d_ff), int(cfg.vocab_size),
                  int(cfg.n_layers))
    heads = int(cfg.n_heads)
    kvd = int(cfg.n_kv_heads or heads) * (d // heads)
    ffn, ffn_w = 4.0 * d * f, 2.0 * d * f
    if cfg.num_experts:
        e = int(cfg.num_experts)
        ffn = ffn * int(cfg.moe_top_k) + 2.0 * d * e
        ffn_w = ffn_w * e + d * e
    n_tok = rows * (tokens if phase == "prefill" else 1)
    per_tok = (2.0 * d * (d + 2 * kvd) + 2.0 * d * d + ffn
               + 4.0 * d * context)
    flops = L * n_tok * per_tok + 2.0 * rows * d * V
    weights = L * (d * (d + 2 * kvd) + d * d + ffn_w) + V * d
    kv = 2.0 * L * kvd * (n_tok if phase == "prefill" else rows * context)
    act = 2.0 * L * n_tok * d + rows * V
    return {"flops": flops, "bytes": (weights + kv + act) * itemsize}


def register_cost(kind, key, rec):
    """Alias an already-captured record under another (kind, key): the
    serve engine maps its batch bucket onto the bound executor's forward
    record instead of counting the graph twice."""
    if kind not in _KINDS:
        raise MXNetError("unknown cost kind %r (known: %s)"
                         % (kind, ", ".join(_KINDS)))
    with _costs_lock:
        _costs[(kind, str(key))] = rec
        while len(_costs) > _COSTS_CAP:
            _costs.pop(next(iter(_costs)))
    return rec


def program_cost(kind, key):
    """The stored cost record for one program, or None."""
    with _costs_lock:
        return _costs.get((kind, str(key)))


def programs():
    """Snapshot of every captured program: {(kind, key): record}."""
    with _costs_lock:
        return dict(_costs)


def _util(rec, seconds):
    """(mfu, hbm_bw_util) of one program execution, or None."""
    if rec is None or seconds is None or seconds <= 0:
        return None
    return (rec["flops"] / seconds / peak_flops(),
            rec["bytes"] / seconds / peak_hbm_bytes_per_s())


def note_executor_step(rec, seconds):
    """Bank one measured fused-step wall time against its program's
    cost record: sets ``executor/mfu`` and ``executor/hbm_bw_util``."""
    util = _util(rec, seconds)
    if util is None:
        return None
    tm = _tm()
    if tm._enabled:
        tm.gauge("executor/mfu",
                 "Model FLOP/s utilization of the fused train step "
                 "(counted FLOPs / step wall / "
                 "MXNET_TPU_PEAK_FLOPS)").set(util[0])
        tm.gauge("executor/hbm_bw_util",
                 "HBM roofline utilization of the fused train step "
                 "(bytes accessed / step wall / peak bandwidth)"
                 ).set(util[1])
    return util


def note_serve_batch(bucket, seconds, rec):
    """Per-serve-bucket MFU from one executed batch's compute wall.
    ``rec`` is the OWNING engine's cost record for this bucket (passed
    by reference, never looked up globally: with two live engines —
    shadow A/B, or the draining old engine during a swap — a global
    bucket lookup would price one engine's batches with the other's
    FLOPs). The gauge label is still just the bucket: concurrent
    engines last-writer-win the gauge, but each write is priced with
    its own program's cost."""
    util = _util(rec, seconds)
    if util is None:
        return None
    tm = _tm()
    if tm._enabled:
        tm.gauge("serving/mfu",
                 "Per-bucket MFU of the serve forward (counted FLOPs "
                 "/ compute wall / peak)", ("bucket",)
                 ).labels(str(bucket)).set(util[0])
        tm.gauge("serving/hbm_bw_util",
                 "Per-bucket HBM roofline utilization of the serve "
                 "forward", ("bucket",)).labels(str(bucket)).set(util[1])
    return util


def note_decode(phase, bucket, seconds, rec):
    """Decode-path MFU: ``phase`` is ``prefill`` or ``step``, labeled
    by its prefill/slot bucket; ``rec`` is the owning engine's cost
    record for that program (by reference, like note_serve_batch)."""
    util = _util(rec, seconds)
    if util is None:
        return None
    tm = _tm()
    if tm._enabled:
        tm.gauge("decode/mfu",
                 "Decode-path MFU per program (prefill buckets and "
                 "slot-count step buckets)", ("phase", "bucket")
                 ).labels(phase, str(bucket)).set(util[0])
    return util


def note_mfu_divergence(est, measured):
    """Bank the measured-vs-hand-counted MFU divergence as a proper
    gauge (``health/mfu_divergence`` = |measured/est - 1|) so it shows
    on ``/metrics`` and the default ``mfu_divergence`` SLO rule can
    fire ``/alerts`` — instead of the warning living only inside bench
    records (benchmark._note_mfu_divergence calls this). Returns the
    ratio, or None when either side is missing."""
    try:
        est, measured = float(est or 0.0), float(measured or 0.0)
    except (TypeError, ValueError):
        return None
    if est <= 0.0 or measured <= 0.0:
        return None
    ratio = measured / est
    tm = _tm()
    if tm._enabled:
        tm.gauge("health/mfu_divergence",
                 "Absolute divergence |measured/est - 1| between the "
                 "gauge MFU (the health layer's counted FLOPs) and the "
                 "hand-counted estimate of the same bench run; the "
                 "mfu_divergence SLO rule fires past "
                 "MXNET_SLO_MFU_DIVERGENCE").set(abs(ratio - 1.0))
    return ratio


def mfu_summary():
    """One-shot roofline summary for diagnostics(): current gauges plus
    the captured-program table."""
    tm = _tm()
    out = {"peak_flops": peak_flops(),
           "peak_hbm_gbps": round(peak_hbm_bytes_per_s() / 1e9, 1),
           "programs": {}, "unavailable": 0}
    with _costs_lock:
        for (kind, key), rec in sorted(_costs.items()):
            if rec is None:
                out["unavailable"] += 1
                continue
            out["programs"]["%s/%s" % (kind, key)] = {
                "gflops": round(rec["flops"] / 1e9, 3),
                "mbytes": round(rec["bytes"] / 1e6, 3)}
    for metric, field in (("executor/mfu", "executor_mfu"),
                          ("executor/hbm_bw_util", "executor_hbm_bw")):
        fam = tm.REGISTRY._families.get(metric)
        if fam is not None:
            series = fam.series()
            if series:
                out[field] = round(series[0][1].value, 6)
    fam = tm.REGISTRY._families.get("serving/mfu")
    if fam is not None:
        out["serve_bucket_mfu"] = {
            lv[0]: round(c.value, 6) for lv, c in fam.series()}
    fam = tm.REGISTRY._families.get("health/mfu_divergence")
    if fam is not None:
        series = fam.series()
        if series:
            out["mfu_divergence"] = round(series[0][1].value, 4)
    return out


# ---------------------------------------------------------------------------
# pillar 2: numerics sentinels (policy side; the device side lives in
# Executor.train_step)
# ---------------------------------------------------------------------------

class NumericsError(MXNetError):
    """A numerics sentinel tripped under policy ``raise`` /
    ``checkpoint-and-raise``. Carries the step's ``report`` dict."""

    def __init__(self, msg, report=None):
        super().__init__(msg)
        self.report = report or {}


_MODES = ("off", "step", "full")
_POLICIES = ("warn", "raise", "checkpoint-and-raise")

_numerics_mode = str(_config("MXNET_NUMERICS", "off")).lower()
if _numerics_mode not in _MODES:
    raise MXNetError("MXNET_NUMERICS must be one of %s, got %r"
                     % ("|".join(_MODES), _numerics_mode))
_numerics_policy = str(_config("MXNET_NUMERICS_POLICY", "warn")).lower()
if _numerics_policy not in _POLICIES:
    raise MXNetError("MXNET_NUMERICS_POLICY must be one of %s, got %r"
                     % ("|".join(_POLICIES), _numerics_policy))
_spike_factor = float(_config("MXNET_NUMERICS_SPIKE", 0.0))


def numerics_mode():
    return _numerics_mode


def set_numerics(mode):
    """Set the sentinel mode (also: ``MXNET_NUMERICS``). Returns the
    previous mode; the next fused step reads it."""
    global _numerics_mode
    mode = str(mode).lower()
    if mode not in _MODES:
        raise MXNetError("numerics mode must be one of %s, got %r"
                         % ("|".join(_MODES), mode))
    prev, _numerics_mode = _numerics_mode, mode
    return prev


def numerics_policy():
    return _numerics_policy


def set_numerics_policy(policy):
    """Set the trip policy (also: ``MXNET_NUMERICS_POLICY``). Returns
    the previous policy."""
    global _numerics_policy
    policy = str(policy).lower()
    if policy not in _POLICIES:
        raise MXNetError("numerics policy must be one of %s, got %r"
                         % ("|".join(_POLICIES), policy))
    prev, _numerics_policy = _numerics_policy, policy
    return prev


def set_spike_factor(factor):
    """Grad-norm spike threshold: a step whose global grad norm exceeds
    ``factor``x the running EMA trips the policy. 0 disables spike
    detection (nonfinite detection stays on). Returns the previous
    factor."""
    global _spike_factor
    prev, _spike_factor = _spike_factor, max(0.0, float(factor))
    return prev


def numerics_trips():
    """Total sentinel trips this process (snapshot field)."""
    tm = _tm()
    fam = tm.REGISTRY._families.get("health/numerics_trips_total")
    if fam is None:
        return 0
    return sum(c.value for _lv, c in fam.series())


def check_numerics(report, state=None, where="train_step"):
    """Apply the numerics policy to one step's sentinel ``report``:
    ``{"loss", "grad_norm", "nonfinite", ["per_param"]}`` (host floats,
    read from the fused step's sentinel vector).

    ``state``: a caller-owned dict (the executor keeps one per bound
    graph) holding the grad-norm EMA for spike detection.

    Healthy steps update the ``health/loss`` / ``health/grad_norm``
    gauges and return None. A trip (nonfinite loss/grads, or a
    grad-norm spike past ``MXNET_NUMERICS_SPIKE`` x EMA) bumps
    ``health/numerics_trips_total``, leaves a flight-recorder record,
    and then applies the policy: ``warn`` logs and training continues;
    ``raise`` / ``checkpoint-and-raise`` raise :class:`NumericsError`
    (``Module.fit`` takes the pre-raise checkpoint for the latter).
    """
    tm = _tm()
    loss = report.get("loss")
    norm = report.get("grad_norm")
    nonfinite = int(report.get("nonfinite", 0) or 0)
    trip = None
    if nonfinite > 0 or (norm is not None and not math.isfinite(norm)):
        trip = "nonfinite"
    elif loss is not None and not math.isfinite(loss):
        trip = "nonfinite_loss"
    elif (_spike_factor > 0 and state is not None and norm is not None):
        ema = state.get("grad_norm_ema")
        if ema is not None and ema > 0 and norm > _spike_factor * ema:
            trip = "grad_spike"
    if tm._enabled:
        if loss is not None and math.isfinite(loss):
            tm.gauge("health/loss",
                     "Loss proxy (mean of the first graph output) from "
                     "the in-program numerics sentinel").set(loss)
        if norm is not None and math.isfinite(norm):
            tm.gauge("health/grad_norm",
                     "Global gradient L2 norm from the in-program "
                     "numerics sentinel").set(norm)
        if nonfinite:
            tm.counter("health/nonfinite_total",
                       "Nonfinite gradient elements seen by the "
                       "numerics sentinel").inc(nonfinite)
    if trip is None:
        if state is not None and norm is not None and math.isfinite(norm):
            ema = state.get("grad_norm_ema")
            state["grad_norm_ema"] = (norm if ema is None
                                      else 0.9 * ema + 0.1 * norm)
        return None

    worst = None
    per_param = report.get("per_param")
    if per_param:
        # blast radius: name the layer. Worst = most nonfinite
        # elements, ties broken by grad norm.
        worst = max(per_param,
                    key=lambda n: (per_param[n].get("nonfinite", 0),
                                   per_param[n].get("norm", 0.0)))
    if tm._enabled:
        tm.counter("health/numerics_trips_total",
                   "Numerics-sentinel trips (nonfinite grads/loss or "
                   "grad-norm spike)", ("kind",)).labels(trip).inc()
    msg = ("numerics sentinel tripped at %s: %s (loss=%s grad_norm=%s "
           "nonfinite=%d%s)"
           % (where, trip, loss, norm, nonfinite,
              "; worst param: %s" % worst if worst else ""))
    try:
        from . import blackbox as _bb
        _bb.record_event("numerics_trip", kind=trip, where=where,
                         loss=loss, grad_norm=norm, nonfinite=nonfinite,
                         worst_param=worst)
    except Exception:
        pass
    try:
        from . import tracing as _trc
        _trc.mark_error(msg)
    except Exception:
        pass
    if _numerics_policy == "warn":
        _log.warning("%s (policy=warn: continuing)", msg)
        return trip
    raise NumericsError(msg, report=report)


# ---------------------------------------------------------------------------
# pillar 3: SLO engine (declarative rules, multi-window burn rate)
# ---------------------------------------------------------------------------

class _HistP99(object):
    """Interval-local p99 (seconds) of a telemetry latency histogram:
    each call returns the p99 of the observations since the PREVIOUS
    call (linear interpolation inside the winning bucket), or None
    when nothing new was observed — no traffic is not a violation."""

    def __init__(self, metric):
        self._metric = metric
        self._prev = {}

    def __call__(self):
        tm = _tm()
        fam = tm.REGISTRY._families.get(self._metric)
        if fam is None or fam.kind != "histogram":
            return None
        # merge every labeled series into one distribution
        bounds, merged = None, None
        for lv, child in fam.series():
            counts = child.bucket_counts()          # cumulative
            if merged is None:
                bounds = list(child.buckets) + [float("inf")]
                merged = [0] * len(counts)
            for i, c in enumerate(counts):
                merged[i] += c
        if merged is None:
            return None
        prev = self._prev.get("counts")
        self._prev["counts"] = merged
        if prev is None or len(prev) != len(merged):
            return None
        delta = [b - a for a, b in zip(prev, merged)]
        total = delta[-1]
        if total <= 0:
            return None
        target = 0.99 * total
        lo = 0.0
        for i, cum in enumerate(delta):
            if cum >= target:
                hi = bounds[i]
                if hi == float("inf"):
                    return lo if lo > 0 else bounds[-2]
                prev_cum = delta[i - 1] if i else 0
                in_bucket = delta[i] - prev_cum
                frac = ((target - prev_cum) / in_bucket) if in_bucket \
                    else 1.0
                return lo + (hi - lo) * frac
            lo = bounds[i]
        return bounds[-2]


class _CounterDelta(object):
    """Events since the previous evaluation of a counter family
    (summed over labels); None before the first sample."""

    def __init__(self, metric):
        self._metric = metric
        self._prev = None

    def __call__(self):
        tm = _tm()
        fam = tm.REGISTRY._families.get(self._metric)
        total = (sum(c.value for _lv, c in fam.series())
                 if fam is not None else 0)
        prev, self._prev = self._prev, total
        if prev is None:
            return None
        return total - prev


class _GaugeValue(object):
    """Current value of a gauge family (max over labels); None when
    the gauge was never set."""

    def __init__(self, metric):
        self._metric = metric

    def __call__(self):
        tm = _tm()
        fam = tm.REGISTRY._families.get(self._metric)
        if fam is None:
            return None
        vals = [c.value for _lv, c in fam.series()]
        return max(vals) if vals else None


class _Rule(object):
    __slots__ = ("name", "value_fn", "threshold", "cmp", "short_s",
                 "long_s", "burn", "mode", "description", "samples",
                 "state", "since", "last_value", "lock")

    def __init__(self, name, value_fn, threshold, cmp, short_s, long_s,
                 burn, description, mode="burn"):
        self.name = name
        self.value_fn = value_fn
        self.threshold = float(threshold)
        self.cmp = cmp
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.burn = float(burn)
        self.mode = mode                 # "burn" | "events"
        self.description = description
        self.samples = deque()           # (t, violating)
        self.state = "ok"
        self.since = _monotonic()
        self.last_value = None
        self.lock = threading.Lock()

    def _violating(self, value):
        if value is None:
            return False
        return value > self.threshold if self.cmp == ">" \
            else value < self.threshold

    def _window_frac(self, now, window):
        pts = [v for (t, v) in self.samples if now - t <= window]
        if not pts:
            return 0.0, 0
        return sum(pts) / float(len(pts)), len(pts)

    def evaluate(self, now):
        """One evaluator tick: sample, slide windows, maybe
        transition. Returns ('ok'|'firing', transitioned?)."""
        try:
            value = self.value_fn()
        except Exception:
            value = None
        with self.lock:
            self.last_value = value
            self.samples.append((now, 1 if self._violating(value) else 0))
            while self.samples and now - self.samples[0][0] > self.long_s:
                self.samples.popleft()
            short_frac, n_short = self._window_frac(now, self.short_s)
            long_frac, n_long = self._window_frac(now, self.long_s)
            prev = self.state
            if self.mode == "events":
                # discrete-event rules (counter deltas): ONE event is
                # already the signal — a numerics trip or a kvstore
                # giveup must page immediately, and burn-fraction math
                # would drown a single event among quiet ticks. Fires
                # on any violating sample in the short window, clears
                # when the window has drained.
                violated = any(v for (t, v) in self.samples
                               if now - t <= self.short_s)
                self.state = "firing" if violated else "ok"
            elif prev == "ok":
                # continuous signals: multi-window burn rate — both
                # the fast and the slow window must burn, so a
                # one-sample blip cannot page and a sustained
                # regression cannot hide behind an old quiet period
                if (n_short >= 2 and n_long >= 2
                        and short_frac >= self.burn
                        and long_frac >= self.burn):
                    self.state = "firing"
            else:
                if short_frac < self.burn:
                    self.state = "ok"
            transitioned = self.state != prev
            if transitioned:
                self.since = now
            return self.state, transitioned

    def snapshot(self, now):
        with self.lock:
            short_frac, _ = self._window_frac(now, self.short_s)
            long_frac, _ = self._window_frac(now, self.long_s)
            return {"name": self.name, "state": self.state,
                    "value": (round(self.last_value, 6)
                              if isinstance(self.last_value, float)
                              else self.last_value),
                    "threshold": self.threshold, "cmp": self.cmp,
                    "burn": self.burn, "mode": self.mode,
                    "short_window_s": self.short_s,
                    "long_window_s": self.long_s,
                    "short_burn_frac": round(short_frac, 3),
                    "long_burn_frac": round(long_frac, 3),
                    "since_s": round(now - self.since, 1),
                    "description": self.description}


_rules = {}
_rules_lock = threading.Lock()
_defaults_installed = False
_interval = float(_config("MXNET_SLO_INTERVAL_S", 2.0))
_evaluator = None
_evaluator_stop = threading.Event()


def watch(name, value_fn=None, threshold=0.0, cmp=">", short_s=30.0,
          long_s=120.0, burn=0.5, description="", histogram_p99=None,
          counter_delta=None, gauge=None, mode=None):
    """Register (or replace) one SLO rule.

    Exactly one source: ``value_fn`` (any callable returning a float
    or None — None samples never violate), ``histogram_p99=<metric>``
    (interval-local p99 seconds of a latency histogram),
    ``counter_delta=<metric>`` (events since the previous evaluation),
    or ``gauge=<metric>`` (current value, max over labels).

    Two firing modes. ``burn`` (default for continuous sources): fires
    when the fraction of violating samples is >= ``burn`` over BOTH
    the ``short_s`` and ``long_s`` windows, clears when the short
    window drops below ``burn``. ``events`` (default for
    ``counter_delta`` sources): a single violating sample fires
    immediately and the rule stays firing until the short window
    drains — a numerics trip or a kvstore giveup is the signal all by
    itself, and burn-fraction math would drown one event among quiet
    evaluator ticks. Transitions land in
    ``health/alert_transitions_total``, the flight recorder, and a
    ``health.alert`` root span.
    """
    sources = [s for s in (value_fn, histogram_p99, counter_delta, gauge)
               if s is not None]
    if len(sources) != 1:
        raise MXNetError("watch(%r) needs exactly one of value_fn / "
                         "histogram_p99 / counter_delta / gauge" % name)
    # defaults install first so an explicit watch() always WINS over
    # the default rule of the same name (re-watch = replace)
    _ensure_defaults()
    if mode is None:
        mode = "events" if counter_delta is not None else "burn"
    if mode not in ("burn", "events"):
        raise MXNetError("watch(%r): mode must be 'burn' or 'events'"
                         % name)
    if histogram_p99 is not None:
        value_fn = _HistP99(histogram_p99)
    elif counter_delta is not None:
        value_fn = _CounterDelta(counter_delta)
    elif gauge is not None:
        value_fn = _GaugeValue(gauge)
    rule = _Rule(name, value_fn, threshold, cmp, short_s, long_s, burn,
                 description, mode=mode)
    with _rules_lock:
        _rules[name] = rule
    ensure_evaluator()
    return rule


def unwatch(name):
    """Remove one rule; True when it existed."""
    with _rules_lock:
        return _rules.pop(name, None) is not None


def rules():
    """Names of the registered rules."""
    _ensure_defaults()
    with _rules_lock:
        return sorted(_rules)


def _ensure_defaults():
    """Install the default rule set once (idempotent, lazy — nothing
    starts until someone watches, serves /alerts, or evaluates)."""
    global _defaults_installed
    if _defaults_installed:
        return
    _defaults_installed = True
    serve_ms = float(_config("MXNET_SLO_SERVE_P99_MS", 1000.0))
    itl_ms = float(_config("MXNET_SLO_DECODE_ITL_P99_MS", 250.0))
    qd = 0.9 * float(_config("MXNET_SERVE_QUEUE_DEPTH", 64))
    watch("serve_p99", histogram_p99="serving/request_seconds",
          threshold=serve_ms / 1e3,
          description="serve request p99 (enqueue->result) over "
                      "MXNET_SLO_SERVE_P99_MS")
    watch("decode_itl_p99", histogram_p99="decode/step_seconds",
          threshold=itl_ms / 1e3,
          description="decode inter-token latency p99 (step wall) over "
                      "MXNET_SLO_DECODE_ITL_P99_MS")
    watch("queue_depth", gauge="serving/queue_depth", threshold=qd,
          description="serve queue persistently above 90% of "
                      "MXNET_SERVE_QUEUE_DEPTH (admission rejections "
                      "imminent)")
    watch("worker_restart_burn",
          counter_delta="serving/worker_restarts_total",
          threshold=0.0,
          description="serve/decode worker crash-restarts burning the "
                      "restart budget")
    watch("kv_giveups", counter_delta="kvstore/giveups_total",
          threshold=0.0,
          description="kvstore ops abandoned after exhausting retries "
                      "(parameter server unreachable)")
    watch("numerics", counter_delta="health/numerics_trips_total",
          threshold=0.0,
          description="numerics-sentinel trips (nonfinite grads/loss "
                      "or grad-norm spike)")
    watch("mfu_divergence", gauge="health/mfu_divergence",
          threshold=float(_config("MXNET_SLO_MFU_DIVERGENCE", 0.20)),
          mode="events",
          description="measured MFU (counted FLOPs) diverges "
                      "from the hand-counted estimate past "
                      "MXNET_SLO_MFU_DIVERGENCE (a single divergent "
                      "bench sample fires)")
    watch("badput_fraction", gauge="goodput/badput_fraction",
          threshold=float(_config("MXNET_SLO_BADPUT_FRACTION", 0.5)),
          description="goodput ledger: fraction of run wall NOT spent "
                      "in useful training-step compute sustained above "
                      "MXNET_SLO_BADPUT_FRACTION (compiles, data "
                      "waits, rescales, restarts, idle)")


def set_interval(seconds):
    """Evaluator wake period (also: MXNET_SLO_INTERVAL_S). Returns the
    previous period; takes effect on the next tick."""
    global _interval
    prev, _interval = _interval, max(0.01, float(seconds))
    return prev


def _transition(rule, state, now):
    tm = _tm()
    if tm._enabled:
        tm.counter("health/alert_transitions_total",
                   "SLO rule state transitions", ("rule", "state")
                   ).labels(rule.name, state).inc()
    try:
        from . import blackbox as _bb
        _bb.record_event("alert", rule=rule.name, state=state,
                         value=rule.last_value, threshold=rule.threshold)
    except Exception:
        pass
    try:
        from . import tracing as _trc
        with _trc.start_span("health.alert",
                             attrs={"rule": rule.name, "state": state,
                                    "value": rule.last_value,
                                    "threshold": rule.threshold}):
            pass
    except Exception:
        pass
    (_log.warning if state == "firing" else _log.info)(
        "SLO rule %r -> %s (value=%s threshold=%s)",
        rule.name, state, rule.last_value, rule.threshold)


def evaluate_once(now=None):
    """One evaluator pass over every rule (the background thread's
    body; callable directly in tests). Returns the firing rule
    names."""
    _ensure_defaults()
    now = _monotonic() if now is None else now
    with _rules_lock:
        current = list(_rules.values())
    firing = []
    for rule in current:
        state, transitioned = rule.evaluate(now)
        if transitioned:
            _transition(rule, state, now)
        if state == "firing":
            firing.append(rule.name)
    return firing


def _evaluator_main():
    while not _evaluator_stop.wait(_interval):
        try:
            evaluate_once()
        except Exception:
            _log.exception("SLO evaluator pass failed")


def ensure_evaluator():
    """Start the background evaluator thread once (daemon; stops with
    the process or via :func:`stop_evaluator`)."""
    global _evaluator
    _ensure_defaults()
    if _evaluator is not None and _evaluator.is_alive():
        return _evaluator
    with _rules_lock:
        if _evaluator is not None and _evaluator.is_alive():
            return _evaluator
        _evaluator_stop.clear()
        t = threading.Thread(target=_evaluator_main,
                             name="mxnet-slo-evaluator", daemon=True)
        t.start()
        _evaluator = t
    return _evaluator


def stop_evaluator(timeout=5.0):
    """Stop the evaluator thread (test isolation)."""
    global _evaluator
    _evaluator_stop.set()
    t = _evaluator
    if t is not None and t.is_alive():
        t.join(timeout=timeout)
    _evaluator = None


def alerts_firing():
    """Names of the rules currently firing (snapshot field; does not
    start the evaluator)."""
    with _rules_lock:
        return sorted(r.name for r in _rules.values()
                      if r.state == "firing")


def alerts_payload():
    """JSON-ready payload for ``/alerts``: every rule's state, value,
    windows, and burn fractions, newest transitions first."""
    ensure_evaluator()                   # hitting the endpoint arms it
    now = _monotonic()
    with _rules_lock:
        rows = [r.snapshot(now) for r in _rules.values()]
    rows.sort(key=lambda r: (r["state"] != "firing", r["name"]))
    return {"rules": rows,
            "firing": [r["name"] for r in rows if r["state"] == "firing"],
            "interval_s": _interval,
            "evaluator_alive": (_evaluator is not None
                                and _evaluator.is_alive())}


def alerts_endpoint(query=""):
    """(status_code, payload) for ``GET /alerts`` — the one
    implementation behind both mounts (telemetry.serve and
    serve.serve_http), the traces_endpoint pattern.

    ``?format=json`` returns the *machine contract* the fleet
    autoscaler polls: a trimmed, stability-guaranteed view of each
    rule (name, state, mode, value/threshold, windows + burn
    fractions) keyed under ``format: "json"``. The default (human)
    payload — the full snapshots with descriptions, ordering, and
    evaluator status — is unchanged, so dashboards keep rendering
    exactly what they always did while control loops get fields that
    won't move under them."""
    import urllib.parse
    params = urllib.parse.parse_qs(query or "")
    fmt = (params.get("format") or [""])[0]
    payload = alerts_payload()
    if fmt != "json":
        return 200, payload
    rules = [{"rule": r["name"], "state": r["state"], "mode": r["mode"],
              "value": r["value"], "threshold": r["threshold"],
              "cmp": r["cmp"], "since_s": r["since_s"],
              "windows": [
                  {"window_s": r["short_window_s"],
                   "burn_frac": r["short_burn_frac"]},
                  {"window_s": r["long_window_s"],
                   "burn_frac": r["long_burn_frac"]}],
              "burn_threshold": r["burn"]} for r in payload["rules"]]
    return 200, {"format": "json", "firing": payload["firing"],
                 "interval_s": payload["interval_s"], "rules": rules}


def reset():
    """Test isolation: stop the evaluator, drop rules and captured
    program costs, re-install defaults lazily on next use."""
    global _defaults_installed
    stop_evaluator()
    with _rules_lock:
        _rules.clear()
    _defaults_installed = False
    with _costs_lock:
        _costs.clear()
