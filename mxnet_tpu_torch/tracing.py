"""End-to-end request/step tracing: propagated span contexts.

Counterpart of the JAX package's ``tracing.py``, with its span names,
span dicts, ``/traces`` payload and wire format, so either package's
wire context grafts into the other's trace. Telemetry aggregates (p99
doubled); this module says where one slow request spent its time: an
always-on, overhead-bounded span tracer in the Dapper/OpenTelemetry
mould, carrying one ``SpanContext`` (trace_id, span_id, parent_id)
across threads and queues, so a ``POST /predict`` or one training step
yields a linked timeline: http -> queue-wait -> batch -> compute ->
slice, or data-wait -> forward-backward -> update -> checkpoint.

* **disabled path** (``MXNET_TRACING=0``): every call site checks one
  module bool.
* **head sampling** (``MXNET_TRACE_SAMPLE``, default 1.0): decided ONCE
  where a trace is born (an HTTP request, a train step), from a private
  ``random.Random`` stream, never the global one; an unsampled root is
  a no-op scope and its descendants record nothing.
* **implicit propagation**: :func:`start_span` inherits the thread's
  current context (contextvars). Where work crosses a queue or a thread
  the producer passes ``ctx=`` explicitly (serve requests carry it as
  ``_Request.tctx`` / ``DecodeSession.tctx``; a contextvar does not
  cross threads).
* **bounded memory**: finished traces land in a ring
  (``MXNET_TRACE_RING``); each trace holds at most ``_MAX_SPANS`` spans.
  Slow traces (root over ``MXNET_TRACE_SLOW_MS``) and traces that ended
  in an error / timeout / injected fault also go to a separate ring.
* **exporter**: :func:`traces_payload` backs ``/traces`` on both the
  telemetry server and the serving front end. :func:`chrome_events`
  (the merge into the profiler's trace) waits for ``profiler``
  (ROADMAP A19) and raises until then.

Span timestamps are absolute ``time.perf_counter()`` readings.
"""
from __future__ import annotations

import contextvars
import os
import random as _pyrandom
import threading
import time
from collections import deque

__all__ = ["SpanContext", "Span", "start_span", "child_span",
           "record_span", "use_context", "current", "active",
           "wire_context", "from_wire", "graft", "mark_error",
           "enabled", "enable", "set_sample", "set_slow_ms",
           "set_trace_ops",
           "finished_traces", "slow_traces", "get_trace", "traces_payload",
           "traces_endpoint", "chrome_events", "reset"]

_monotonic = time.perf_counter
_PID = os.getpid()
# private RNG: ids and sampling decisions must not consume draws from
# the module-level random stream — a user's random.seed(...) run would
# otherwise diverge based on how many spans/retries happened to occur
_rng = _pyrandom.Random(os.urandom(16))
# identifies THIS process's perf_counter epoch on the wire (pid alone
# collides across hosts/containers — every container's server is pid 1)
_PROC_TOKEN = "%x-%s" % (_PID, os.urandom(4).hex())

# hard cap on spans per trace: a pathological loop (thousands of eager
# ops under one step span) degrades to a truncation count, never to
# unbounded memory
_MAX_SPANS = 512

# slow/error exemplar ring: small and separate, so ordinary traffic
# cannot evict the interesting traces
_SLOW_RING = 32


def _config(name, fallback):
    try:
        from .config import get
        v = get(name)
        return fallback if v is None else v
    except Exception:
        return fallback


_enabled = bool(_config("MXNET_TRACING", True))
_sample = float(_config("MXNET_TRACE_SAMPLE", 1.0))
_slow_ms = float(_config("MXNET_TRACE_SLOW_MS", 1000))
# per-op op.dispatch spans are opt-in: on a microsecond-scale eager op
# the span write costs more than the dispatch, so the default keeps
# sampled traces structural (queue/batch/compute/step phases) only
_trace_ops = bool(_config("MXNET_TRACE_OPS", False))

_current = contextvars.ContextVar("mxnet_trace_ctx", default=None)

_ring_lock = threading.Lock()
_ring = deque(maxlen=max(1, int(_config("MXNET_TRACE_RING", 64))))
_slow = deque(maxlen=_SLOW_RING)


def new_trace_id():
    return "%032x" % _rng.getrandbits(128)


def new_span_id():
    return "%016x" % _rng.getrandbits(64)


# ---------------------------------------------------------------------------
# trace buffer (one per sampled trace; shared by every span context of
# that trace, including contexts deserialized from the kvstore wire)
# ---------------------------------------------------------------------------

class _TraceBuf(object):
    """Collector for one trace's finished spans. ``add`` deduplicates on
    span_id — a kvstore response replayed from the server's seq-cache
    may carry span records the client already grafted; at-most-once
    applies to spans exactly like it applies to server state."""

    __slots__ = ("spans", "_seen", "error", "dropped", "_lock", "_trace")

    def __init__(self):
        self.spans = []
        self._seen = set()
        self.error = None
        self.dropped = 0
        self._lock = threading.Lock()
        self._trace = None

    def add(self, span, force=False):
        """``force`` bypasses the span cap (never the dedup): the ROOT
        span finishes last, after its children filled the buffer, and a
        capped trace without its root envelope would be 512 orphans."""
        with self._lock:
            sid = span["span_id"]
            if sid in self._seen:
                return False
            if not force and len(self.spans) >= _MAX_SPANS:
                self.dropped += 1
                return False
            self._seen.add(sid)
            self.spans.append(span)
            t = self._trace
            if t is not None:
                # the root finalized before this span landed — e.g. the
                # request timed out (504) while its batch was still
                # mid-compute and the worker records serve.* afterwards.
                # Keep attaching: the retained timeout exemplar is
                # exactly the trace that needs its phase breakdown.
                # copy-on-write — /traces may be json-serializing the
                # current spans/phases objects right now
                phases = dict(t["phases"])
                phases[span["name"]] = round(
                    phases.get(span["name"], 0.0)
                    + (span["t1"] - span["t0"]) * 1e3, 3)
                t["spans"] = t["spans"] + [span]
                t["phases"] = phases
        return True

    def extend(self, spans):
        for s in spans:
            self.add(s)


class SpanContext(object):
    """Propagation handle: identifies a position in a trace. Cheap to
    copy across threads/queues; serializable for the RPC hop."""

    __slots__ = ("trace_id", "span_id", "sampled", "buf")

    def __init__(self, trace_id, span_id, sampled, buf):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled
        self.buf = buf

    def child_of(self, span_id):
        return SpanContext(self.trace_id, span_id, self.sampled, self.buf)


def current():
    """The active :class:`SpanContext` (sampled or not), or None."""
    if not _enabled:
        return None
    return _current.get()


def active():
    """The active SAMPLED context, or None — the call-site fast path:
    one module bool and one contextvar read when nothing is recording."""
    if not _enabled:
        return None
    ctx = _current.get()
    if ctx is None or not ctx.sampled:
        return None
    return ctx


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class Span(object):
    """A live (open) span; finished into a plain dict on scope exit."""

    __slots__ = ("name", "ctx", "parent_id", "t0", "t1", "attrs",
                 "status", "_root", "_token", "_tid")

    def __init__(self, name, ctx, parent_id, root):
        self.name = name
        self.ctx = ctx                   # context of THIS span
        self.parent_id = parent_id
        self.t0 = _monotonic()
        self.t1 = None
        self.attrs = {}
        self.status = "ok"
        self._root = root
        self._token = None
        self._tid = threading.get_ident() % 100000

    def set_attr(self, key, value):
        self.attrs[key] = value
        return self

    @property
    def trace_id(self):
        return self.ctx.trace_id

    @property
    def span_id(self):
        return self.ctx.span_id

    def _finish(self, exc=None):
        self.t1 = _monotonic()
        if exc is not None:
            self.status = "error"
            self.attrs.setdefault("error", "%s: %s"
                                  % (type(exc).__name__, exc))
            if self._root:
                # only a failure that reaches the ROOT taints the trace
                # (plus explicit mark_error calls: HTTP error replies,
                # deadline expiry, fault.inject). A child that failed
                # transiently and was retried to success — routine
                # kvstore transport noise — must not claim a slot in
                # the bounded error-exemplar ring.
                self.ctx.buf.error = self.attrs["error"]
        self.ctx.buf.add(_span_dict(self.name, self.ctx.trace_id,
                                    self.ctx.span_id, self.parent_id,
                                    self.t0, self.t1, self.attrs,
                                    self.status, self._tid),
                         force=self._root)
        if self._root:
            _finalize(self)


class _SpanScope(object):
    """Context manager around one Span: sets/restores the implicit
    context on its own thread, records the span on exit."""

    __slots__ = ("span",)

    def __init__(self, span):
        self.span = span

    def __enter__(self):
        self.span._token = _current.set(self.span.ctx)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        _current.reset(self.span._token)
        self.span._finish(exc)
        return False


class _NoopSpan(object):
    """Shared no-op for the disabled / unsampled paths."""

    __slots__ = ()
    ctx = None
    trace_id = None
    span_id = None
    attrs = {}

    def set_attr(self, key, value):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()
# public handle for call sites that branch on active() themselves to
# avoid building an attrs dict on the untraced path
NOOP = _NOOP


def _span_dict(name, trace_id, span_id, parent_id, t0, t1, attrs, status,
               tid):
    return {"name": name, "trace_id": trace_id, "span_id": span_id,
            "parent_id": parent_id, "t0": t0, "t1": t1,
            "attrs": attrs or {}, "status": status, "tid": tid}


def start_span(name, ctx=None, attrs=None, trace_id=None):
    """Open a span as a context manager.

    * With an explicit ``ctx`` (or an implicit current context), the
      span is a child in that trace — unless the context is unsampled,
      in which case this is a no-op.
    * With no context at all, this is a ROOT: the head-sampling
      decision is made here (``MXNET_TRACE_SAMPLE``). ``trace_id``
      pins the new trace's id (an accepted ``X-Request-Id``).

    Always safe to call; returns a shared no-op scope when tracing is
    disabled or the trace is unsampled.
    """
    if not _enabled:
        return _NOOP
    parent = ctx if ctx is not None else _current.get()
    if parent is None:
        if _sample <= 0.0 or (_sample < 1.0
                              and _rng.random() >= _sample):
            return _NOOP
        buf = _TraceBuf()
        span_ctx = SpanContext(trace_id or new_trace_id(), new_span_id(),
                               True, buf)
        span = Span(name, span_ctx, None, root=True)
    else:
        if not parent.sampled:
            return _NOOP
        span = Span(name, parent.child_of(new_span_id()), parent.span_id,
                    root=False)
    if attrs:
        span.attrs.update(attrs)
    return _SpanScope(span)


def child_span(name, ctx=None, attrs=None):
    """Open a span ONLY when a sampled context is already active (or is
    passed in) — never a root. This is the hook hot layers use
    (executor, kvstore, io, checkpoint): outside a traced request/step
    it costs one module bool + one contextvar read and records
    nothing."""
    if not _enabled:
        return _NOOP
    parent = ctx if ctx is not None else active()
    if parent is None:
        return _NOOP
    return start_span(name, ctx=parent, attrs=attrs)


def record_span(name, ctx, t0, t1, attrs=None, span_id=None,
                parent_id=None, status="ok"):
    """Record an already-measured interval as a span (used where the
    interval is observed after the fact — e.g. the queue-wait of a
    serve request, reconstructed at dequeue time). Returns the span id
    (reusable to parent further spans), or None when not recording."""
    if not _enabled or ctx is None or not ctx.sampled:
        return None
    sid = span_id or new_span_id()
    ctx.buf.add(_span_dict(name, ctx.trace_id, sid,
                           parent_id if parent_id is not None
                           else ctx.span_id,
                           t0, t1, attrs, status,
                           threading.get_ident() % 100000))
    return sid


class _UseCtx(object):
    """Install an explicit context as the thread's implicit one (used
    where work dequeued from another thread should adopt the request's
    context — e.g. a serve worker running the batch of a traced
    request, so nested executor spans land in that trace)."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx):
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        if self._ctx is not None and _enabled:
            self._token = _current.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        if self._token is not None:
            _current.reset(self._token)
        return False


def use_context(ctx):
    """Context manager: make ``ctx`` the implicit current context on
    this thread (no-op when ``ctx`` is None or tracing is disabled)."""
    return _UseCtx(ctx)


def mark_error(reason, ctx=None):
    """Flag the (given or current) trace as errored so it is retained
    in the slow/error ring regardless of duration. Called by
    fault.inject when an armed fault fires under a sampled trace."""
    ctx = ctx if ctx is not None else active()
    if ctx is not None and ctx.sampled:
        ctx.buf.error = str(reason)


# ---------------------------------------------------------------------------
# wire propagation (kvstore RPC hop)
# ---------------------------------------------------------------------------

def wire_context(ctx=None):
    """Serializable dict for the active (or given) sampled context;
    None when nothing is recording — the RPC payload then carries no
    tracing field at all."""
    ctx = ctx if ctx is not None else active()
    if ctx is None or not ctx.sampled:
        return None
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id,
            "sampled": True}


class _SinkBuf(_TraceBuf):
    """A trace buffer that tees every accepted span into an external
    list — the server's per-RPC collector, shipped back to the client
    inside the response."""

    __slots__ = ("_sink",)

    def __init__(self, sink):
        _TraceBuf.__init__(self)
        self._sink = sink

    def add(self, span, force=False):
        if _TraceBuf.add(self, span, force=force):
            self._sink.append(span)
            return True
        return False


def from_wire(wire, sink=None):
    """Rebuild a :class:`SpanContext` from :func:`wire_context` output.
    ``sink``: a list collecting the finished span dicts (the server
    appends them to its RPC response so they surface in the client's
    trace); without one, spans land in a throwaway buffer."""
    if not wire or not wire.get("sampled"):
        return None
    buf = _TraceBuf() if sink is None else _SinkBuf(sink)
    return SpanContext(wire["trace_id"], wire["span_id"], True, buf)


def graft(spans, ctx=None, clock=None):
    """Attach remotely-recorded span dicts (an RPC response's tracing
    field) into the current trace. Deduplicated on span_id, so a
    response replayed by the server's at-most-once cache cannot
    double-count spans.

    ``clock``: ``(proc_token, server_now, client_now)`` — the sender's
    :data:`_PROC_TOKEN` plus its ``perf_counter`` reading taken as the
    response was sent, paired with the client's reading at receipt.
    Spans from a server in ANOTHER process carry that process's
    ``perf_counter`` epoch; the clock pair gives the epoch offset
    exactly (to within one response delivery delay), so the bundle is
    rebased onto the client clock with durations and relative placement
    preserved. An in-process server's token matches ours and the bundle
    is left untouched — spans recorded long before this RPC (an
    at-most-once seq-cache replay re-ships the original execution's
    spans) keep their true times."""
    ctx = ctx if ctx is not None else active()
    if ctx is None or not ctx.sampled or not spans:
        return
    if clock is not None and clock[0] != _PROC_TOKEN:
        shift = clock[2] - clock[1]
        spans = [dict(s, t0=s["t0"] + shift, t1=s["t1"] + shift)
                 for s in spans]
    ctx.buf.extend(spans)


# ---------------------------------------------------------------------------
# finished-trace rings
# ---------------------------------------------------------------------------

def _finalize(root_span):
    buf = root_span.ctx.buf
    dur_ms = (root_span.t1 - root_span.t0) * 1e3
    with buf._lock:
        spans = sorted(buf.spans, key=lambda s: s["t0"])
        phases = {}
        for s in spans:
            if s["span_id"] == root_span.ctx.span_id:
                continue
            phases[s["name"]] = phases.get(s["name"], 0.0) \
                + (s["t1"] - s["t0"]) * 1e3
        trace = {"trace_id": root_span.ctx.trace_id,
                 "root": root_span.name,
                 "duration_ms": round(dur_ms, 3),
                 "error": buf.error,
                 "spans": spans,
                 "dropped_spans": buf.dropped,
                 "phases": {k: round(v, 3) for k, v in phases.items()},
                 "wall_ts": time.time()}
        # spans recorded from now on (a worker finishing a batch whose
        # requester already timed out) land in the retained record too
        buf._trace = trace
    slow = dur_ms >= _slow_ms or buf.error is not None
    trace["slow"] = bool(slow)
    with _ring_lock:
        _ring.append(trace)
        if slow:
            _slow.append(trace)


def finished_traces(limit=None):
    """Most-recent-first list of finished sampled traces."""
    with _ring_lock:
        out = list(_ring)
    out.reverse()
    return out[:limit] if limit else out


def slow_traces(limit=None):
    """Most-recent-first list of retained slow/error exemplar traces."""
    with _ring_lock:
        out = list(_slow)
    out.reverse()
    return out[:limit] if limit else out


def get_trace(trace_id):
    """Newest trace with this id (client-supplied X-Request-Ids can
    collide; the most recent one is the one being debugged)."""
    with _ring_lock:
        candidates = list(_ring) + list(_slow)
    best = None
    for t in candidates:
        if t["trace_id"] == trace_id and \
                (best is None or t["wall_ts"] >= best["wall_ts"]):
            best = t
    return best


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def chrome_events():
    """Every retained trace as chrome-trace events on the profiler's
    time base. The port has no ``profiler`` yet (ROADMAP A19): this
    raises until it lands; :func:`traces_payload` carries the same
    spans as JSON."""
    raise NotImplementedError("tracing.chrome_events merges spans into "
                              "the profiler's trace; mx.profiler is not "
                              "ported yet (ROADMAP A19)")


def _trace_summary(t):
    # the root span's attrs ride the summary (e.g. train.step's
    # epoch/nbatch): the cluster observatory joins per-rank step
    # timelines on them without fetching every trace by id, and
    # wall_ts is the cross-process clock anchor that lets it stitch
    # N ranks' perf_counter timelines onto one axis
    root_attrs = {}
    for s in t["spans"]:
        if s.get("parent_id") is None and s["name"] == t["root"]:
            root_attrs = s.get("attrs") or {}
            break
    return {"trace_id": t["trace_id"], "root": t["root"],
            "duration_ms": t["duration_ms"], "error": t["error"],
            "slow": t["slow"], "spans": len(t["spans"]),
            "phases": t["phases"], "root_attrs": root_attrs,
            "wall_ts": round(t["wall_ts"], 6), "age_s": round(
                time.time() - t["wall_ts"], 1)}


def traces_payload(trace_id=None, limit=20):
    """JSON-ready payload for the ``/traces`` endpoint: recent + slow
    trace summaries (full span list per trace on ``?id=``) and the
    latency-histogram exemplars linking /metrics worst-cases to
    concrete trace ids."""
    if trace_id:
        t = get_trace(trace_id)
        if t is None:
            return None
        out = dict(t)
        out.pop("wall_ts", None)
        return out
    from . import telemetry as _tm
    return {"recent": [_trace_summary(t) for t in finished_traces(limit)],
            "slow": [_trace_summary(t) for t in slow_traces(limit)],
            "exemplars": _tm.exemplars(),
            "sample_rate": _sample,
            "slow_ms": _slow_ms,
            "enabled": _enabled}


def traces_endpoint(query=""):
    """(status_code, payload_dict) for a ``GET /traces[?id=…]``
    request — the ONE implementation behind both mounts
    (telemetry.serve and serve.serve_http), so their behavior cannot
    drift."""
    from urllib.parse import parse_qs
    tid = (parse_qs(query).get("id") or [None])[0]
    payload = traces_payload(tid)
    if payload is None:
        return 404, {"error": "unknown trace id %r" % tid}
    return 200, payload


# ---------------------------------------------------------------------------
# switches (runtime + test control)
# ---------------------------------------------------------------------------

def enabled():
    return _enabled


def enable(on=True):
    """Flip the tracer at runtime (also: ``MXNET_TRACING=0``). Returns
    the previous state. Rings are preserved."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    return prev


def set_sample(rate):
    """Set the head-sampling probability (also: MXNET_TRACE_SAMPLE).
    Returns the previous rate."""
    global _sample
    prev = _sample
    _sample = max(0.0, min(1.0, float(rate)))
    return prev


def set_slow_ms(ms):
    """Set the slow-exemplar threshold (also: MXNET_TRACE_SLOW_MS).
    Returns the previous threshold."""
    global _slow_ms
    prev = _slow_ms
    _slow_ms = float(ms)
    return prev


def set_trace_ops(on):
    """Toggle per-op op.dispatch span recording (also: MXNET_TRACE_OPS).
    Returns the previous setting."""
    global _trace_ops
    prev = _trace_ops
    _trace_ops = bool(on)
    return prev


def reset():
    """Clear both rings (test isolation). Live spans are unaffected."""
    with _ring_lock:
        _ring.clear()
        _slow.clear()
