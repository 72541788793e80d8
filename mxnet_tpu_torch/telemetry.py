"""Always-on runtime telemetry: a thread-safe registry of counters,
gauges and histograms with labelled series, and its sinks.

Counterpart of the JAX package's ``telemetry.py``, with its instrument
names, label spelling, Prometheus text and ``/metrics`` / ``/healthz``
endpoint:

1. :func:`render_prometheus`: the Prometheus text exposition format
   (0.0.4), byte for byte the JAX package's for the same observations;
2. :func:`serve`: a stdlib-only HTTP server mounting ``/metrics``,
   ``/healthz``, ``/traces`` and ``/alerts`` (what
   ``serving.Predictor.serve_metrics`` starts for scraping);
3. :func:`exemplars`: the worst-recent trace id of every latency
   histogram, which ``/traces`` carries so a p99 links to a timeline.

Naming scheme: instruments use short path-style names
(``serving/request_seconds``, ``hbm/bytes_in_use``); rendering prefixes
``mxnet_`` and maps every other character to ``_``. Labels are free-form
key/value pairs (``{bucket="8"}``, ``{device="cuda:0"}``).

``hbm/*`` gauges come from ``torch.cuda.memory_allocated`` /
``max_memory_allocated`` (:func:`record_hbm`). What the JAX module builds
on XLA's compile listener (``compile_count``,
``suppress_compile_tracking``, the ``jit/*`` counters) comes with the
compiled-program registry (ROADMAP A6), and the bridge into the profiler
trace with ``profiler`` (A19); ``/programs`` and ``/cluster`` answer 404
naming those items.
"""
from __future__ import annotations

import bisect
import json
import threading
import time

__all__ = ["Registry", "Family", "Counter", "Gauge", "Histogram",
           "REGISTRY", "counter", "gauge", "histogram", "enable",
           "enabled", "render_prometheus", "serve", "TelemetryServer",
           "snapshot", "reset", "exemplars", "record_hbm", "prom_name",
           "monotonic", "DEFAULT_LATENCY_BUCKETS"]

# Fixed log-scale latency buckets (seconds): 1-2.5-5 per decade from
# 10us to 10s.
DEFAULT_LATENCY_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

monotonic = time.perf_counter

# a histogram's worst-case exemplar decays after this long, so "worst
# recent" tracks the current regime rather than a cold-start outlier
EXEMPLAR_WINDOW_S = 300.0


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------

class Counter(object):
    """Monotonically increasing count."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value


class Gauge(object):
    """Point-in-time value."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value):
        value = float(value)
        with self._lock:
            self._value = value

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        self.inc(-amount)

    @property
    def value(self):
        return self._value


class Histogram(object):
    """Cumulative histogram over fixed upper bounds (+Inf implicit).

    ``observe(value, trace_id=...)`` additionally keeps a worst-recent
    exemplar — the trace id of the largest observation in the last
    ``EXEMPLAR_WINDOW_S`` seconds — so a /metrics p99 links to a
    concrete /traces timeline."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_lock",
                 "_worst_v", "_worst_id", "_worst_t")

    def __init__(self, buckets=DEFAULT_LATENCY_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        self._worst_v = None
        self._worst_id = None
        self._worst_t = 0.0

    def observe(self, value, trace_id=None):
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if trace_id is not None:
                now = monotonic()
                if (self._worst_v is None or value >= self._worst_v
                        or now - self._worst_t > EXEMPLAR_WINDOW_S):
                    self._worst_v = value
                    self._worst_id = trace_id
                    self._worst_t = now

    def exemplar(self):
        """(value, trace_id, age_seconds) of the worst recent traced
        observation, or None when nothing traced was observed within
        the decay window — a frozen exemplar from before traffic went
        idle (or sampling was turned off) would point an operator at a
        long-evicted timeline presented as current."""
        with self._lock:
            if self._worst_id is None:
                return None
            age = monotonic() - self._worst_t
            if age > EXEMPLAR_WINDOW_S:
                self._worst_v = None
                self._worst_id = None
                self._worst_t = 0.0
                return None
            return (self._worst_v, self._worst_id, age)

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def bucket_counts(self):
        """Cumulative counts per upper bound, ending with +Inf."""
        out, acc = [], 0
        with self._lock:
            raw = list(self._counts)
        for c in raw:
            acc += c
            out.append(acc)
        return out


class Family(object):
    """One named metric: an instrument per label-value combination.
    Unlabelled metrics hold a single default child."""

    __slots__ = ("name", "kind", "help", "labelnames", "buckets",
                 "_children", "_lock")

    def __init__(self, name, kind, help="", labelnames=(), buckets=None):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = buckets
        self._children = {}
        self._lock = threading.Lock()

    def _label_suffix(self, labelvalues):
        """``{name=value,...}`` series-key suffix ("" when unlabelled),
        the one spelling shared by snapshot() and exemplars()."""
        if not labelvalues:
            return ""
        return "{%s}" % ",".join(
            "%s=%s" % kv for kv in zip(self.labelnames, labelvalues))

    def _make(self, labelvalues):
        if self.kind == "counter":
            return Counter()
        if self.kind == "gauge":
            return Gauge()
        return Histogram(self.buckets or DEFAULT_LATENCY_BUCKETS)

    def labels(self, *labelvalues, **labelkw):
        if labelkw:
            labelvalues = tuple(str(labelkw[n]) for n in self.labelnames)
        else:
            labelvalues = tuple(str(v) for v in labelvalues)
        if len(labelvalues) != len(self.labelnames):
            raise ValueError("metric %r expects labels %s"
                             % (self.name, list(self.labelnames)))
        child = self._children.get(labelvalues)
        if child is None:
            with self._lock:
                child = self._children.get(labelvalues)
                if child is None:
                    child = self._make(labelvalues)
                    self._children[labelvalues] = child
        return child

    # unlabelled convenience: the family proxies its default child
    def _default(self):
        return self.labels()

    def inc(self, amount=1):
        self._default().inc(amount)

    def set(self, value):
        self._default().set(value)

    def dec(self, amount=1):
        self._default().dec(amount)

    def observe(self, value, trace_id=None):
        self._default().observe(value, trace_id=trace_id)

    @property
    def value(self):
        return self._default().value

    def series(self):
        """Snapshot [(labelvalues, child)] observed so far."""
        with self._lock:
            return list(self._children.items())


class Registry(object):
    """Thread-safe get-or-create store of metric families."""

    def __init__(self):
        self._families = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name, kind, help, labelnames, buckets=None):
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError("metric %r already registered as %s"
                                 % (name, fam.kind))
            return fam
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, kind, help, labelnames, buckets)
                self._families[name] = fam
        return fam

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(name, "counter", help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(name, "gauge", help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None):
        return self._get_or_create(name, "histogram", help, labelnames,
                                   buckets)

    def families(self):
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def reset(self):
        with self._lock:
            self._families.clear()

    def render_prometheus(self):
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        for fam in self.families():
            series = fam.series()
            if not series:
                continue
            pname = prom_name(fam.name)
            if fam.help:
                lines.append("# HELP %s %s"
                             % (pname, fam.help.replace("\n", " ")))
            lines.append("# TYPE %s %s" % (pname, fam.kind))
            for labelvalues, child in sorted(series):
                base_labels = list(zip(fam.labelnames, labelvalues))
                if fam.kind in ("counter", "gauge"):
                    lines.append("%s%s %s" % (pname, _label_str(base_labels),
                                              _fmt(child.value)))
                else:
                    bounds = list(child.buckets) + [float("inf")]
                    for ub, c in zip(bounds, child.bucket_counts()):
                        lines.append("%s_bucket%s %d" % (
                            pname,
                            _label_str(base_labels + [("le", _le(ub))]), c))
                    lines.append("%s_sum%s %s"
                                 % (pname, _label_str(base_labels),
                                    _fmt(child.sum)))
                    lines.append("%s_count%s %d"
                                 % (pname, _label_str(base_labels),
                                    child.count))
        return "\n".join(lines) + "\n"

    def snapshot(self):
        """Flat dict of every observed series (for JSON embedding)."""
        out = {}
        for fam in self.families():
            for labelvalues, child in fam.series():
                key = fam.name + fam._label_suffix(labelvalues)
                if fam.kind == "histogram":
                    out[key] = {"count": child.count,
                                "sum": round(child.sum, 6)}
                else:
                    v = child.value
                    out[key] = round(v, 6) if isinstance(v, float) else v
        return out


def prom_name(name):
    clean = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    if not clean.startswith("mxnet_"):
        clean = "mxnet_" + clean
    return clean


def _label_str(pairs):
    if not pairs:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in pairs)


def _le(ub):
    return "+Inf" if ub == float("inf") else repr(ub)


def _fmt(v):
    if isinstance(v, float) and not v.is_integer():
        return repr(v)
    return str(int(v))


# ---------------------------------------------------------------------------
# default registry + enable switch
# ---------------------------------------------------------------------------

REGISTRY = Registry()


def counter(name, help="", labelnames=()):
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None):
    return REGISTRY.histogram(name, help, labelnames, buckets)


def render_prometheus():
    return REGISTRY.render_prometheus()


def _config_enabled():
    try:
        from .config import get
        return bool(get("MXNET_TELEMETRY"))
    except Exception:
        return True


_enabled = _config_enabled()


def enabled():
    return _enabled


def enable(on=True):
    """Turn instrumentation on/off (also: MXNET_TELEMETRY=0). Returns the
    previous state. Registry contents are preserved."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    return prev


def reset():
    """Clear every collected series (test isolation). Instrument handles
    that hot paths cached are re-resolved on their next use."""
    REGISTRY.reset()


def exemplars():
    """Worst-recent trace exemplars of every latency histogram:
    {"name{labels}": {"seconds", "trace_id", "age_s"}}. Rendered by the
    /traces endpoint so a scraped p99 links to a concrete timeline (the
    0.0.4 text format has no exemplar syntax, so they ride there)."""
    out = {}
    for fam in REGISTRY.families():
        if fam.kind != "histogram":
            continue
        for labelvalues, child in fam.series():
            ex = child.exemplar()
            if ex is None:
                continue
            key = fam.name + fam._label_suffix(labelvalues)
            out[key] = {"seconds": round(ex[0], 6), "trace_id": ex[1],
                        "age_s": round(ex[2], 1)}
    return out


def record_hbm(device=None, bytes_in_use=None, peak_bytes=None):
    """Set ``hbm/bytes_in_use`` (and ``hbm/peak_bytes``) for ``device``.
    With no byte counts given, reads the card's allocator:
    ``torch.cuda.memory_allocated`` and ``max_memory_allocated``."""
    import torch
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if bytes_in_use is None:
        bytes_in_use = torch.cuda.memory_allocated(device)
        if peak_bytes is None:
            peak_bytes = torch.cuda.max_memory_allocated(device)
    dev = str(device)
    gauge("hbm/bytes_in_use", "Device memory currently allocated",
          ("device",)).labels(dev).set(bytes_in_use)
    if peak_bytes is not None:
        gauge("hbm/peak_bytes", "Peak device memory allocated",
              ("device",)).labels(dev).set(peak_bytes)


# ---------------------------------------------------------------------------
# /metrics HTTP server (stdlib only)
# ---------------------------------------------------------------------------

# last-started metrics endpoint of this process ("host:port"), set by
# serve() / serve.serve_http
_server_endpoint = None


def server_endpoint():
    """``"host:port"`` of this process's most recently started metrics
    mount (telemetry.serve or serve.serve_http), or None."""
    return _server_endpoint


def set_server_endpoint(host, port):
    global _server_endpoint
    _server_endpoint = "%s:%d" % (host, int(port)) if port else None


def not_ported_endpoint(path):
    """(404, payload) for a mount whose module is not ported yet."""
    item = {"/programs": "A6: the compiled-program registry and "
                         "forensics",
            "/cluster": "A16: the cluster observatory"}[path]
    return 404, {"error": "%s is not ported yet (ROADMAP %s)"
                 % (path, item)}


class TelemetryServer(object):
    """Handle on a running metrics endpoint (returned by :func:`serve`)."""

    def __init__(self, httpd, thread):
        self._httpd = httpd
        self._thread = thread
        self.port = httpd.server_address[1]
        self.url = "http://%s:%d" % (httpd.server_address[0], self.port)

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    stop = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def serve(port=0, addr="127.0.0.1", registry=None):
    """Start a daemon-thread HTTP server exposing ``/metrics``
    (Prometheus text format), ``/healthz``, ``/traces`` and ``/alerts``.
    ``port=0`` picks a free port (read it from the returned handle).
    Stdlib only."""
    import http.server

    reg = registry or REGISTRY

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            path, _, query = self.path.partition("?")
            code = 200
            if path == "/metrics":
                body = reg.render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/healthz":
                body = b"ok\n"
                ctype = "text/plain; charset=utf-8"
            elif path in ("/traces", "/alerts", "/programs", "/cluster"):
                if path == "/traces":
                    from . import tracing as _tr
                    code, payload = _tr.traces_endpoint(query)
                elif path == "/alerts":
                    from . import health as _hl
                    code, payload = _hl.alerts_endpoint(query)
                else:
                    code, payload = not_ported_endpoint(path)
                body = json.dumps(payload, default=str).encode() + b"\n"
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # no stderr chatter per scrape
            pass

    httpd = http.server.ThreadingHTTPServer((addr, port), _Handler)
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever,
                              name="mxnet-telemetry", daemon=True)
    thread.start()
    set_server_endpoint(addr, httpd.server_address[1])
    return TelemetryServer(httpd, thread)


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------

def _val(name):
    f = REGISTRY._families.get(name)
    if f is None:
        return 0
    return sum(c.value for _lv, c in f.series())


# the JAX package's compact summary: summary key -> counter family
_SUMMARY = (
    ("serve_requests", "serving/requests_total"),
    ("serve_rejected", "serving/rejected_total"),
    ("serve_timeouts", "serving/timeouts_total"),
    ("serve_batches", "serving/batches_total"),
    ("serve_swaps", "serving/swaps_total"),
    ("decode_requests", "decode/requests_total"),
    ("decode_rejected", "decode/rejected_total"),
    ("decode_tokens", "decode/tokens_total"),
    ("decode_preempted", "decode/preempted_total"),
    ("decode_timeouts", "decode/timeouts_total"),
    ("ckpt_saves", "checkpoint/saves_total"),
    ("ckpt_restores", "checkpoint/restores_total"),
    ("ckpt_fallbacks", "checkpoint/fallbacks_total"),
    ("ckpt_corrupt", "checkpoint/corrupt_total"),
    ("kv_retries", "kvstore/retries_total"),
    ("kv_giveups", "kvstore/giveups_total"),
    ("kv_server_failovers", "kvstore/server_failovers_total"),
    ("kv_snapshots", "kvstore/snapshots_total"),
    ("kv_worker_rejoins", "kvstore/worker_rejoins_total"),
    ("serve_worker_restarts", "serving/worker_restarts_total"),
    ("quantize_checkpoints", "quantize/checkpoints_total"),
    ("quantize_swaps", "quantize/swaps_total"),
    ("quantize_shadow_requests", "quantize/shadow_requests_total"),
    ("quantize_shadow_errors", "quantize/shadow_errors_total"),
    ("faults_injected", "fault/injected_total"),
    ("fused_step_total", "executor/fused_step_total"),
)


def snapshot():
    """Every observed series (``name{label=value,...}``: counters and
    gauges by value, histograms as ``{"count", "sum"}``), plus the JAX
    package's compact summary keys (``serve_requests``,
    ``decode_tokens``, ``alerts_firing``, ``numerics_trips``,
    ``flight_records``, ``peak_hbm_bytes``, ...; none contains a ``/``,
    so the two never collide). The keys that count XLA compiles and the
    program registry are A6's."""
    out = REGISTRY.snapshot()
    for key, name in _SUMMARY:
        out[key] = _val(name)
    try:
        from . import blackbox as _bb
        from . import health as _hl
        out["alerts_firing"] = _hl.alerts_firing()
        out["numerics_trips"] = _hl.numerics_trips()
        out["flight_records"] = _bb.records_written()
    except Exception:
        out["alerts_firing"] = []
        out["numerics_trips"] = 0
        out["flight_records"] = 0
    for key, name, kind in (("serve_mean_batch_rows", "serving/batch_rows",
                             3),
                            ("serve_mean_padding_waste",
                             "serving/padding_waste_ratio", 4)):
        fam = REGISTRY._families.get(name)
        if fam is not None:
            tot = sum(c.sum for _lv, c in fam.series())
            n = sum(c.count for _lv, c in fam.series())
            if n:
                out[key] = round(tot / n, kind)
    f = REGISTRY._families.get("hbm/peak_bytes")
    peaks = [c.value for _lv, c in f.series()] if f is not None else []
    out["peak_hbm_bytes"] = int(max(peaks)) if peaks else 0
    return out
