"""Backpressure-aware HTTP frontend for the inference engine.

Counterpart of the JAX package's ``serve/http.py``: the same routes,
bodies, chunk lines, status codes and headers. Stdlib-only
(http.server), like ``telemetry.serve``. Handler threads only move JSON
and numpy arrays; the engines' own threads run the model on the card.
One threaded server mounts:

* ``POST /predict`` — JSON in, JSON out (below). Maps engine outcomes
  onto the status codes a load balancer expects: **503** on admission
  rejection (full queue / draining; ``Retry-After`` set), **504** on
  deadline expiry, **400** on malformed input.
* ``POST /generate`` — autoregressive decode through a
  :class:`~mxnet_tpu_torch.serve.decode.DecodeEngine` (continuous batching +
  paged KV cache). Streams tokens as newline-delimited JSON chunks
  (``Transfer-Encoding: chunked``) as the scheduler produces them, or
  returns one JSON body with ``"stream": false``. Same status mapping;
  a 503 names whether the queue or the KV page pool is the saturated
  resource.
* ``GET /healthz`` — ``ok`` once every batch bucket is warm
  (:meth:`InferenceEngine.warmup`, and the decode engine's) and the
  workers are live (:meth:`InferenceEngine.start`), **503** ``warming``
  before that; a rollout gate that keeps kernel builds out of
  production traffic.
* ``GET /metrics`` — the shared telemetry registry in Prometheus text
  format (same payload as ``telemetry.serve``; scrape either).
* ``GET /traces`` and ``GET /alerts`` — the ``tracing`` and ``health``
  payloads (also mounted on ``telemetry.serve``).
* ``GET /programs`` and ``GET /cluster`` answer 404 naming the ROADMAP
  items that bring them (A6 the compiled-program registry, A16 the
  cluster observatory).

``/predict`` request body::

    {"inputs": {"data": [[...], ...]}, "timeout_ms": 500}

or, for single-input models, the bare array ``{"data": [[...], ...]}``
/ ``[[...], ...]``. Response::

    {"outputs": [[[...], ...]], "rows": N}

``/generate`` request body::

    {"prompt": [1, 5, 9], "max_new_tokens": 32, "timeout_ms": 30000,
     "stream": true, "stop_token": 2}

Streaming response: one ``{"token": t}`` JSON line per generated token,
then ``{"done": true, "n": N}`` (or ``{"error": ..., "code": ...}`` if
the session dies mid-stream — the status line was already sent).
Non-streaming: ``{"tokens": [...], "n": N}``.

``target`` is an :class:`InferenceEngine` or a
:class:`serve.ModelRegistry` (hot-swap safe) — anything with
``submit(feed, timeout_ms, ctx)``, ``engine()`` and ``ready`` — or None
for a decode-only frontend. ``decode`` is a
:class:`~mxnet_tpu_torch.serve.decode.DecodeEngine`
(defaults to ``target.decode_engine()`` when the target is a registry
with one attached).
"""
from __future__ import annotations

import json
import re
import threading

from ..base import MXNetError
from .. import telemetry as _tm
from .. import tracing as _tr
from .engine import DeadlineExceededError, EngineClosedError, QueueFullError

__all__ = ["serve_http", "ServeHTTPServer"]

# accepted X-Request-Id shape; anything else gets a fresh id (the
# header is echoed verbatim into responses and trace ids — never let a
# client smuggle header-splitting bytes through it)
_REQ_ID_RE = re.compile(r"^[A-Za-z0-9._\-]{1,64}$")


class ServeHTTPServer(object):
    """Handle on a running serving frontend (from :func:`serve_http`)."""

    def __init__(self, httpd, thread, target, decode=None):
        self._httpd = httpd
        self._thread = thread
        self.target = target
        self.decode = decode
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


def _parse_body(target, body):
    """(feed, timeout_ms) from a request body; raises MXNetError on
    malformed input (mapped to 400)."""
    try:
        payload = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise MXNetError("request body is not valid JSON: %s" % e)
    timeout_ms = None
    if isinstance(payload, dict) and "inputs" in payload:
        timeout_ms = payload.get("timeout_ms")
        feed = payload["inputs"]
        if not isinstance(feed, dict):
            raise MXNetError('"inputs" must be an object of '
                             'name -> array')
    else:
        feed = payload                   # bare array / {input: array}
    input_names = target.engine()._input_names
    if not isinstance(feed, dict):
        if len(input_names) != 1:
            raise MXNetError("model has inputs %s; post "
                             '{"inputs": {...}}' % input_names)
        feed = {input_names[0]: feed}
    unknown = [k for k in feed if k not in input_names]
    if unknown:
        raise MXNetError("unknown inputs %s (model has %s)"
                         % (unknown, input_names))
    return feed, timeout_ms


def _parse_generate_body(body):
    """(prompt, kwargs, stream) from a /generate request body; raises
    MXNetError on malformed input (mapped to 400)."""
    try:
        payload = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise MXNetError("request body is not valid JSON: %s" % e)
    if isinstance(payload, list):
        payload = {"prompt": payload}
    if not isinstance(payload, dict) or "prompt" not in payload:
        raise MXNetError('post {"prompt": [token ids], ...}')
    prompt = payload["prompt"]
    if not isinstance(prompt, list) or not prompt \
            or not all(isinstance(t, int) for t in prompt):
        raise MXNetError('"prompt" must be a non-empty list of int '
                         'token ids')
    kwargs = {}
    for key in ("max_new_tokens", "timeout_ms", "stop_token"):
        if payload.get(key) is not None:
            val = payload[key]
            if not isinstance(val, (int, float)):
                raise MXNetError('"%s" must be a number' % key)
            kwargs[key] = val
    return prompt, kwargs, bool(payload.get("stream", True))


def serve_http(target, port=0, addr="127.0.0.1", decode=None):
    """Start the serving frontend; returns a :class:`ServeHTTPServer`
    (``port=0`` picks a free port — read it from the handle)."""
    import http.server

    if decode is None and target is not None:
        getter = getattr(target, "decode_engine", None)
        if callable(getter):
            decode = getter()
    if target is None and decode is None:
        raise MXNetError("serve_http needs a predict target and/or a "
                         "decode engine")

    class _Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        _rid = None
        _tsink = None                    # router-hop span collector
        _tspan = None                    # open http.request span

        def _reply(self, code, payload, ctype="application/json",
                   headers=()):
            body = (json.dumps(payload).encode() + b"\n"
                    if not isinstance(payload, bytes) else payload)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if self._rid is not None:
                # every outcome — 200, 503, 504, 400 — echoes the
                # request id, so a client log line links to /traces
                self.send_header("X-Request-Id", self._rid)
            if self._tsink is not None and self._tspan is not None \
                    and self._tspan.ctx is not None:
                # routed request: ship this hop's spans back in-band so
                # the router can graft them into ITS trace. The
                # http.request span is still open (it closes after the
                # reply), so synthesize it now under its real span_id —
                # the buffer dedups on span_id, suppressing the real
                # close. The clock pair lets graft() rebase our
                # perf_counter epoch onto the router's.
                sp = self._tspan
                _tr.record_span(sp.name, sp.ctx, sp.t0, _tr._monotonic(),
                                attrs=dict(sp.attrs),
                                span_id=sp.ctx.span_id,
                                parent_id=sp.parent_id)
                self.send_header("X-Trace-Spans", json.dumps(
                    {"spans": self._tsink[:64],
                     "clock": [_tr._PROC_TOKEN, _tr._monotonic()]}))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _deadline_ms(self, timeout_ms):
            """Fold the router's remaining-deadline budget
            (``X-Deadline-Ms``) into the body timeout: the replica
            must give up no later than the router will, so replica-side
            504 accounting matches the router's view instead of
            burning a worker on an answer nobody is waiting for."""
            hdr = self.headers.get("X-Deadline-Ms")
            if hdr is None:
                return timeout_ms
            try:
                # the engine reads timeout <= 0 as "no deadline"; an
                # exhausted router budget must mean "already expired"
                budget = max(1e-9, float(hdr))
            except ValueError:
                return timeout_ms
            if timeout_ms is None or float(timeout_ms) <= 0:
                return budget
            return min(float(timeout_ms), budget)

        def do_GET(self):
            self._rid = None             # keep-alive: no stale echo
            self._tsink = None
            self._tspan = None
            path, _, query = self.path.partition("?")
            if path == "/metrics":
                self._reply(200, _tm.render_prometheus().encode(),
                            ctype="text/plain; version=0.0.4; "
                                  "charset=utf-8")
            elif path == "/healthz":
                ok = ((target is None or target.ready)
                      and (decode is None or decode.ready))
                if ok:
                    self._reply(200, b"ok\n",
                                ctype="text/plain; charset=utf-8")
                else:
                    self._reply(503, b"warming\n",
                                ctype="text/plain; charset=utf-8")
            elif path == "/traces":
                code, payload = _tr.traces_endpoint(query)
                self._reply(code, payload)
            elif path == "/alerts":
                from .. import health as _hl
                code, payload = _hl.alerts_endpoint(query)
                self._reply(code, payload)
            elif path in ("/programs", "/cluster"):
                code, payload = _tm.not_ported_endpoint(path)
                self._reply(code, payload)
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            self._rid = None             # keep-alive: no stale echo
            self._tsink = None
            self._tspan = None
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)   # always drain: HTTP/1.1
            path = self.path.split("?")[0]
            if path == "/predict" and target is not None:
                handler = self._predict
            elif path == "/generate" and decode is not None:
                handler = self._generate
            else:
                # keep-alive reuses the socket; an unread body would be
                # parsed as the next request line
                self._reply(404, {"error": "not found"})
                return
            # accept the caller's X-Request-Id as the trace id (echoed
            # either way, sampled or not); mint one otherwise
            rid = self.headers.get("X-Request-Id", "")
            if not _REQ_ID_RE.match(rid):
                rid = _tr.new_trace_id()
            self._rid = rid
            # a routed request carries the router's forward-span wire
            # context: join THAT trace (http.request becomes a child of
            # router.forward) and tee every span of this hop into a
            # sink shipped back via the X-Trace-Spans response header
            wctx = None
            wire_hdr = self.headers.get("X-Trace-Context")
            if wire_hdr:
                try:
                    sink = []
                    wctx = _tr.from_wire(json.loads(wire_hdr), sink)
                except (ValueError, TypeError, KeyError):
                    wctx = None
                if wctx is not None:
                    self._tsink = sink
            with _tr.start_span("http.request", ctx=wctx, trace_id=rid,
                                attrs={"path": path}) as span:
                self._tspan = span
                handler(body, span)

        def _predict(self, body, span):
            try:
                feed, timeout_ms = _parse_body(target, body)
                timeout_ms = self._deadline_ms(timeout_ms)
                req = target.submit(feed, timeout_ms, ctx=span.ctx)
            except (QueueFullError, EngineClosedError) as e:
                span.set_attr("http_status", 503)
                _tr.mark_error(e, ctx=span.ctx)
                self._reply(503, {"error": str(e)},
                            headers=(("Retry-After", "1"),))
                return
            except (MXNetError, ValueError, TypeError) as e:
                # ValueError/TypeError cover np.asarray on ragged input
                # and a non-numeric timeout_ms — still a client error
                span.set_attr("http_status", 400)
                self._reply(400, {"error": str(e)})
                return

            try:
                outputs = req.result()
            except DeadlineExceededError as e:
                span.set_attr("http_status", 504)
                _tr.mark_error(e, ctx=span.ctx)
                self._reply(504, {"error": str(e)})
                return
            except EngineClosedError as e:
                span.set_attr("http_status", 503)
                _tr.mark_error(e, ctx=span.ctx)
                self._reply(503, {"error": str(e)},
                            headers=(("Retry-After", "1"),))
                return
            except MXNetError as e:
                span.set_attr("http_status", 500)
                _tr.mark_error(e, ctx=span.ctx)
                self._reply(500, {"error": str(e)})
                return
            try:
                # bare NaN/Infinity literals are invalid JSON to strict
                # (RFC 8259) parsers: surface a 500, not a 200 the
                # client cannot parse
                body = json.dumps(
                    {"outputs": [o.tolist() for o in outputs],
                     "rows": req.rows}, allow_nan=False).encode() + b"\n"
            except ValueError:
                span.set_attr("http_status", 500)
                self._reply(500, {"error": "model output contains "
                                           "non-finite values"})
                return
            span.set_attr("rows", req.rows)
            self._reply(200, body)

        def _chunk(self, obj):
            """One chunked-transfer frame holding one JSON line."""
            data = json.dumps(obj).encode() + b"\n"
            self.wfile.write(b"%X\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()

        def _generate(self, body, span):
            try:
                prompt, kwargs, stream = _parse_generate_body(body)
                budget = self._deadline_ms(kwargs.get("timeout_ms"))
                if budget is not None:
                    kwargs["timeout_ms"] = budget
                sess = decode.submit(prompt, ctx=span.ctx, **kwargs)
            except (QueueFullError, EngineClosedError) as e:
                # PagePoolExhausted subclasses QueueFullError: same 503
                # path, page-exhaustion named in the error detail
                span.set_attr("http_status", 503)
                _tr.mark_error(e, ctx=span.ctx)
                self._reply(503, {"error": str(e)},
                            headers=(("Retry-After", "1"),))
                return
            except (MXNetError, ValueError, TypeError) as e:
                span.set_attr("http_status", 400)
                self._reply(400, {"error": str(e)})
                return

            if not stream:
                try:
                    toks = sess.result()
                except DeadlineExceededError as e:
                    span.set_attr("http_status", 504)
                    _tr.mark_error(e, ctx=span.ctx)
                    self._reply(504, {"error": str(e)})
                    return
                except MXNetError as e:
                    span.set_attr("http_status", 500)
                    _tr.mark_error(e, ctx=span.ctx)
                    self._reply(500, {"error": str(e)})
                    return
                span.set_attr("tokens", len(toks))
                self._reply(200, {"tokens": toks, "n": len(toks)})
                return

            # streaming: the status line goes out before the first
            # token exists, so mid-stream failures ride an in-band
            # {"error": ...} line (the span still records the status)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            if self._rid is not None:
                self.send_header("X-Request-Id", self._rid)
            self.end_headers()
            n = 0
            try:
                try:
                    for tok in sess.tokens():
                        self._chunk({"token": tok})
                        n += 1
                    self._chunk({"done": True, "n": n})
                except DeadlineExceededError as e:
                    span.set_attr("http_status", 504)
                    _tr.mark_error(e, ctx=span.ctx)
                    self._chunk({"error": str(e), "code": 504})
                except MXNetError as e:
                    span.set_attr("http_status", 500)
                    _tr.mark_error(e, ctx=span.ctx)
                    self._chunk({"error": str(e), "code": 500})
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                # client hung up mid-stream: cancel the session so its
                # slot and page reservation free NOW, not at deadline
                decode.cancel(sess, "client disconnected")
            span.set_attr("tokens", n)

        def log_message(self, *args):    # no stderr chatter per request
            pass

    httpd = http.server.ThreadingHTTPServer((addr, port), _Handler)
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever,
                              name="mxnet-serve-http", daemon=True)
    thread.start()
    # publish this mount as the process's scrapable endpoint (elastic
    # heartbeats and the cluster observatory read it)
    _tm.set_server_endpoint(addr, httpd.server_address[1])
    return ServeHTTPServer(httpd, thread, target, decode)
