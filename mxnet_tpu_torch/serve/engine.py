"""Dynamic micro-batching inference engine, and the serving admission
errors the engines share.

Counterpart of the JAX package's ``serve/engine.py``.
``InferenceEngine`` turns one ``serving.Predictor`` into an online
serving path: concurrent requests enter a bounded queue; worker threads
coalesce them into batches padded to a fixed bucket ladder
(``serve/batching.py``), and one bound executor per bucket (derived with
``Predictor.reshape``, sharing the weights) runs each batch on the
predictor's device. Kept from the JAX engine:

* admission control: a full queue rejects at once (:class:`QueueFullError`);
* per-request deadlines: a request that expires while queued fails
  (:class:`DeadlineExceededError`) before its batch reaches the device;
* warmup: :meth:`warmup` runs every bucket once (building the kernels,
  cuDNN's plans and the bucket executors) before the engine reports
  ready;
* graceful drain: :meth:`close` stops admission, flushes every queued
  request through the model, then joins the workers;
* worker restarts: a crashed worker restarts in place, up to
  ``MXNET_SERVE_WORKER_RESTARTS`` across the crew;
* telemetry: ``serving/queue_depth``, ``serving/batch_rows``,
  ``serving/padding_waste_ratio``, ``serving/queue_wait_seconds`` vs
  ``serving/compute_seconds``, ``serving/request_seconds``,
  ``serving/{requests,rejected,timeouts,batches,worker_restarts}_total``.

Not ported yet: the tracing spans (``serve.*``, ROADMAP A3), the
``serve.worker`` fault point (A4), the per-bucket MFU of ``health`` (A5),
the compiled-program registry and its warm-set manifest (A6), and the
``engines_status`` rows of ``diagnostics()``.
"""
from __future__ import annotations

import logging
import threading
from collections import deque

import numpy as np

from .. import telemetry as _tm
from ..base import MXNetError
from .batching import parse_buckets, pick_bucket, validate_buckets

__all__ = ["ServeConfig", "InferenceEngine", "QueueFullError",
           "DeadlineExceededError", "EngineClosedError"]


class QueueFullError(MXNetError):
    """Admission control rejected the request (map to HTTP 503)."""


class DeadlineExceededError(MXNetError):
    """The request's deadline expired before compute (map to HTTP 504)."""


class EngineClosedError(MXNetError):
    """The engine is draining or closed (map to HTTP 503)."""


class ServeConfig(object):
    """Serving knobs. Defaults come from the ``MXNET_SERVE_*`` config
    table; constructor arguments override them per engine."""

    __slots__ = ("max_batch", "buckets", "queue_depth", "batch_wait",
                 "default_timeout", "workers", "worker_restarts")

    def __init__(self, max_batch=None, buckets=None, queue_depth=None,
                 batch_wait_ms=None, default_timeout_ms=None, workers=None,
                 worker_restarts=None):
        from ..config import get as _cfg

        def pick(val, name):
            return _cfg(name) if val is None else val

        self.max_batch = int(pick(max_batch, "MXNET_SERVE_MAX_BATCH"))
        spec = buckets if buckets is not None \
            else _cfg("MXNET_SERVE_BUCKETS")
        if isinstance(spec, (tuple, list)):
            self.buckets = validate_buckets(spec)
        else:
            self.buckets = parse_buckets(spec, self.max_batch)
        # the ladder caps the admissible request size
        self.max_batch = self.buckets[-1]
        self.queue_depth = int(pick(queue_depth, "MXNET_SERVE_QUEUE_DEPTH"))
        self.batch_wait = float(
            pick(batch_wait_ms, "MXNET_SERVE_BATCH_WAIT_MS")) / 1e3
        self.default_timeout = float(
            pick(default_timeout_ms, "MXNET_SERVE_DEADLINE_MS")) / 1e3
        self.workers = max(1, int(pick(workers, "MXNET_SERVE_WORKERS")))
        self.worker_restarts = max(0, int(pick(
            worker_restarts, "MXNET_SERVE_WORKER_RESTARTS")))
        if self.queue_depth < 1:
            raise MXNetError("queue_depth must be >= 1")


class _Request(object):
    """One submitted inference request; a thread-event future."""

    __slots__ = ("feed", "rows", "deadline", "t_enq", "_event", "outputs",
                 "error", "_tc_lock", "_timeout_counted")

    def __init__(self, feed, rows, deadline):
        self.feed = feed
        self.rows = rows
        self.deadline = deadline
        self.t_enq = _tm.monotonic()
        self._event = threading.Event()
        self.outputs = None
        self.error = None
        self._tc_lock = threading.Lock()
        self._timeout_counted = False

    def _count_timeout(self):
        """Count ``serving/timeouts_total`` once per request, whether the
        client's wait or the worker notices the expiry first."""
        with self._tc_lock:
            if self._timeout_counted:
                return
            self._timeout_counted = True
        _tm.counter("serving/timeouts_total",
                    "Requests failed on deadline expiry").inc()

    def set_result(self, outputs):
        self.outputs = outputs
        self._event.set()

    def set_error(self, exc):
        self.error = exc
        self._event.set()

    def wait(self, timeout=None):
        """Block until completion; True when a result or error is set."""
        return self._event.wait(timeout)

    def result(self):
        """Outputs (one numpy array per graph output), waiting at most
        until the request's deadline; raises the request's error, or
        :class:`DeadlineExceededError` at the deadline."""
        if self.deadline is None:
            self.wait()
        elif not self.wait(max(0.0, self.deadline - _tm.monotonic())
                           + 0.05):
            self._count_timeout()
            raise DeadlineExceededError(
                "no result within the %.0f ms deadline"
                % ((self.deadline - self.t_enq) * 1e3))
        if self.error is not None:
            raise self.error
        return self.outputs


class InferenceEngine(object):
    """Micro-batching execution engine over one bound model.

    predictor : serving.Predictor, bound with ``input_shapes``: its inputs
        define the per-row feature shapes (axis 0 is the batch axis of
        every input), and each bucket's executor is
        ``predictor.reshape(...)``, sharing its weights.
    config : ServeConfig, optional.
    """

    def __init__(self, predictor, config=None):
        self._cfg = config or ServeConfig()
        self._base = predictor
        self._input_names = list(predictor._input_names)
        if not self._input_names:
            raise MXNetError("predictor was bound without input_shapes; "
                             "the engine needs named inputs")
        self._feature = {}
        self._dtypes = {}
        for k in self._input_names:
            arr = predictor._exe.arg_dict[k]
            if len(arr.shape) < 1:
                raise MXNetError("input %r is a scalar; the batch axis "
                                 "(axis 0) is required" % k)
            self._feature[k] = tuple(arr.shape[1:])
            self._dtypes[k] = np.dtype(arr.dtype)
        self._preds = {}                 # bucket -> Predictor
        self._pred_locks = {}            # bucket -> forward lock
        self._build_lock = threading.Lock()
        self._queue = deque()
        self._cond = threading.Condition()
        self._accepting = True
        self._ready = False
        self._workers = []
        self._restarts_used = 0

        self._m_requests = _tm.counter(
            "serving/requests_total", "Inference requests accepted")
        self._m_rejected = _tm.counter(
            "serving/rejected_total",
            "Requests rejected by admission control (full queue / closed)")
        self._m_batches = _tm.counter(
            "serving/batches_total", "Coalesced batches executed")
        self._m_depth = _tm.gauge(
            "serving/queue_depth", "Requests waiting in the serve queue")
        self._m_batch_rows = _tm.histogram(
            "serving/batch_rows", "Real rows per executed batch")
        self._m_waste = _tm.histogram(
            "serving/padding_waste_ratio",
            "Padding rows / bucket rows per executed batch")
        self._m_qwait = _tm.histogram(
            "serving/queue_wait_seconds",
            "Time a request waited before its batch launched")
        self._m_compute = _tm.histogram(
            "serving/compute_seconds",
            "Forward wall time per batch (pad + run + fetch)")
        self._m_latency = _tm.histogram(
            "serving/request_seconds",
            "Inference request latency (host-side, submit to result)")

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Spawn the worker thread(s). Idempotent."""
        with self._cond:
            if self._workers:
                return self
            self._accepting = True
            self._restarts_used = 0
            for i in range(self._cfg.workers):
                t = threading.Thread(target=self._worker_main,
                                     name="mxnet-serve-worker-%d" % i,
                                     daemon=True)
                t.start()
                self._workers.append(t)
        return self

    def warmup(self):
        """Run every bucket once on a zeros feed, fetched to the host: the
        kernels are built, every bucket executor bound and the first
        launches paid before the engine reports :attr:`ready`."""
        for b in self._cfg.buckets:
            feed = {k: np.zeros((b,) + self._feature[k],
                                dtype=self._dtypes[k])
                    for k in self._input_names}
            pred = self._bucket_pred(b)
            with self._pred_locks[b]:
                for o in pred._exe.forward(is_train=False, **feed):
                    o.asnumpy()
        self._ready = True
        return self

    @property
    def ready(self):
        """Every bucket warmed and at least one worker alive."""
        return self._ready and any(t.is_alive() for t in self._workers)

    @property
    def config(self):
        return self._cfg

    def close(self, drain=True, timeout=30.0):
        """Stop admission; with ``drain`` run every queued request through
        the model, else fail them with :class:`EngineClosedError`. Then
        join the workers."""
        with self._cond:
            if not self._accepting and not self._workers:
                return
            self._accepting = False
            if not drain or not self._workers:
                # no worker will pop these: fail them rather than leave
                # futures that never resolve
                while self._queue:
                    self._queue.popleft().set_error(
                        EngineClosedError("engine closed"))
                self._m_depth.set(0)
            self._cond.notify_all()
        for t in self._workers:
            t.join(timeout=timeout)
        # a worker that outlived the join (a forward hung on the device)
        # stays tracked, so start() never spawns a second crew
        self._workers = [t for t in self._workers if t.is_alive()]
        self._ready = False

    # -- request path ------------------------------------------------------
    def submit(self, feed, timeout_ms=None):
        """Enqueue one request; returns its future (``.result()``).

        ``feed``: ``{input_name: array-like}`` (a bare array for a
        one-input model), every input with the same axis-0 row count
        ``1 <= rows <= max_batch``. Raises :class:`QueueFullError` at
        once when the queue is full and :class:`EngineClosedError` when
        draining or closed. Requests submitted before :meth:`start` wait
        in the queue for the workers."""
        feed, rows = self._check_feed(feed)
        timeout = (self._cfg.default_timeout if timeout_ms is None
                   else float(timeout_ms) / 1e3)
        deadline = (_tm.monotonic() + timeout) if timeout > 0 else None
        req = _Request(feed, rows, deadline)
        with self._cond:
            if not self._accepting:
                self._m_rejected.inc()
                raise EngineClosedError("engine is draining/closed")
            if len(self._queue) >= self._cfg.queue_depth:
                self._m_rejected.inc()
                raise QueueFullError(
                    "serve queue full (%d requests); retry later"
                    % self._cfg.queue_depth)
            self._queue.append(req)
            self._m_requests.inc()
            self._m_depth.set(len(self._queue))
            self._cond.notify()
        return req

    def predict(self, feed, timeout_ms=None):
        """Synchronous convenience: submit, wait, unpack."""
        return self.submit(feed, timeout_ms).result()

    def _check_feed(self, feed):
        if not isinstance(feed, dict):
            if len(self._input_names) != 1:
                raise MXNetError("model has inputs %s; pass a feed dict"
                                 % self._input_names)
            feed = {self._input_names[0]: feed}
        missing = [k for k in self._input_names if k not in feed]
        if missing:
            raise MXNetError("feed missing inputs %s" % missing)
        out, rows = {}, None
        for k in self._input_names:
            arr = np.asarray(feed[k], dtype=self._dtypes[k])
            if arr.ndim == len(self._feature[k]):
                arr = arr[None]          # one row without a batch axis
            if tuple(arr.shape[1:]) != self._feature[k]:
                raise MXNetError(
                    "input %r has feature shape %s, model expects %s"
                    % (k, tuple(arr.shape[1:]), self._feature[k]))
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise MXNetError("inputs disagree on the batch axis")
            out[k] = arr
        if rows < 1:
            raise MXNetError("empty request (0 rows)")
        if rows > self._cfg.max_batch:
            raise MXNetError("request of %d rows exceeds max_batch=%d; "
                             "split it client-side"
                             % (rows, self._cfg.max_batch))
        return out, rows

    # -- batching worker ---------------------------------------------------
    def _take_batch(self):
        """Pop a FIFO run of requests of at most ``max_batch`` rows,
        waiting up to ``batch_wait`` after the first for more. None when
        the engine is closed and the queue empty."""
        with self._cond:
            while not self._queue:
                if not self._accepting:
                    return None
                self._cond.wait(0.1)
            batch = [self._queue.popleft()]
            rows = batch[0].rows

            def grab():
                r = rows
                while (self._queue
                       and r + self._queue[0].rows <= self._cfg.max_batch):
                    req = self._queue.popleft()
                    batch.append(req)
                    r += req.rows
                return r

            rows = grab()
            if self._cfg.batch_wait > 0:
                t_end = _tm.monotonic() + self._cfg.batch_wait
                while rows < self._cfg.max_batch and self._accepting:
                    if self._queue:      # strict FIFO: a head that does
                        break            # not fit ends the window
                    remaining = t_end - _tm.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                    rows = grab()
            self._m_depth.set(len(self._queue))
            if self._queue:
                self._cond.notify()      # more work for another worker
        return batch

    def _worker_main(self):
        """Worker thread: run the loop; when it crashes (an exception that
        escapes the per-batch containment) restart it in place, within
        the crew's restart budget (``serving/worker_restarts_total``)."""
        while True:
            try:
                self._worker_loop()
                return                   # clean exit: engine closed
            except Exception as exc:
                with self._cond:
                    if not self._accepting:
                        return           # crash during drain: no restart
                    if self._restarts_used >= self._cfg.worker_restarts:
                        logging.error(
                            "serve worker crashed (%s) with the restart "
                            "budget (%d) exhausted; worker stays down",
                            exc, self._cfg.worker_restarts)
                        return
                    self._restarts_used += 1
                _tm.counter("serving/worker_restarts_total",
                            "Serve worker threads restarted after a "
                            "crash").inc()

    def _worker_loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._run_batch(batch)
            except Exception as exc:     # fail the batch, keep serving
                err = MXNetError("batch processing failed: %s" % exc)
                for req in batch:
                    if not req._event.is_set():
                        req.set_error(err)

    def _run_batch(self, batch):
        now = _tm.monotonic()
        live = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                req._count_timeout()
                req.set_error(DeadlineExceededError(
                    "deadline expired after %.0f ms in queue"
                    % ((now - req.t_enq) * 1e3)))
            else:
                live.append(req)
        if not live:
            return
        rows = sum(r.rows for r in live)
        bucket = pick_bucket(rows, self._cfg.buckets)
        if len(live) == 1 and live[0].rows == bucket:
            feed = live[0].feed          # exact fit: no host copy
        else:
            # one zeroed bucket buffer per input, each request's rows
            # copied in once (the padding comes free)
            feed = {}
            for k in self._input_names:
                buf = np.zeros((bucket,) + self._feature[k],
                               dtype=self._dtypes[k])
                offset = 0
                for r in live:
                    buf[offset:offset + r.rows] = r.feed[k]
                    offset += r.rows
                feed[k] = buf
        t0 = _tm.monotonic()
        try:
            pred = self._bucket_pred(bucket)
            with self._pred_locks[bucket]:
                outs = pred._exe.forward(is_train=False, **feed)
                outs_np = [o.asnumpy() for o in outs]
        except Exception as exc:          # surface, don't kill the worker
            err = MXNetError("batch execution failed: %s" % exc)
            for req in live:
                req.set_error(err)
            return
        t1 = _tm.monotonic()
        self._m_batches.inc()
        self._m_batch_rows.observe(rows)
        self._m_waste.observe((bucket - rows) / float(bucket))
        self._m_compute.observe(t1 - t0)
        exact_fit = len(live) == 1 and live[0].rows == bucket
        offset = 0
        for req in live:
            if exact_fit:
                res = outs_np
            else:
                # copies: a view would pin the whole padded output
                res = [o[offset:offset + req.rows].copy() for o in outs_np]
            offset += req.rows
            req.set_result(res)
            self._m_qwait.observe(t0 - req.t_enq)
            self._m_latency.observe(t1 - req.t_enq)

    # -- bucket executors --------------------------------------------------
    def _bucket_pred(self, bucket):
        """The predictor bound at ``bucket`` rows, built once; it shares
        the base predictor's weights (``Predictor.reshape``)."""
        pred = self._preds.get(bucket)
        if pred is not None:
            return pred
        with self._build_lock:
            pred = self._preds.get(bucket)
            if pred is None:
                base_rows = self._base._exe.arg_dict[
                    self._input_names[0]].shape[0]
                if base_rows == bucket:
                    pred = self._base
                else:
                    pred = self._base.reshape(
                        {k: (bucket,) + self._feature[k]
                         for k in self._input_names})
                self._pred_locks[bucket] = threading.Lock()
                self._preds[bucket] = pred
        return pred
