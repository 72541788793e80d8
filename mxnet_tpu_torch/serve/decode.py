"""Continuous-batching autoregressive decode serving.

:class:`DecodeEngine` schedules at ITERATION granularity, as the JAX
package's engine of the same name does:

* the scheduler loop admits and retires requests **every decode
  step** — a finishing sequence's slot is reassigned on the next
  iteration, not at end-of-batch;
* **prefill** and **decode** are separate bucketed phases: a prompt
  prefills at batch 1, right-padded to a power-of-two ladder of page
  multiples (one causal forward per admission, through the
  ``flash_prefill_paged`` kernel), and decode runs at power-of-two
  slot-count buckets with every live sequence at its own depth (through
  ``paged_decode_attention``); padding slots write the null page;
* the KV cache lives in a preallocated device **page pool** with
  per-request block tables (serve/kv_pages.py +
  ``parallel.transformer.PagedKVCache``), updated in place by every
  prefill and step;
* **admission control** reserves the pages a request needs for its
  whole lifetime (prompt + max_new_tokens) at submit, and refuses what
  the pool cannot cover (:class:`PagePoolExhausted`) or what the queue
  cannot hold (:class:`QueueFullError`), so a running sequence is never
  evicted for memory;
* tokens **stream** as they are produced (:meth:`DecodeSession.tokens`)
  under per-request deadlines; :meth:`DecodeEngine.cancel`, crash
  recovery that frees every crashed session's pages, weight hot-swap
  (:meth:`DecodeEngine.swap_params`) and ``close(drain)`` keep the JAX
  engine's semantics.

Decoding is greedy (argmax). The engine runs on ``cuda:0`` unless the
caller passes ``device="cpu"``; all model work runs on the scheduler
thread under ``torch.inference_mode()``.

Observability, as the JAX engine: a request's trace context
(``submit(ctx=)``, kept as ``DecodeSession.tctx``) gets the
``decode.schedule``, ``decode.prefill`` and ``decode.step`` spans; the
``decode.step`` fault point sits at the top of each scheduler iteration;
each prefill and step wall (it ends when the tokens are on the host) is
priced with this engine's cost record of its bucket
(``health.transformer_cost``) into ``decode/mfu{phase,bucket}``;
:attr:`DecodeEngine.ready` is the ``/healthz`` gate. ``program_count``,
``warm_report`` and ``warmup(use_manifest=)`` belong to the compiled-
program registry (ROADMAP A6).

Telemetry: ``decode/requests_total``, ``decode/rejected_total{reason}``,
``decode/tokens_total``, ``decode/slot_occupancy``,
``decode/page_pool_free``, ``decode/prefill_seconds``,
``decode/step_seconds``, ``decode/preempted_total``,
``decode/timeouts_total``, ``decode/worker_restarts_total``. Knobs:
``MXNET_DECODE_*`` and ``MXNET_SERVE_WORKER_RESTARTS`` (config.py).
"""
from __future__ import annotations

import contextlib
import logging
import queue as _queue
import threading
import time
from collections import deque

import numpy as _np
import torch

from .. import fault as _fault
from .. import health as _health
from .. import telemetry as _tm
from .. import tracing as _tr
from ..base import MXNetError
from ..config import get as _cfg
from ..context import default_device
from ..parallel.transformer import (PagedKVCache, init_kv_pages,
                                    transformer_decode_step,
                                    transformer_prefill_paged)
from .batching import pick_bucket, power_of_two_buckets
from .engine import (DeadlineExceededError, EngineClosedError,
                     QueueFullError)
from .kv_pages import PagePool, PagePoolExhausted, pages_needed

__all__ = ["DecodeConfig", "DecodeEngine", "DecodeSession"]

_SENTINEL = object()


class DecodeConfig(object):
    """Decode-serving knobs. Defaults come from the ``MXNET_DECODE_*``
    config tier; constructor arguments override per engine."""

    __slots__ = ("slots", "page_size", "num_pages", "max_context",
                 "queue_depth", "max_new_tokens", "default_timeout",
                 "worker_restarts", "prefill_buckets", "slot_buckets")

    def __init__(self, slots=None, page_size=None, num_pages=None,
                 max_context=None, queue_depth=None, max_new_tokens=None,
                 default_timeout_ms=None, worker_restarts=None):
        def pick(val, name):
            return _cfg(name) if val is None else val

        self.slots = int(pick(slots, "MXNET_DECODE_SLOTS"))
        self.page_size = int(pick(page_size, "MXNET_DECODE_PAGE_SIZE"))
        self.num_pages = int(pick(num_pages, "MXNET_DECODE_NUM_PAGES"))
        self.max_context = int(pick(max_context,
                                    "MXNET_DECODE_MAX_CONTEXT"))
        self.queue_depth = int(pick(queue_depth,
                                    "MXNET_DECODE_QUEUE_DEPTH"))
        self.max_new_tokens = int(pick(max_new_tokens,
                                       "MXNET_DECODE_MAX_NEW_TOKENS"))
        self.default_timeout = float(pick(
            default_timeout_ms, "MXNET_DECODE_DEADLINE_MS")) / 1e3
        self.worker_restarts = max(0, int(pick(
            worker_restarts, "MXNET_SERVE_WORKER_RESTARTS")))
        if self.slots < 1:
            raise MXNetError("slots must be >= 1")
        if self.queue_depth < 1:
            raise MXNetError("queue_depth must be >= 1")
        if self.page_size < 1:
            raise MXNetError("page_size must be >= 1")
        if self.max_context % self.page_size:
            raise MXNetError(
                "max_context=%d must be a multiple of page_size=%d "
                "(positions map to whole pages)"
                % (self.max_context, self.page_size))
        # prefill ladder: page_size, 2*ps, 4*ps, ... capped at
        # max_context (appended as the final bucket) — every bucket a
        # page multiple, so the prefill page write covers whole pages
        buckets, b = [], self.page_size
        while b < self.max_context:
            buckets.append(b)
            b *= 2
        buckets.append(self.max_context)
        self.prefill_buckets = tuple(buckets)
        self.slot_buckets = power_of_two_buckets(self.slots)

    @property
    def pages_per_seq(self):
        return self.max_context // self.page_size


class DecodeSession(object):
    """One admitted generation request: a token STREAM plus its page
    reservation and decode cursor. Produced tokens arrive on a
    thread-safe queue as the scheduler emits them; consume with
    :meth:`tokens` / :meth:`next_token` (streaming) or :meth:`result`
    (wait for the full generation)."""

    __slots__ = ("prompt", "prompt_len", "max_new_tokens", "stop_token",
                 "deadline", "t_enq", "t_admit", "t_first", "t_done",
                 "tctx", "page_ids", "block_table", "pos", "last_token",
                 "generated", "out_tokens", "error", "_q", "_finished")

    def __init__(self, prompt, max_new_tokens, stop_token, deadline,
                 tctx=None):
        self.prompt = prompt
        self.prompt_len = len(prompt)
        self.max_new_tokens = max_new_tokens
        self.stop_token = stop_token
        self.deadline = deadline
        self.t_enq = _tm.monotonic()
        self.t_admit = None
        self.t_first = None
        self.t_done = None
        self.tctx = tctx                 # the trace context, or None
        self.page_ids = None
        self.block_table = None
        self.pos = 0                     # next position to WRITE
        self.last_token = None           # feeds the next decode step
        self.generated = 0
        self.out_tokens = []
        self.error = None
        self._q = _queue.Queue()
        self._finished = False

    # -- producer side (scheduler thread) ---------------------------------
    def _emit(self, tok):
        if self.t_first is None:
            self.t_first = _tm.monotonic()
        self.out_tokens.append(tok)
        self.generated += 1
        self.last_token = tok
        self._q.put(tok)

    def _finish(self, error=None):
        if self._finished:
            return
        self._finished = True
        self.error = error
        self.t_done = _tm.monotonic()
        if error is not None and self.tctx is not None:
            _tr.mark_error(error, ctx=self.tctx)
        self._q.put(_SENTINEL)

    @property
    def done(self):
        return self._finished

    # -- consumer side ----------------------------------------------------
    def next_token(self, timeout=None):
        """Next generated token id; None when the stream has ended.
        Waits up to ``timeout`` (default: the session deadline); raises
        the session's error — :class:`DeadlineExceededError` when the
        server retired it, or locally when no token arrives in time."""
        if timeout is None and self.deadline is not None:
            timeout = max(0.0, self.deadline - _tm.monotonic()) + 0.25
        try:
            tok = self._q.get(timeout=timeout)
        except _queue.Empty:
            raise DeadlineExceededError(
                "no token within the per-token deadline")
        if tok is _SENTINEL:
            self._q.put(_SENTINEL)       # keep the stream terminal
            if self.error is not None:
                raise self.error
            return None
        return tok

    def tokens(self):
        """Generator over the token stream (blocks between tokens)."""
        while True:
            tok = self.next_token()
            if tok is None:
                return
            yield tok

    def result(self):
        """Every generated token (blocks until the stream ends)."""
        for _ in self.tokens():
            pass
        return list(self.out_tokens)


class DecodeEngine(object):
    """Iteration-level scheduling decode engine over one transformer.

    Parameters
    ----------
    params : parallel.transformer.TransformerParams
        The weights; moved to ``device`` (``nn.Module.to``, in place).
    model_cfg : parallel.transformer.TransformerConfig
    config : DecodeConfig, optional
    device : torch.device or str, optional
        ``cuda:0`` by default; ``"cpu"`` runs the plain versions of the
        kernels on the host. With no CUDA device and no explicit CPU
        request the constructor raises :class:`MXNetError`.

    The page pool is allocated once and updated in place by every
    prefill and decode step.
    """

    def __init__(self, params, model_cfg, config=None, device=None):
        self._device = default_device(device)
        self._cfg = config or DecodeConfig()
        self._model_cfg = model_cfg
        self._params = params.to(self._device)
        self._vocab = int(model_cfg.vocab_size)
        self._pool = PagePool(self._cfg.num_pages)
        self._k_pages, self._v_pages = init_kv_pages(
            model_cfg, self._cfg.num_pages, self._cfg.page_size,
            device=self._device)
        self._cond = threading.Condition()
        self._waiting = deque()
        self._live = []
        self._accepting = True
        self._closing = False
        self._worker = None
        self._warmup_req = None
        self._restarts_used = 0
        self._iter_hook = None
        self._ready = False
        self._prog_costs = {}            # (phase, bucket) -> cost record

        self._m_requests = _tm.counter(
            "decode/requests_total", "Decode requests admitted")
        self._m_rejected = _tm.counter(
            "decode/rejected_total",
            "Decode requests refused at admission (queue depth or page "
            "pool)", ("reason",))
        self._m_tokens = _tm.counter(
            "decode/tokens_total", "Tokens generated (all sessions)")
        self._m_occupancy = _tm.gauge(
            "decode/slot_occupancy",
            "Live decode slots (out of MXNET_DECODE_SLOTS)")
        self._m_free = _tm.gauge(
            "decode/page_pool_free", "Free KV-cache pages in the pool")
        self._m_prefill = _tm.histogram(
            "decode/prefill_seconds",
            "Prefill wall time per admission (bucketed prompt forward)")
        self._m_step = _tm.histogram(
            "decode/step_seconds",
            "Decode step wall time (one token for every live slot)")
        self._m_preempted = _tm.counter(
            "decode/preempted_total",
            "Sessions retired abnormally mid-decode (crash containment "
            "or deadline expiry in a slot)")
        self._m_timeouts = _tm.counter(
            "decode/timeouts_total",
            "Sessions failed on deadline expiry (queued or decoding)")
        self._m_free.set(self._pool.free_pages)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Spawn the scheduler thread. Idempotent."""
        with self._cond:
            if self._worker is not None and self._worker.is_alive():
                return self
            self._closing = False
            self._accepting = True
            self._worker = threading.Thread(
                target=self._worker_main, name="mxnet-decode-scheduler",
                daemon=True)
            self._worker.start()
        return self

    def warmup(self, timeout=600.0):
        """Build the CUDA kernels and run every prefill bucket and every
        decode slot bucket once (writes go to the reserved null page),
        on the scheduler thread, where traffic will run them."""
        self.start()
        req = {"event": threading.Event(), "error": None}
        with self._cond:
            self._warmup_req = req
            self._cond.notify_all()
        if not req["event"].wait(timeout):
            raise MXNetError("decode warmup did not finish in %.0fs"
                             % timeout)
        if req["error"] is not None:
            raise req["error"]
        self._ready = True
        return self

    def _do_warmup(self):
        if self._device.type == "cuda":
            from ..ops.cuda import _build
            _build.build_all()
        for bucket in self._cfg.prefill_buckets:
            n_pb = bucket // self._cfg.page_size
            self._run_prefill(_np.zeros(n_pb, _np.int32),
                              _np.zeros((1, bucket), _np.int32), bucket)
            self._cost("prefill", bucket)
        for nslots in self._cfg.slot_buckets:
            self._run_step(
                _np.zeros((nslots, self._cfg.pages_per_seq), _np.int32),
                _np.zeros(nslots, _np.int32), _np.zeros(nslots, _np.int32))
            self._cost("step", nslots)
        if self._device.type == "cuda":
            _tm.record_hbm(self._device)

    def _cost(self, phase, bucket):
        """This engine's cost record of a prefill bucket (``bucket``
        prompt positions) or a step bucket (``bucket`` slots over the
        block table's context): ``health.transformer_cost``."""
        key = (phase, bucket)
        if key not in self._prog_costs:
            cfg = self._model_cfg
            itemsize = torch.empty((), dtype=cfg.dtype).element_size()
            if phase == "prefill":
                args = (cfg, "prefill", 1, bucket, bucket, itemsize)
            else:
                args = (cfg, "step", bucket, 1, self._cfg.max_context,
                        itemsize)
            self._prog_costs[key] = _health.capture_cost(
                "decode_" + phase, _health.next_cost_key("dec"),
                _health.transformer_cost, args)
        return self._prog_costs[key]

    @property
    def ready(self):
        """Warmed and the scheduler thread alive (the /healthz gate, as
        ``InferenceEngine.ready``)."""
        return (self._ready and self._worker is not None
                and self._worker.is_alive())

    @property
    def config(self):
        return self._cfg

    def pause(self, drain=True, timeout=30.0):
        """Stop admission; with ``drain`` wait for every live and
        queued session to finish. Returns True when fully drained."""
        with self._cond:
            self._accepting = False
            self._cond.notify_all()
        if not drain:
            return self._idle()
        t_end = _tm.monotonic() + timeout
        while not self._idle() and _tm.monotonic() < t_end:
            time.sleep(0.005)
        return self._idle()

    def resume(self):
        """Re-open admission after :meth:`pause`."""
        with self._cond:
            if self._closing:
                raise EngineClosedError("engine is closed")
            self._accepting = True
            self._cond.notify_all()

    def swap_params(self, params, timeout=30.0):
        """Hot-swap the transformer weights: drains every decode
        session (they finish on the old weights), swaps the params
        (moved to the engine's device), re-opens admission."""
        if not self.pause(drain=True, timeout=timeout):
            self.resume()
            raise MXNetError(
                "decode sessions did not drain within %.1fs; weights "
                "unchanged" % timeout)
        self._params = params.to(self._device)
        self.resume()
        return self

    def _idle(self):
        with self._cond:
            return not self._live and not self._waiting

    def close(self, drain=True, timeout=30.0):
        """Stop admission; with ``drain`` finish every admitted
        session, else fail them; then stop the scheduler thread."""
        with self._cond:
            self._accepting = False
            if not drain:
                for sess in list(self._waiting) + list(self._live):
                    self._release_pages(sess)
                    sess._finish(EngineClosedError("engine closed"))
                self._waiting.clear()
                del self._live[:]
            self._closing = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=timeout)
        self._ready = False

    # -- admission ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, timeout_ms=None,
               stop_token=None, ctx=None):
        """Admit one generation request; returns its
        :class:`DecodeSession` stream.

        ``prompt``: iterable of int token ids. ``max_new_tokens``
        defaults to (and is capped by) ``MXNET_DECODE_MAX_NEW_TOKENS``.
        Raises :class:`QueueFullError` when the waiting queue is at
        depth, and its subclass :class:`PagePoolExhausted` when the page
        pool cannot cover prompt + max_new_tokens. The page reservation
        covers the request's WHOLE lifetime. ``ctx``: the trace context
        the scheduler records ``decode.*`` spans under (defaults to the
        caller's active one)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise MXNetError("empty prompt")
        for t in prompt:
            if t < 0 or t >= self._vocab:
                raise MXNetError("prompt token %d outside the model "
                                 "vocabulary [0, %d)" % (t, self._vocab))
        max_new = (self._cfg.max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        if max_new < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        max_new = min(max_new, self._cfg.max_new_tokens)
        plen = len(prompt)
        if plen > self._cfg.prefill_buckets[-1]:
            raise MXNetError(
                "prompt of %d tokens exceeds the largest prefill "
                "bucket %d" % (plen, self._cfg.prefill_buckets[-1]))
        if plen + max_new > self._cfg.max_context:
            raise MXNetError(
                "prompt (%d) + max_new_tokens (%d) exceeds "
                "max_context=%d" % (plen, max_new, self._cfg.max_context))
        timeout = (self._cfg.default_timeout if timeout_ms is None
                   else float(timeout_ms) / 1e3)
        deadline = (_tm.monotonic() + timeout) if timeout > 0 else None
        sess = DecodeSession(prompt, max_new, stop_token, deadline,
                             ctx if ctx is not None else _tr.active())
        # pages for the whole lifetime: the prefill BUCKET (its page
        # write covers the padded prompt) and prompt+max_new positions
        ps = self._cfg.page_size
        n_pages = max(pages_needed(plen + max_new, ps),
                      pages_needed(pick_bucket(
                          plen, self._cfg.prefill_buckets), ps))
        with self._cond:
            if not self._accepting or self._closing:
                self._m_rejected.labels("closed").inc()
                raise EngineClosedError(
                    "decode engine is draining/closed")
            if len(self._waiting) >= self._cfg.queue_depth:
                self._m_rejected.labels("queue_depth").inc()
                raise QueueFullError(
                    "decode queue full (%d requests waiting); retry "
                    "later" % self._cfg.queue_depth)
            try:
                sess.page_ids = self._pool.alloc(n_pages)
            except PagePoolExhausted:
                self._m_rejected.labels("pages").inc()
                raise
            bt = _np.zeros(self._cfg.pages_per_seq, _np.int32)
            bt[:n_pages] = sess.page_ids
            sess.block_table = bt
            self._waiting.append(sess)
            self._m_requests.inc()
            self._m_free.set(self._pool.free_pages)
            self._cond.notify_all()
        return sess

    def generate(self, prompt, max_new_tokens=None, timeout_ms=None,
                 stop_token=None):
        """Synchronous convenience: submit + wait + full token list."""
        return self.submit(prompt, max_new_tokens, timeout_ms,
                           stop_token).result()

    def cancel(self, sess, reason="cancelled"):
        """Abort a session. A waiting session releases its pages
        immediately; a live one is marked failed and SWEPT by the
        scheduler at the next iteration boundary (its pages may still
        be written by the step in flight). Returns True when this call
        cancelled the session."""
        err = MXNetError("decode session cancelled: %s" % reason)
        with self._cond:
            if sess.done:
                return False
            if sess in self._waiting:
                self._waiting.remove(sess)
                self._release_pages(sess)
                sess._finish(err)
                self._m_free.set(self._pool.free_pages)
                return True
            sess._finish(err)            # scheduler sweep retires it
            self._cond.notify_all()
            return True

    # -- scheduler ---------------------------------------------------------
    def _device_scope(self):
        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return contextlib.nullcontext()

    def _worker_main(self):
        """Run the scheduler loop (grad mode and the current CUDA device
        are thread-local, so both are set here); on a crash retire every
        live and queued session — their pages return to the pool — and
        restart the loop in place, up to the restart budget. The pool
        needs no reset: a new session's positions are always written
        before they are read."""
        with torch.inference_mode(), self._device_scope():
            while True:
                try:
                    self._loop()
                    return               # clean exit: engine closed
                except BaseException as exc:  # crash containment boundary
                    self._crash_recover(exc)
                    with self._cond:
                        if self._closing:
                            return
                        if self._restarts_used >= self._cfg.worker_restarts:
                            logging.error(
                                "decode scheduler crashed (%s) with the "
                                "restart budget (%d) exhausted; decode "
                                "serving stays down", exc,
                                self._cfg.worker_restarts)
                            return
                        self._restarts_used += 1
                    _tm.counter("decode/worker_restarts_total",
                                "Decode scheduler threads restarted "
                                "after a crash").inc()

    def _crash_recover(self, exc):
        logging.exception("decode scheduler crashed")
        err = MXNetError("decode step failed: %s" % exc)
        with self._cond:
            victims = list(self._live) + list(self._waiting)
            del self._live[:]
            self._waiting.clear()
            for sess in victims:
                self._release_pages(sess)
                self._m_preempted.inc()
                sess._finish(err)
            self._m_occupancy.set(0)
            self._m_free.set(self._pool.free_pages)

    def _release_pages(self, sess):
        if sess.page_ids:
            self._pool.free(sess.page_ids)
            sess.page_ids = None

    def _retire_locked(self, sess, error=None):
        """Retire a session (caller holds the lock): slot freed for
        next iteration's admission, pages back to the pool."""
        if sess in self._live:
            self._live.remove(sess)
        self._release_pages(sess)
        sess._finish(error)
        self._m_occupancy.set(len(self._live))
        self._m_free.set(self._pool.free_pages)

    def set_iteration_hook(self, fn):
        """Install (or clear, with None) a callable run on the
        SCHEDULER thread at the top of every loop iteration, before
        admission — outside the engine lock, so it may block. The
        deterministic-testing seam: a hook that parks on a semaphore
        single-steps the scheduler, one that raises takes the
        crash-recovery path. A blocking hook also blocks ``close()``.
        Not a production surface."""
        self._iter_hook = fn

    def _loop(self):
        while True:
            hook = self._iter_hook
            if hook is not None:
                hook()
            _fault.inject("decode.step")
            with self._cond:
                wreq, self._warmup_req = self._warmup_req, None
            if wreq is not None:
                try:
                    self._do_warmup()
                except Exception as exc:  # reported to warmup()'s caller
                    wreq["error"] = exc
                finally:
                    wreq["event"].set()
            with self._cond:
                while (not self._waiting and not self._live
                       and self._warmup_req is None):
                    if self._closing:
                        return
                    self._cond.wait(0.05)
                if self._warmup_req is not None:
                    continue
                t_sched0 = _tm.monotonic()
                evictions = self._expire_locked()
                admits = []
                while (self._waiting
                       and len(self._live) < self._cfg.slots):
                    sess = self._waiting.popleft()
                    # joins the slot list BEFORE its prefill runs (so a
                    # concurrent close/crash-recover can't lose it);
                    # t_admit is None until the prefill lands, which
                    # keeps it out of this iteration's step batch
                    self._live.append(sess)
                    admits.append(sess)
                self._m_occupancy.set(len(self._live))
                t_sched1 = _tm.monotonic()
            if admits or evictions:
                self._record_schedule(admits, evictions, t_sched0, t_sched1)
            for sess in admits:
                self._prefill(sess)
            self._step()

    def _expire_locked(self):
        """Fail sessions past their deadline (queued: before a prefill
        is wasted on them; live: the slot frees this iteration) and
        sweep cancelled live sessions whose pages were kept until the
        step in flight landed. Returns the number evicted."""
        now = _tm.monotonic()
        evicted = 0
        for sess in [s for s in self._live if s.done]:
            self._live.remove(sess)
            self._release_pages(sess)
            self._m_preempted.inc()
            evicted += 1
        self._m_occupancy.set(len(self._live))
        self._m_free.set(self._pool.free_pages)
        for sess in [s for s in self._waiting
                     if s.deadline is not None and now > s.deadline]:
            self._waiting.remove(sess)
            self._release_pages(sess)
            self._m_timeouts.inc()
            evicted += 1
            sess._finish(DeadlineExceededError(
                "deadline expired after %.0f ms in the decode queue"
                % ((now - sess.t_enq) * 1e3)))
        for sess in [s for s in self._live
                     if s.deadline is not None and now > s.deadline]:
            self._m_timeouts.inc()
            self._m_preempted.inc()
            evicted += 1
            self._retire_locked(sess, DeadlineExceededError(
                "deadline expired after %d of %d tokens"
                % (sess.generated, sess.max_new_tokens)))
        return evicted

    def _record_schedule(self, admits, evictions, t0, t1):
        sid = None
        attrs = {"slots": len(self._live),
                 "live_pages": self._pool.used_pages,
                 "evictions": evictions}
        for sess in admits:
            ctx = sess.tctx
            if ctx is None or not ctx.sampled:
                continue
            if sid is None:
                sid = _tr.new_span_id()
            _tr.record_span("decode.schedule", ctx, t0, t1,
                            span_id=sid, parent_id=ctx.span_id,
                            attrs=attrs)

    def _prefill(self, sess):
        """Bucketed prefill for one admission: pad the prompt to its
        ladder bucket, run ONE causal forward that writes the prompt K/V
        into the session's pages, and emit the first generated token
        from the logits at the last real position."""
        bucket = pick_bucket(sess.prompt_len, self._cfg.prefill_buckets)
        n_pb = bucket // self._cfg.page_size
        with self._cond:
            if sess.done:                # failed concurrently (close/
                return                   # cancel/deadline) pre-prefill
            # snapshot under the lock: a concurrent close may null
            # page_ids the instant the session is failed
            page_ids = _np.asarray(sess.page_ids[:n_pb], _np.int32)
        padded = _np.zeros((1, bucket), _np.int32)
        padded[0, :sess.prompt_len] = sess.prompt
        t0 = _tm.monotonic()
        tok0 = self._run_prefill(page_ids, padded, sess.prompt_len)
        # the wall ends with the first token on the host
        t1 = _tm.monotonic()
        self._m_prefill.observe(
            t1 - t0, trace_id=sess.tctx.trace_id if sess.tctx else None)
        _health.note_decode("prefill", bucket, t1 - t0,
                            self._cost("prefill", bucket))
        if sess.tctx is not None and sess.tctx.sampled:
            _tr.record_span("decode.prefill", sess.tctx, t0, t1,
                            parent_id=sess.tctx.span_id,
                            attrs={"bucket": bucket,
                                   "prompt_len": sess.prompt_len})
        with self._cond:
            if sess.done:
                return
            sess.t_admit = t0
            sess.pos = sess.prompt_len
            self._emit_locked(sess, tok0)

    def _emit_locked(self, sess, tok):
        """Deliver one token; retire the session once it hits its
        max_new_tokens budget or its stop token (caller holds the
        lock)."""
        sess._emit(tok)
        self._m_tokens.inc()
        if (sess.generated >= sess.max_new_tokens
                or (sess.stop_token is not None
                    and tok == sess.stop_token)):
            self._retire_locked(sess)

    def _step(self):
        """One decode iteration: every live slot advances one token
        through the slot-bucket step (padding slots write the null page
        and are discarded)."""
        with self._cond:
            live = [s for s in self._live if s.t_admit is not None]
        if not live:
            return
        nslots = pick_bucket(len(live), self._cfg.slot_buckets)
        tokens = _np.zeros(nslots, _np.int32)
        pos = _np.zeros(nslots, _np.int32)
        bt = _np.zeros((nslots, self._cfg.pages_per_seq), _np.int32)
        for i, sess in enumerate(live):
            tokens[i] = sess.last_token
            pos[i] = sess.pos
            bt[i] = sess.block_table
        t0 = _tm.monotonic()
        toks = self._run_step(bt, tokens, pos)
        # the wall ends with the tokens on the host
        t1 = _tm.monotonic()
        self._m_step.observe(t1 - t0)
        _health.note_decode("step", nslots, t1 - t0,
                            self._cost("step", nslots))
        traced = [s for s in live
                  if s.tctx is not None and s.tctx.sampled]
        if traced:
            sid = _tr.new_span_id()
            attrs = {"slots": len(live), "bucket": nslots,
                     "live_pages": self._pool.used_pages}
            for sess in traced:
                _tr.record_span("decode.step", sess.tctx, t0, t1,
                                span_id=sid, parent_id=sess.tctx.span_id,
                                attrs=attrs)
        with self._cond:
            for i, sess in enumerate(live):
                if sess.done:            # expired/retired concurrently
                    continue
                sess.pos += 1
                self._emit_locked(sess, int(toks[i]))

    # -- model calls (scheduler thread, inference mode) --------------------
    def _run_prefill(self, page_ids, padded, length):
        """Batch-1 paged prefill of one padded prompt; the greedy first
        token."""
        dev = self._device
        cache = PagedKVCache(self._k_pages, self._v_pages,
                             torch.from_numpy(page_ids[None]).to(dev),
                             self._cfg.page_size)
        logits, _ = transformer_prefill_paged(
            self._params, cache, torch.from_numpy(padded).to(dev),
            torch.tensor([length], dtype=torch.int32, device=dev),
            self._model_cfg)
        return int(torch.argmax(logits[0]))

    def _run_step(self, bt, tokens, pos):
        """One decode step of a slot bucket; greedy tokens as numpy."""
        dev = self._device
        cache = PagedKVCache(self._k_pages, self._v_pages,
                             torch.from_numpy(bt).to(dev),
                             self._cfg.page_size)
        logits, _ = transformer_decode_step(
            self._params, cache, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos).to(dev), self._model_cfg)
        return torch.argmax(logits, -1).cpu().numpy()
