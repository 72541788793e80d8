"""Deterministic fault-injection harness.

Counterpart of the JAX package's ``fault.py``: the same points, kinds,
``MXNET_FAULT_INJECT`` syntax and counting. The points whose call sites
the port does not have yet stay declared: ``kv.*`` come with the
kvstores (ROADMAP A8.3 / A13), ``router.forward`` and ``fleet.replica``
with the fleet tier (A16), ``dist.*`` with elastic training (A13).

The reference stack assumes components die mid-job (ps-lite dead-node
tracking behind ``kvstore.h:353``); on a shared cluster preemption is the
*normal* failure mode. Every recovery claim in this codebase — atomic
checkpoints, auto-resume, retrying kvstore transport, serve worker
restarts — is therefore proven under *injected* faults rather than
asserted from code reading.

A fault is armed at a named **injection point**. Production code calls
:func:`inject` at those points; when nothing is armed the call is one
module-bool check (safe on hot paths). Armed faults fire
deterministically on the Nth hit of their point and can

* ``raise``      — raise :class:`FaultInjected` (a ``MXNetError``),
* ``transient``  — raise :class:`TransientKVError` (retryable by the
  kvstore transport),
* ``partition``  — raise :class:`PartitionError`: a network partition.
  Distinct from ``transient``: the peer sees the *connection drop with
  no response* (the kvstore server closes the socket without replying;
  the client side looks like a vanished server), not an error payload,
* ``delay``      — sleep ``delay_ms`` (default 10 ms) and continue,
* ``crash``      — ``os._exit(137)``: a SIGKILL-grade hard crash, no
  ``atexit``, no ``finally`` blocks — exactly what preemption does.

Arming is programmatic (:func:`arm` / :func:`arming`) or via the
environment, so a *subprocess* can be killed mid-write without any
cooperation from the script under test::

    MXNET_FAULT_INJECT=point:step:kind[:count][,point:step:kind...]
    MXNET_FAULT_INJECT=ckpt.mid_write:1:crash

Registered points:

==================  ======================================================
point               fires
==================  ======================================================
ckpt.mid_write      inside an atomic checkpoint write, after content is
                    staged to the temp file but before fsync
ckpt.pre_rename     after the temp file is durable, before ``os.replace``
                    makes it visible
kv.push             entry of a kvstore push (before any mutation)
kv.pull             entry of a kvstore pull
kv.server           entry of a kvstore-server request handler
kv.server.snapshot  inside the kvstore server's state snapshot, after
                    the mutation it commits was applied in memory but
                    before the snapshot file is written (the failover
                    window a crash here exercises)
kv.client.reconnect kvstore client (re-)dial to the parameter server,
                    before the socket connect
engine.step         start of each training step in ``BaseModule.fit``
                    (hits count across epochs)
serve.worker        top of each serve-worker loop iteration
decode.step         top of each decode-scheduler iteration
                    (serve.DecodeEngine)
io.worker           top of each input-pipeline decode task (counted
                    per process: forked workers inherit the arming)
==================  ======================================================
"""
from __future__ import annotations

import os
import threading
import time

from .base import MXNetError

__all__ = ["FaultInjected", "TransientKVError", "PartitionError", "POINTS",
           "arm", "disarm", "arming", "inject", "hits", "armed", "reset"]


class FaultInjected(MXNetError):
    """An armed injection point fired with kind='raise'."""


class TransientKVError(MXNetError):
    """A retryable kvstore transport failure (injected or real). The
    kvstore retry loop treats this — alongside socket-level errors — as
    worth another attempt; anything else propagates immediately."""


class PartitionError(MXNetError, ConnectionError):
    """An injected network partition: the connection is DROPPED with no
    response, unlike ``transient`` which delivers a retryable error
    payload. Subclasses :class:`ConnectionError` so the kvstore client
    retry loop treats it exactly like a real peer disappearance; the
    kvstore server's connection loop translates it into closing the
    client's socket without replying."""


KINDS = ("raise", "transient", "partition", "delay", "crash")

# point -> short doc; inject() on an unregistered point is an error so
# the table can never silently drift from the call sites.
POINTS = {
    "ckpt.mid_write": "atomic checkpoint write: content staged, not yet "
                      "fsynced (a torn-write window)",
    "ckpt.pre_rename": "atomic checkpoint write: temp file durable, "
                       "rename not yet performed",
    "kv.push": "kvstore push entry, before any store mutation",
    "kv.pull": "kvstore pull entry",
    "kv.server": "kvstore server request handler entry",
    "kv.server.snapshot": "kvstore server state snapshot: committed "
                          "mutation applied in memory, snapshot file "
                          "not yet written",
    "kv.client.reconnect": "kvstore client (re-)dial to the parameter "
                           "server, before the socket connect",
    "engine.step": "start of a training step in BaseModule.fit "
                   "(hit count spans epochs)",
    "serve.worker": "top of each serve-worker loop iteration",
    "decode.step": "top of each decode-scheduler iteration "
                   "(serve.DecodeEngine) — before admission/prefill/"
                   "step; a crash here retires every live slot and "
                   "frees its pages",
    "io.worker": "top of each input-pipeline decode task (DataPipeline "
                 "worker process, or the staging thread when workers=0)",
    "router.forward": "serve router forward attempt, after the replica "
                      "is picked and before the connection is opened "
                      "(a raise here looks like a vanished replica: the "
                      "router ejects it and retries the next one)",
    "fleet.replica": "top of each fleet replica worker main-loop tick "
                     "(serve.fleet --worker; ~10 Hz) — env-armed crash "
                     "kinds SIGKILL a live replica mid-traffic",
    "dist.member": "top of each elastic dist_tpu_sync training step, "
                   "after the previous step's host mirror was captured "
                   "(a crash here is the chaos test's SIGKILL-at-a-"
                   "step-boundary: survivors detect the silence and "
                   "rescale without a checkpoint)",
    "dist.rescale": "elastic rescale entry on a survivor, after the "
                    "lost rank is detected and before the rescale "
                    "barrier (a crash here tests a second fault "
                    "during recovery)",
}

_lock = threading.Lock()
_armed = {}          # point -> {"step", "kind", "count", "delay_ms", "fired"}
_hits = {}           # point -> inject() calls since the point was armed
_active = False      # module-level fast path: False == nothing armed


def _set_active():
    global _active
    _active = bool(_armed)


def arm(point, step=1, kind="raise", count=1, delay_ms=10):
    """Arm ``point`` to fire on its ``step``-th hit (1-based, counted
    from arming) and the following ``count - 1`` hits."""
    if point not in POINTS:
        raise MXNetError("unknown injection point %r (known: %s)"
                         % (point, ", ".join(sorted(POINTS))))
    if kind not in KINDS:
        raise MXNetError("unknown fault kind %r (known: %s)"
                         % (kind, ", ".join(KINDS)))
    if step < 1 or count < 1:
        raise MXNetError("step and count must be >= 1")
    with _lock:
        _armed[point] = {"step": int(step), "kind": kind,
                         "count": int(count), "delay_ms": float(delay_ms),
                         "fired": 0}
        _hits[point] = 0
        _set_active()


def disarm(point=None):
    """Disarm one point, or every point when ``point`` is None."""
    with _lock:
        if point is None:
            _armed.clear()
        else:
            _armed.pop(point, None)
        _set_active()


class _Arming(object):
    def __init__(self, point, kwargs):
        self._point = point
        self._kwargs = kwargs

    def __enter__(self):
        arm(self._point, **self._kwargs)
        return self

    def __exit__(self, *exc):
        disarm(self._point)


def arming(point, **kwargs):
    """Context manager: arm on entry, disarm on exit."""
    return _Arming(point, kwargs)


def hits(point):
    """Hits recorded at ``point`` since it was (last) armed; 0 when the
    point was never armed in this process."""
    with _lock:
        return _hits.get(point, 0)


def armed():
    """Snapshot of the currently armed faults (for diagnostics)."""
    with _lock:
        return {p: dict(spec) for p, spec in _armed.items()}


def inject(point):
    """Fault call site. One module-bool check when nothing is armed."""
    if not _active:
        return
    with _lock:
        spec = _armed.get(point)
        if spec is None:
            return
        _hits[point] = _hits.get(point, 0) + 1
        hit = _hits[point]
        if hit < spec["step"] or hit >= spec["step"] + spec["count"]:
            return
        spec["fired"] += 1
        kind = spec["kind"]
        delay = spec["delay_ms"]
    try:
        from . import telemetry as _tm
        if _tm._enabled:
            _tm.counter("fault/injected_total", "Armed faults fired",
                        ("point",)).labels(point).inc()
    except Exception:
        pass
    try:
        # a sampled trace that eats an injected fault is always worth
        # keeping: flag it for the slow/error exemplar ring
        from . import tracing as _tr
        _tr.mark_error("fault injected at %r (hit %d)" % (point, hit))
    except Exception:
        pass
    try:
        # the flight recorder gets the fault BEFORE a crash kind calls
        # os._exit — the post-mortem ring names its own killer (the
        # record is fsync'd by the time record_event returns)
        from . import blackbox as _bb
        _bb.record_event("fault", point=point, kind=kind, hit=hit)
    except Exception:
        pass
    if kind == "crash":
        # SIGKILL-grade: no atexit, no finally, buffers not flushed —
        # the honest preemption simulation
        os._exit(137)
    if kind == "delay":
        time.sleep(delay / 1e3)
        return
    if kind == "transient":
        raise TransientKVError(
            "injected transient fault at %r (hit %d)" % (point, hit))
    if kind == "partition":
        raise PartitionError(
            "injected network partition at %r (hit %d)" % (point, hit))
    raise FaultInjected("injected fault at %r (hit %d)" % (point, hit))


def reset():
    """Disarm everything, clear hit counters, re-read the environment."""
    with _lock:
        _armed.clear()
        _hits.clear()
        _set_active()
    _load_env()


def _load_env():
    """Arm faults from ``MXNET_FAULT_INJECT=point:step:kind[:count],...``
    — the vehicle for killing *subprocesses* at exact points."""
    spec = os.environ.get("MXNET_FAULT_INJECT", "")
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        if len(parts) not in (3, 4):
            raise MXNetError(
                "MXNET_FAULT_INJECT entry %r is not "
                "point:step:kind[:count]" % item)
        point, step, kind = parts[0], int(parts[1]), parts[2]
        count = int(parts[3]) if len(parts) == 4 else 1
        arm(point, step=step, kind=kind, count=count)


_load_env()
