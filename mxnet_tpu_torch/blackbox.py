"""Crash-safe flight recorder: a bounded on-disk append ring of
structured lifecycle events.

Counterpart of the JAX package's ``blackbox.py``: the same frame format,
segment rotation and event table, so each package reads the other's
file.

When a training or serving process dies — the exact scenario the
fault-tolerance stack hardens against — the
in-memory telemetry registry and trace rings die with it. This module
is the black box that survives: every *lifecycle-grade* event (XLA
compiles, model hot-swaps, kvstore failovers and rejoins, checkpoint
saves, injected faults, SLO alert transitions, numerics-sentinel trips)
is appended to an on-disk ring as a CRC-framed, individually-fsync'd
record, so a post-mortem after a SIGKILL reads the last thing the
process did from the file the kernel already had.

Enable with ``MXNET_FLIGHT_RECORDER=/path/to/flight.bin`` (or
:func:`configure` at runtime). Disabled, a call site pays one
module-bool check (the fault.py pattern). Read post-mortem with::

    python -m mxnet_tpu_torch.blackbox /path/to/flight.bin

Design:

* **frame format**: ``b"FR" + uint32 payload_len + uint32 crc32 +
  payload`` (little-endian), payload = one JSON object with ``t``
  (wall time), ``pid``, ``event``, and the event's fields. Every frame
  is flushed and ``fsync``'d before :func:`record_event` returns — a
  record that was handed to the recorder is on disk, period (the same
  commit-before-ack discipline the kvstore snapshot uses).
* **bounded ring**: two segments. When the active file exceeds half of
  ``MXNET_FLIGHT_RECORDER_MB``, it rotates to ``<path>.1`` (clobbering
  the previous old segment) and a fresh active file starts — total
  footprint is bounded, the newest events always survive.
* **torn-tail tolerance**: a crash can land mid-frame. The reader
  stops a segment at the first bad magic/length/CRC and reports how
  many bytes it abandoned — every frame before the tear is intact
  (frames are appended strictly in order and fsync'd one at a time).

Event names are REGISTERED (:data:`EVENTS`) exactly like
``fault.POINTS``: recording an unknown event raises, so the table
cannot silently drift from the call sites.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib

from .base import MXNetError

__all__ = ["EVENTS", "enabled", "configure", "record_event", "read_events",
           "tail", "merge_rings", "records_written", "path", "reset"]

_MAGIC = b"FR"
_HEADER = struct.Struct("<4sII")     # magic (padded to 4) + len + crc


# event name -> what it marks; record_event() on an unregistered name
# raises so the docs table cannot drift from the call sites.
EVENTS = {
    "start": "first record of a recorder session: pid, argv, platform",
    # the JAX package's text (one table for both packages); the port
    # writes no compile record until its program registry (ROADMAP A6)
    "compile": "one XLA backend compile (the jax.monitoring feed - "
               "seconds; slow startups and mid-traffic recompiles both "
               "leave a trail)",
    "swap": "a ModelRegistry weight hot-swap completed (quantized flag, "
            "drain outcome)",
    "failover": "a kvstore client observed the parameter server's "
                "incarnation id change (it rode a server restart)",
    "rejoin": "the kvstore server re-admitted a rank that had been "
              "declared dead (membership epoch bump)",
    "checkpoint": "one crash-consistent checkpoint save committed "
                  "(file, seconds)",
    "fault": "an armed fault-injection point fired (point, kind, hit) - "
             "written BEFORE a crash-kind fault calls os._exit, so the "
             "post-mortem names its own killer",
    "alert": "an SLO rule transitioned (rule, state ok<->firing, value)",
    "numerics_trip": "a numerics sentinel tripped (kind, step report, "
                     "worst param in full mode)",
    "forensics": "a forensics diff flagged a fusion regression between "
                 "two captures of the same program (split fusion, new "
                 "copy, boundary-bytes growth; a/b fingerprints + the "
                 "regression list)",
    "scale_up": "the fleet autoscaler spawned a replica (reason: SLO "
                "burn / queue growth / re-convergence to target; the "
                "replica name and live count ride along)",
    "scale_down": "the fleet autoscaler retired a replica on sustained "
                  "slack (drained via the router before SIGTERM)",
    "replica_death": "a fleet replica exited without being retired "
                     "(rc, preempt-vs-failure triage verdict, respawn "
                     "decision) — read together with the dead replica's "
                     "own ring, whose last fault record names the "
                     "killer",
    "member_lost": "an elastic dist_tpu_sync survivor declared a rank "
                   "lost (rank, detection source: collective-error / "
                   "stale-heartbeat / step-watchdog, seconds since its "
                   "last heartbeat) — fsync'd before the rescale "
                   "starts, so a crash mid-rescale still names the "
                   "trigger",
    "rescale": "an elastic rescale committed: old world -> new world, "
               "member epoch, agreed resume step, grad-accum factor, "
               "and whether the mesh shrank or grew (a rejoin)",
}

_lock = threading.Lock()
_path = None                 # active segment path; None == disabled
_enabled = False             # module-bool fast path
_fd = None                   # open active-segment file object
_seg_limit = 2 * 1024 * 1024
_written = 0                 # records written by THIS process


def _config(name, fallback):
    try:
        from .config import get
        v = get(name)
        return fallback if v is None else v
    except Exception:
        return fallback


def enabled():
    return _enabled


def path():
    """Active segment path, or None when the recorder is disabled."""
    return _path


def records_written():
    """Records this process handed to the recorder (telemetry
    snapshot's ``flight_records`` field)."""
    return _written


def configure(target, limit_mb=None):
    """Point the recorder at ``target`` (None disables). Returns the
    previous path. The env equivalent is ``MXNET_FLIGHT_RECORDER``."""
    global _path, _enabled, _fd, _seg_limit
    with _lock:
        prev = _path
        if _fd is not None:
            try:
                _fd.close()
            except OSError:
                pass
            _fd = None
        _path = os.fspath(target) if target else None
        _enabled = _path is not None
        if limit_mb is not None:
            _seg_limit = max(4096, int(float(limit_mb) * 1e6 / 2))
    if _enabled:
        record_event("start", pid=os.getpid(),
                     argv=" ".join(os.sys.argv[:3]))
    return prev


def reset():
    """Disable and forget the written-record counter (test isolation)."""
    global _written
    configure(None)
    _written = 0


def _open_locked():
    global _fd
    if _fd is None:
        d = os.path.dirname(os.path.abspath(_path))
        if d and not os.path.isdir(d):
            os.makedirs(d, exist_ok=True)
        _fd = open(_path, "ab")
    return _fd


def _rotate_locked():
    """Active segment -> <path>.1 (clobbering the older one); a fresh
    active file starts. Bounded: at most two segments ever exist."""
    global _fd
    if _fd is not None:
        try:
            _fd.close()
        except OSError:
            pass
        _fd = None
    try:
        os.replace(_path, _path + ".1")
    except OSError:
        pass


def record_event(event, **fields):
    """Append one event frame; fsync'd before returning. One
    module-bool check when the recorder is disabled. Never raises on
    I/O failure (a full disk must not take down training) — but an
    UNREGISTERED event name always raises: that is a programming
    error, not an operational one."""
    if event not in EVENTS:
        raise MXNetError("unknown flight-recorder event %r (known: %s)"
                         % (event, ", ".join(sorted(EVENTS))))
    if not _enabled:
        return False
    global _written
    rec = {"t": round(time.time(), 6), "pid": os.getpid(), "event": event}
    rec.update(fields)
    try:
        payload = json.dumps(rec, default=str).encode("utf-8")
    except (TypeError, ValueError):
        payload = json.dumps({"t": rec["t"], "pid": rec["pid"],
                              "event": event,
                              "error": "unserializable fields"}).encode()
    frame = _HEADER.pack(_MAGIC + b"\x00\x00", len(payload),
                         zlib.crc32(payload) & 0xFFFFFFFF) + payload
    with _lock:
        if not _enabled:
            return False
        try:
            f = _open_locked()
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
            _written += 1
            if f.tell() >= _seg_limit:
                _rotate_locked()
        except OSError:
            return False
    return True


# ---------------------------------------------------------------------------
# reader (post-mortem: runs in a DIFFERENT process than the writer)
# ---------------------------------------------------------------------------

def _read_segment(seg_path):
    """(events, torn_bytes) of one segment file. Stops at the first
    bad magic / short frame / CRC mismatch — everything before a torn
    tail is intact because frames are appended in order and fsync'd
    individually."""
    events = []
    try:
        with open(seg_path, "rb") as f:
            blob = f.read()
    except OSError:
        return events, 0
    off = 0
    while off + _HEADER.size <= len(blob):
        magic, length, crc = _HEADER.unpack_from(blob, off)
        if magic[:2] != _MAGIC:
            break
        start = off + _HEADER.size
        end = start + length
        if end > len(blob):
            break                        # torn mid-payload
        payload = blob[start:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break                        # torn / corrupt frame
        try:
            events.append(json.loads(payload.decode("utf-8")))
        except (ValueError, UnicodeDecodeError):
            break
        off = end
    return events, len(blob) - off


def read_events(target=None):
    """Every readable event, oldest first, across the rotated segment
    (``<path>.1``) then the active one. Returns ``(events,
    torn_bytes)`` — ``torn_bytes`` > 0 means a tail was abandoned (the
    expected signature of a SIGKILL mid-frame; every earlier record is
    still trustworthy)."""
    target = os.fspath(target) if target else _path
    if not target:
        raise MXNetError("no flight-recorder path (set "
                         "MXNET_FLIGHT_RECORDER or pass one)")
    events, torn = [], 0
    for seg in (target + ".1", target):
        ev, t = _read_segment(seg)
        events.extend(ev)
        torn += t
    return events, torn


def tail(n=20, target=None):
    """The newest ``n`` readable events (diagnostics() embeds these)."""
    try:
        events, _torn = read_events(target)
    except MXNetError:
        return []
    return events[-n:]


def merge_rings(paths):
    """Merge N processes' flight rings into ONE ordered incident
    timeline (the cluster observatory's post-mortem view: a victim's
    ``fault`` record, the survivor's ``member_lost`` and ``rescale``
    records, and a replica's ``replica_death`` interleave in causal
    order). Every record carries a wall-clock ``t`` stamped at write
    time, which is the merge key; records with equal ``t`` keep their
    per-ring append order. Each merged event gains a ``ring`` field
    (the source path); a ring's torn tail (SIGKILL mid-frame) is
    reported per ring under ``abandoned`` — the events before the tear
    are all present, none duplicated, none lost.

    Returns ``{"events": [...], "abandoned": {path: torn_bytes},
    "rings": [...], "count": N}``."""
    rows = []
    abandoned = {}
    rings = []
    for ridx, path in enumerate(paths):
        path = os.fspath(path)
        rings.append(path)
        try:
            events, torn = read_events(path)
        except MXNetError:
            events, torn = [], 0
        abandoned[path] = torn
        for i, ev in enumerate(events):
            e = dict(ev)
            e["ring"] = path
            rows.append((float(e.get("t", 0.0)), ridx, i, e))
    rows.sort(key=lambda r: (r[0], r[1], r[2]))
    return {"events": [r[3] for r in rows], "abandoned": abandoned,
            "rings": rings, "count": len(rows)}


# ---------------------------------------------------------------------------
# CLI: python -m mxnet_tpu_torch.blackbox <path>
# ---------------------------------------------------------------------------

_env_path = _config("MXNET_FLIGHT_RECORDER", "")
if _env_path:
    configure(_env_path, _config("MXNET_FLIGHT_RECORDER_MB", 4.0))


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.blackbox",
        description="Read a flight-recorder ring post-mortem.")
    ap.add_argument("path", help="recorder path (MXNET_FLIGHT_RECORDER)")
    ap.add_argument("--json", action="store_true",
                    help="one raw JSON object per line")
    ap.add_argument("--limit", type=int, default=0,
                    help="only the newest N events")
    args = ap.parse_args(argv)
    events, torn = read_events(args.path)
    if args.limit:
        events = events[-args.limit:]
    if args.json:
        for e in events:
            print(json.dumps(e, sort_keys=True))
    else:
        for e in events:
            ts = time.strftime("%Y-%m-%dT%H:%M:%S",
                               time.localtime(e.get("t", 0)))
            extra = " ".join("%s=%s" % (k, v) for k, v in sorted(e.items())
                             if k not in ("t", "pid", "event"))
            print("%s pid=%s %-14s %s" % (ts, e.get("pid", "?"),
                                          e.get("event", "?"), extra))
    print("-- %d event(s)%s" % (
        len(events),
        ", torn tail: %d byte(s) abandoned" % torn if torn else
        ", no torn tail"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
