"""Crash-consistent checkpoint files.

Counterpart of the part of the JAX package's ``checkpoint.py`` that
single-device checkpoints and quantized artifacts use:

* :func:`atomic_writer`: write ``<fname>.tmp.<pid>``, fsync, rename, so a
  crash at any instant leaves the old file or the new one, never a torn
  one;
* :func:`write_manifest` / :func:`verify_checkpoint`: a
  ``<prefix>-%04d.manifest.json`` sidecar recording each file's size and
  CRC-32, the epoch/batch position and this package's random-generator
  state (``random.get_state()``), checked before a checkpoint is trusted;
* :func:`list_checkpoints` and :func:`load_latest_valid`: the newest
  checkpoint whose checksums verify, falling back across torn or corrupt
  ones (``checkpoint/corrupt_total``), as a :class:`ResumeState`.

The manifest format is the JAX package's, so each package verifies and
loads the other's checkpoints. A write is a ``ckpt.write`` span under a
sampled trace and passes the fault points ``ckpt.mid_write`` (staged,
not yet fsynced) and ``ckpt.pre_rename`` (durable, not yet renamed); a
checkpoint save leaves a ``checkpoint`` flight-recorder record. Not
ported yet: sharded checkpoints (``ShardedCheckpointManager``) and the
training and process supervisors (ROADMAP A16).
"""
from __future__ import annotations

import contextlib
import glob as _glob
import json
import logging
import os
import re
import zlib
from collections import namedtuple

from . import fault as _fault
from . import telemetry as _tm
from . import tracing as _tr
from .base import MXNetError

__all__ = ["atomic_writer", "write_manifest", "manifest_path",
           "verify_checkpoint", "load_latest_valid", "list_checkpoints",
           "ResumeState", "CheckpointCorruptError"]

MANIFEST_FORMAT = 1


class CheckpointCorruptError(MXNetError):
    """A checkpoint failed validation (torn write, bad checksum, ...).
    The message names the file and exactly what failed."""


@contextlib.contextmanager
def atomic_writer(fname, mode="wb"):
    """Write-temp -> fsync -> rename. Yields a file open on
    ``<fname>.tmp.<pid>``; on a clean exit the bytes are fsynced and
    renamed over ``fname``. On any failure the destination is untouched
    and the temp file is removed."""
    fname = os.fspath(fname)
    tmp = "%s.tmp.%d" % (fname, os.getpid())
    with _tr.child_span("ckpt.write",
                        attrs={"file": os.path.basename(fname)}):
        f = open(tmp, mode)
        try:
            yield f
            _fault.inject("ckpt.mid_write")
            f.flush()
            os.fsync(f.fileno())
            f.close()
            _fault.inject("ckpt.pre_rename")
            os.replace(tmp, fname)
            _fsync_dir(os.path.dirname(os.path.abspath(fname)))
        except BaseException:
            if not f.closed:
                f.close()
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


def _fsync_dir(path):
    """Make the rename durable against power loss; best effort (some
    filesystems refuse directory descriptors)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _crc32_file(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(buf, crc)


def manifest_path(prefix, epoch):
    return "%s-%04d.manifest.json" % (prefix, int(epoch))


def write_manifest(prefix, epoch, files, nbatch=0, rng=None, extra=None):
    """Write the sidecar of checkpoint ``epoch``: for each role
    (``params``, ``states``, ``symbol``) whose file exists, its size and
    CRC-32; ``nbatch`` > 0 marks a mid-epoch checkpoint; ``rng`` defaults
    to this package's generator state; ``extra`` keys are merged in."""
    if rng is None:
        from . import random as _random
        rng = _random.get_state()
    man = {"format": MANIFEST_FORMAT, "epoch": int(epoch),
           "nbatch": int(nbatch), "rng": rng, "files": {},
           "has_optimizer_states": bool(files.get("states"))}
    for role, path in files.items():
        if path is None or not os.path.exists(path):
            continue
        man["files"][role] = {"name": os.path.basename(path),
                              "size": os.path.getsize(path),
                              "crc32": _crc32_file(path)}
    if extra:
        man.update(extra)
    path = manifest_path(prefix, epoch)
    with atomic_writer(path, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def verify_checkpoint(prefix, epoch):
    """Check checkpoint ``epoch`` against its manifest; returns the
    manifest. Raises :class:`CheckpointCorruptError` naming the file and
    what failed (missing, length, checksum, unreadable manifest)."""
    mpath = manifest_path(prefix, epoch)
    if not os.path.exists(mpath):
        raise CheckpointCorruptError("no manifest %r" % mpath)
    try:
        with open(mpath) as f:
            man = json.load(f)
    except (ValueError, OSError) as e:
        raise CheckpointCorruptError(
            "manifest %r is unreadable or torn (%s)" % (mpath, e)) from e
    base_dir = os.path.dirname(os.path.abspath(mpath))
    for role, ent in man.get("files", {}).items():
        path = os.path.join(base_dir, ent["name"])
        if not os.path.exists(path):
            raise CheckpointCorruptError(
                "checkpoint %s file %r is missing" % (role, path))
        size = os.path.getsize(path)
        if size != ent["size"]:
            raise CheckpointCorruptError(
                "checkpoint %s file %r is truncated: %d bytes, manifest "
                "says %d" % (role, path, size, ent["size"]))
        crc = _crc32_file(path)
        if crc != ent["crc32"]:
            raise CheckpointCorruptError(
                "checkpoint %s file %r fails its checksum (crc32 %08x, "
                "manifest says %08x)" % (role, path, crc, ent["crc32"]))
    return man


_EPOCH_RE = re.compile(r"-(\d{4,})\.(?:params|manifest\.json)$")


def list_checkpoints(prefix):
    """Sorted epochs that have a params file or a manifest under
    ``prefix`` (no validation)."""
    epochs = set()
    # escaped: a directory like "run[1]" is a path, not a glob class
    for path in _glob.glob(_glob.escape(prefix) + "-*"):
        m = _EPOCH_RE.search(path)
        if m:
            epochs.add(int(m.group(1)))
    return sorted(epochs)


ResumeState = namedtuple(
    "ResumeState",
    ["epoch", "nbatch", "symbol", "arg_params", "aux_params",
     "states_fname", "rng", "prefix", "io_cursor"])
ResumeState.__new__.__defaults__ = (None,)


def split_params(save_dict):
    """(arg_params, aux_params) of a checkpoint's ``arg:``/``aux:`` keyed
    dict."""
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_latest_valid(prefix, ctx=None):
    """The newest valid checkpoint under ``prefix`` as a
    :class:`ResumeState` (``symbol`` None when no symbol file was
    written), or None when there is none at all. Each candidate, newest
    first, must pass its manifest's checksums (a manifest-less one only
    its parse) and load; torn or corrupt ones are skipped with a warning
    and counted. Raises :class:`CheckpointCorruptError` when every
    checkpoint is damaged."""
    from .ndarray.utils import load as nd_load
    epochs = list_checkpoints(prefix)
    if not epochs:
        return None
    errors = []
    fell_back = False
    for epoch in reversed(epochs):
        try:
            man = None
            if os.path.exists(manifest_path(prefix, epoch)):
                man = verify_checkpoint(prefix, epoch)
            save_dict = nd_load("%s-%04d.params" % (prefix, epoch), ctx=ctx)
            arg_params, aux_params = split_params(save_dict)
            symbol = None
            sym_file = "%s-symbol.json" % prefix
            if os.path.exists(sym_file):
                from .symbol import load as sym_load
                symbol = sym_load(sym_file)
            states = "%s-%04d.states" % (prefix, epoch)
            has_states = os.path.exists(states) and (
                man is None or man.get("has_optimizer_states", True))
            _tm.counter("checkpoint/restores_total",
                        "Checkpoints restored").inc()
            if fell_back:
                _tm.counter("checkpoint/fallbacks_total",
                            "Restores that skipped a corrupt newer "
                            "checkpoint").inc()
            return ResumeState(
                epoch=int(epoch),
                nbatch=int(man.get("nbatch", 0)) if man else 0,
                symbol=symbol, arg_params=arg_params,
                aux_params=aux_params,
                states_fname=states if has_states else None,
                rng=man.get("rng") if man else None, prefix=prefix,
                io_cursor=man.get("io_cursor") if man else None)
        except (MXNetError, OSError, ValueError) as e:
            fell_back = True
            errors.append("epoch %d: %s" % (epoch, e))
            logging.warning("skipping corrupt checkpoint %s-%04d: %s",
                            prefix, epoch, e)
            _tm.counter("checkpoint/corrupt_total",
                        "Checkpoints skipped as torn/corrupt").inc()
    raise CheckpointCorruptError(
        "every checkpoint under %r is torn or corrupt:\n  %s"
        % (prefix, "\n  ".join(errors)))
