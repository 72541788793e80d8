"""NDArray save/load (reference: python/mxnet/ndarray/utils.py:149,222).

The JAX package's two file layouts, so that what one package writes the
other loads:

* the default: a zip of NPY members (``%05d:<key>``) with a ``__meta__``
  member (magic, keyed, count) and, for types NPY has no descriptor for
  (bfloat16), raw bytes plus a ``__dtypes__`` JSON sidecar naming the
  type and shape of each such member;
* ``format="mxnet"``: the reference's binary ``.params`` list
  (``mxnet_format.py``), detected on load by its magic.

Both writers go through ``checkpoint.atomic_writer``, so a crash mid-save
leaves the previous file or the new one, never a torn one; a torn or
corrupt file raises :class:`MXNetError` naming the file and what failed.
"""
from __future__ import annotations

import io
import json
import os
import zipfile

import numpy as np
import torch

from ..base import MXNetError
from .ndarray import NDArray, array

__all__ = ["save", "load", "save_bytes", "load_bytes"]

_MAGIC = "mxtpu-ndarray-v1"
# types without an NPY descriptor, stored as raw bytes + __dtypes__
_RAW_TYPES = {torch.bfloat16: "bfloat16"}
_RAW_NAMES = {v: k for k, v in _RAW_TYPES.items()}


def _items(data):
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        items, keyed = list(data.items()), True
    elif isinstance(data, (list, tuple)):
        items, keyed = [(str(i), v) for i, v in enumerate(data)], False
    else:
        raise MXNetError("save requires NDArray, list or dict")
    for _, v in items:
        if not isinstance(v, NDArray):
            raise MXNetError("save requires NDArray values")
    return items, keyed


def _zip_bytes(items, keyed):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("__meta__", "%s\nkeyed=%d\ncount=%d"
                    % (_MAGIC, int(keyed), len(items)))
        extended = {}
        for i, (k, v) in enumerate(items):
            member = "%05d:%s" % (i, k)
            t = v._data.detach().cpu().contiguous()
            if t.dtype in _RAW_TYPES:
                extended[member] = [_RAW_TYPES[t.dtype], list(t.shape)]
                a = t.reshape(-1).view(torch.uint8).numpy()
            else:
                a = t.numpy()
            npy = io.BytesIO()
            np.save(npy, a, allow_pickle=False)
            zf.writestr(member, npy.getvalue())
        if extended:
            zf.writestr("__dtypes__", json.dumps(extended))
    return buf.getvalue()


def save_bytes(data, format="mxtpu"):
    """The bytes :func:`save` writes, without a file."""
    items, keyed = _items(data)
    if format == "mxnet":
        from . import mxnet_format
        return mxnet_format.dumps(items, keyed)
    if format != "mxtpu":
        raise MXNetError("unknown save format %r (use 'mxtpu' or "
                         "'mxnet')" % (format,))
    return _zip_bytes(items, keyed)


def save(fname, data, format="mxtpu"):
    """Save an NDArray, a list or a str -> NDArray dict to ``fname``
    (reference: utils.py:149); ``format="mxnet"`` writes the reference's
    binary ``.params`` layout."""
    blob = save_bytes(data, format)
    from ..checkpoint import atomic_writer
    with atomic_writer(fname) as f:
        f.write(blob)


def _from_raw(arr, dtname, shape):
    dtype = _RAW_NAMES.get(dtname)
    if dtype is None:
        raise MXNetError("array type %r has no counterpart in "
                         "mxnet_tpu_torch (bfloat16 only)" % (dtname,))
    raw = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint8).copy())
    return raw.view(dtype).reshape(shape)


def load_bytes(blob, ctx=None, name="<bytes>"):
    """Load what :func:`save` (this package's or the JAX package's) or
    the reference framework wrote, from bytes; ``name`` labels errors."""
    from . import mxnet_format
    if mxnet_format.is_mxnet_params(blob[:8]):
        try:
            keys, arrays = mxnet_format.loads(blob, ctx=ctx)
        except MXNetError as e:
            raise MXNetError(
                "checkpoint %r is corrupt or truncated (mxnet binary "
                "layout: %s); it was likely torn by a crash mid-write — "
                "fall back to an older checkpoint (see "
                "checkpoint.load_latest_valid)" % (name, e)) from e
        return dict(zip(keys, arrays)) if keys else arrays
    try:
        with zipfile.ZipFile(io.BytesIO(blob), "r") as zf:
            meta = zf.read("__meta__").decode().splitlines()
            if meta[0] != _MAGIC:
                raise MXNetError("%r is not an NDArray file: magic %r != %r"
                                 % (name, meta[0][:32], _MAGIC))
            keyed = bool(int(meta[1].split("=")[1]))
            count = int(meta[2].split("=")[1])
            names = [n for n in zf.namelist()
                     if n not in ("__meta__", "__dtypes__")]
            if len(names) != count:
                raise MXNetError("checkpoint %r is truncated: holds %d of %d "
                                 "arrays" % (name, len(names), count))
            extended = {}
            if "__dtypes__" in zf.namelist():
                extended = json.loads(zf.read("__dtypes__").decode())
            out_items = []
            for n in sorted(names):
                _idx, key = n.split(":", 1)
                # zf.read verifies the member's stored CRC-32
                arr = np.load(io.BytesIO(zf.read(n)), allow_pickle=False)
                if n in extended:
                    t = _from_raw(arr, *extended[n])
                    out_items.append((key, NDArray(t.to(
                        torch.device("cpu") if ctx is None else ctx))))
                else:
                    out_items.append((key, array(arr, ctx=ctx or "cpu",
                                                 dtype=arr.dtype)))
    except MXNetError:
        raise
    except (zipfile.BadZipFile, KeyError, IndexError, ValueError,
            EOFError, OSError) as e:
        raise MXNetError(
            "checkpoint %r is corrupt or truncated (%s: %s); it was likely "
            "torn by a crash mid-write — fall back to an older checkpoint "
            "(see checkpoint.load_latest_valid)"
            % (name, type(e).__name__, e)) from e
    if keyed:
        return dict(out_items)
    return [v for _, v in out_items]


def load(fname, ctx=None):
    """Load NDArrays saved by :func:`save`, by the JAX package's
    ``nd.save`` (either layout) or by the reference framework
    (reference: utils.py:222). Arrays land on the host unless ``ctx``
    names a device."""
    if not os.path.exists(fname):
        raise MXNetError("no such file %r" % fname)
    with open(fname, "rb") as f:
        blob = f.read()
    return load_bytes(blob, ctx=ctx, name=fname)
