"""Reference-binary NDArray file codec (reference:
src/ndarray/ndarray.cc:1565-1800, the ``.params`` format every published
MXNet checkpoint uses); the JAX package's ``ndarray/mxnet_format.py``
for dense arrays.

Layout (little-endian, dmlc::Stream serialization):
  uint64 0x112 (kMXAPINDArrayListMagic), uint64 reserved
  uint64 n; n x NDArray       (vector<NDArray>)
  uint64 k; k x (uint64 len, bytes)   (vector<string> names)

NDArray v2 (uint32 magic 0xF993fac9):
  int32 stype; [storage_shape Tuple if sparse]; shape Tuple;
  int32 dev_type, int32 dev_id; int32 type_flag;
  [per aux: int32 aux_type, Tuple aux_shape]; raw data; [raw aux data]

Tuple = uint32 ndim + ndim dims; the dim width is uint32 through MXNet
~1.4 and int64 from 1.5, and both are read: each file is parsed with one
width and, if that fails, with the other. Sparse (row_sparse, csr)
records raise: sparse arrays are not ported yet (ROADMAP A15).
"""
from __future__ import annotations

import struct

import numpy as np

from ..base import MXNetError

__all__ = ["LIST_MAGIC", "is_mxnet_params", "loads", "dumps"]

LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9

# mshadow type flags (mshadow/base.h)
_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
           4: np.int32, 5: np.int8, 6: np.int64}
_FLAGS = {np.dtype(v): k for k, v in _DTYPES.items()}


class _Cursor(object):
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, n):
        if self.pos + n > len(self.buf):
            raise MXNetError("truncated NDArray file")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]


def _read_tuple(cur, dim64):
    ndim = cur.u32()
    if ndim > 32:
        raise MXNetError("implausible ndim %d" % ndim)
    fmt = "<%d%s" % (ndim, "q" if dim64 else "I")
    dims = struct.unpack(fmt, cur.read((8 if dim64 else 4) * ndim))
    if any(d < 0 or d > 2 ** 40 for d in dims):
        raise MXNetError("implausible dims %s" % (dims,))
    return tuple(int(d) for d in dims)


def _read_array(cur, dim64):
    """One record: a numpy array, or None for a none-entry."""
    magic = cur.u32()
    if magic == _V2_MAGIC:
        stype = cur.i32()
        if stype in (1, 2):
            raise MXNetError("sparse NDArray records (storage type %d) are "
                             "not ported to mxnet_tpu_torch yet (ROADMAP "
                             "A15)" % stype)
        if stype != 0:
            raise MXNetError("bad storage type %d" % stype)
        shape = _read_tuple(cur, dim64)
    elif magic == _V1_MAGIC:
        shape = _read_tuple(cur, dim64)
    else:
        # oldest legacy: the "magic" IS ndim, dims always uint32
        ndim = magic
        if ndim > 32:
            raise MXNetError("bad magic 0x%x" % magic)
        shape = struct.unpack("<%dI" % ndim, cur.read(4 * ndim))
    if len(shape) == 0:
        return None
    dev_type = cur.i32()
    dev_id = cur.i32()
    if not (1 <= dev_type <= 6 and 0 <= dev_id <= 255):
        raise MXNetError("implausible context (%d,%d)" % (dev_type, dev_id))
    type_flag = cur.i32()
    if type_flag not in _DTYPES:
        raise MXNetError("unknown type flag %d" % type_flag)
    dtype = np.dtype(_DTYPES[type_flag])
    n = int(np.prod(shape))
    # a writable copy: torch keeps no view of the file's bytes
    return np.frombuffer(cur.read(n * dtype.itemsize),
                         dtype=dtype).reshape(shape).copy()


def is_mxnet_params(head):
    """First 8+ bytes -> is this the reference binary list format?"""
    return len(head) >= 8 and struct.unpack("<Q", head[:8])[0] == LIST_MAGIC


def _parse_all(buf, dim64, ctx):
    from .ndarray import array
    cur = _Cursor(buf)
    if cur.u64() != LIST_MAGIC:
        raise MXNetError("not an MXNet NDArray list file")
    cur.u64()                                        # reserved
    n = cur.u64()
    if n > 10 ** 7:
        raise MXNetError("implausible array count %d" % n)
    arrays = []
    for _ in range(n):
        data = _read_array(cur, dim64)
        arrays.append(None if data is None
                      else array(data, ctx=ctx or "cpu", dtype=data.dtype))
    k = cur.u64()
    if k not in (0, n):
        raise MXNetError("key count %d != array count %d" % (k, n))
    keys = []
    for _ in range(k):
        ln = cur.u64()
        if ln > 4096:
            raise MXNetError("implausible key length %d" % ln)
        keys.append(cur.read(ln).decode())
    if cur.pos != len(buf):
        raise MXNetError("trailing bytes (%d) after parse"
                         % (len(buf) - cur.pos))
    return keys, arrays


def loads(buf, ctx=None):
    """Decode a reference ``.params`` blob -> (keys, NDArray list)."""
    try:
        return _parse_all(buf, False, ctx)
    except MXNetError as first:
        try:
            return _parse_all(buf, True, ctx)
        except MXNetError:
            # a corrupt file fails both widths; the uint32 pass usually
            # gets further, so its error is the informative one
            raise first


def _tuple_bytes(shape):
    return struct.pack("<I%dI" % len(shape), len(shape), *shape)


def dumps(items, keyed):
    """Encode (name, NDArray) pairs as a reference-compatible blob (v2
    records, uint32 dims: the 1.x layout)."""
    out = [struct.pack("<QQ", LIST_MAGIC, 0), struct.pack("<Q", len(items))]
    for name, v in items:
        if v.dtype == "bfloat16":
            raise MXNetError("cannot write %r: bfloat16 has no mshadow type "
                             "flag in the reference format; cast explicitly "
                             "(e.g. float32)" % name)
        if v.ndim == 0:
            raise MXNetError(
                "cannot write %r: the reference format has no 0-dim arrays "
                "(ndim=0 marks a none-entry); reshape to (1,)" % name)
        a = np.ascontiguousarray(v.asnumpy())
        if a.dtype not in _FLAGS:
            raise MXNetError("cannot write %r: dtype %s has no mshadow type "
                             "flag in the reference format; cast explicitly "
                             "(e.g. float32)" % (name, a.dtype))
        out.append(struct.pack("<Ii", _V2_MAGIC, 0))
        out.append(_tuple_bytes(a.shape))
        out.append(struct.pack("<ii", 1, 0))          # cpu(0)
        out.append(struct.pack("<i", _FLAGS[a.dtype]))
        out.append(a.tobytes())
    if keyed:
        out.append(struct.pack("<Q", len(items)))
        for name, _v in items:
            b = name.encode()
            out.append(struct.pack("<Q", len(b)) + b)
    else:
        out.append(struct.pack("<Q", 0))
    return b"".join(out)
