"""RecordIO: the binary record format of ImageNet-style datasets.

Counterpart of the JAX package's ``recordio.py`` (reference:
python/mxnet/recordio.py): ``MXRecordIO``, ``MXIndexedRecordIO``,
``IRHeader``, ``pack`` / ``unpack`` and ``pack_img`` / ``unpack_img``.
The bytes are the reference's (magic 0xced7230a, ``cflag << 29 | len``
headers, 4-byte alignment; multi-chunk records read back joined), so
``.rec`` and ``.idx`` files written by either package read in the other,
and the same records give the same bytes.

Reads and writes go through the native reader (``native/recordio.cc``,
built at first use by :mod:`._native`); there is no other route. Images
encode and decode with OpenCV's Python module (``cv2``), as in the
reference.
"""
from __future__ import annotations

import ctypes
import numbers
import struct
from collections import namedtuple

import numpy as np

from . import _native
from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]


class MXRecordIO(object):
    """Sequential record reader / writer (reference: recordio.py
    MXRecordIO). ``flag`` is ``"r"`` or ``"w"``."""

    def __init__(self, uri, flag):
        self.uri = str(uri)
        self.flag = flag
        self._handle = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag not in ("r", "w"):
            raise ValueError("Invalid flag %s" % self.flag)
        self.writable = self.flag == "w"
        self._lib = _native.recordio_lib()
        self._handle = self._lib.rio_open(self.uri.encode(),
                                          1 if self.writable else 0)
        if not self._handle:
            raise IOError("cannot open %s" % self.uri)
        self.is_open = True

    def close(self):
        if not self.is_open:
            return
        self._lib.rio_close(self._handle)
        self._handle = None
        self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        try:
            self.close()
        except Exception:
            # interpreter shutdown may have torn down module globals;
            # nothing is left to release
            pass

    def __getstate__(self):
        """Pickle without the native handle (DataLoader workers reopen
        the file; reference: recordio.py __getstate__)."""
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("_lib", None)
        d.pop("_handle", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._handle = None
        is_open = d["is_open"]
        self.is_open = False
        if is_open:
            self.open()

    def _check(self, writing):
        if not self.is_open:
            raise MXNetError("%s is closed" % self.uri)
        if writing != self.writable:
            raise MXNetError("%s is open for %s" % (
                self.uri, "writing" if self.writable else "reading"))

    def write(self, buf):
        """Append one record."""
        self._write_with_offset(buf)

    def _write_with_offset(self, buf):
        self._check(True)
        buf = bytes(buf)
        off = self._lib.rio_write(self._handle, buf, len(buf))
        if off < 0:
            raise IOError("write failed on %s" % self.uri)
        return off

    def read(self):
        """The next record's bytes, or None at the end of the file."""
        self._check(False)
        buf = ctypes.c_void_p()
        n = ctypes.c_uint64()
        r = self._lib.rio_read(self._handle, ctypes.byref(buf),
                               ctypes.byref(n))
        if r == 0:
            return None
        if r < 0:
            raise IOError("corrupt recordio file %s" % self.uri)
        try:
            return ctypes.string_at(buf.value, n.value) if n.value else b""
        finally:
            self._lib.rio_free(buf)

    def seek(self, offset):
        self._check(False)
        if self._lib.rio_seek(self._handle, int(offset)) != 1:
            raise IOError("cannot seek %s to %d" % (self.uri, offset))

    def tell(self):
        if not self.is_open:
            raise MXNetError("%s is closed" % self.uri)
        return self._lib.rio_tell(self._handle)


class MXIndexedRecordIO(MXRecordIO):
    """Keyed record reader / writer with a ``key\\toffset`` sidecar
    ``.idx`` file (reference: recordio.py MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = str(idx_path)
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        self.fidx = open(self.idx_path, "w" if self.writable else "r")
        if not self.writable:
            for line in self.fidx:
                parts = line.strip().split("\t")
                if len(parts) != 2:
                    continue
                key = self.key_type(parts[0])
                self.idx[key] = int(parts[1])
                self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        super().close()
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None

    def __getstate__(self):
        d = super().__getstate__()
        d.pop("fidx")
        return d

    def __setstate__(self, d):
        self.fidx = None
        super().__setstate__(d)

    def shard_keys(self, num_parts, part_index):
        """The keys of shard ``part_index`` of ``num_parts``
        (``io.shard_bounds``: disjoint, exhaustive, sizes within one)."""
        from .io import shard_bounds
        lo, hi = shard_bounds(len(self.keys), num_parts, part_index)
        return self.keys[lo:hi]

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        offset = self._write_with_offset(buf)
        self.fidx.write("%s\t%d\n" % (str(key), offset))
        self.idx[key] = offset
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """A header and payload bytes as one record (reference: recordio.py
    pack): a numeric label is stored in the header (flag 0); a label
    array of n floats sets flag n and precedes the payload."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
        payload_label = b""
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        payload_label = label.tobytes()
    return struct.pack(_IR_FORMAT, header.flag, float(header.label),
                       header.id, header.id2) + payload_label + bytes(s)


def unpack(s):
    """(IRHeader, payload bytes) of a record (reference: recordio.py
    unpack); a label array comes back as float32 numpy."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=1):
    """(IRHeader, decoded HWC RGB uint8 host NDArray) of a record
    (reference: recordio.py unpack_img)."""
    header, s = unpack(s)
    from . import image
    return header, image.imdecode(s, iscolor)


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC RGB image (numpy or NDArray) and pack it (reference:
    recordio.py pack_img, OpenCV's encoder with its default JPEG chroma
    subsampling)."""
    import cv2
    from .ndarray.ndarray import NDArray
    if isinstance(img, NDArray):
        img = img.asnumpy()
    img = np.asarray(img)
    if img_fmt.lower() in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt.lower() == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    else:
        encode_params = None
    ret, buf = cv2.imencode(img_fmt, img[..., ::-1] if img.ndim == 3
                            else img, encode_params)
    if not ret:
        raise MXNetError("failed to encode image")
    return pack(header, buf.tobytes())
