"""The nvJPEG backend of ``image.ImageIter``'s "native" route, and its
kernel, written by hand in CUDA for Hopper.

    crop_mirror_normalize(src, items, out_shape, mean, std, out=None)

reads each decoded image from ``src``, its JPEG component planes (Y,
then Cb and Cr at their subsampled size) one image after another, and
writes float32 NCHW ``(v - mean[c]) / std[c]`` of the (out_h, out_w)
crop at (x0, y0), mirrored where the image's plan says so. The RGB value
``v`` is libjpeg-turbo's for those planes: its "fancy" chroma upsampling
(4:2:0 and 4:2:2; 4:4:4 and grayscale need none) and its integer
YCbCr-to-RGB tables, which is what OpenCV's decoder, and with it the
JAX package's host decoder (``src/native/imagedec.cc``), computes after
the inverse DCT. ``items`` holds one int64 row an image: ``(byte
offset, height, width, x0, y0, mirror, kind, chroma height, chroma
width)``, ``kind`` one of :data:`KINDS`. One launch a batch
(``csrc/image_decode.cu``); each subtraction and division is correctly
rounded, so the kernel equals the plain version,
:func:`_crop_mirror_normalize_plain`, bitwise.

:class:`NvJpegPool` decodes JPEG buffers on the card to those planes
with the CUDA toolkit's nvJPEG library, on a pool of host threads.
nvJPEG's planes differ from libjpeg-turbo's by the rounding of its
inverse DCT alone. A wrapper launches the kernel for CUDA tensors, on
``torch.cuda.current_stream()``; it takes the plain version only
because the tensors it was given lie on the CPU. Every launch adds one
to :data:`LAUNCHES`. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading

import numpy as np
import torch

from ...base import MXNetError
from . import _build

__all__ = ["crop_mirror_normalize", "NvJpegPool", "nvjpeg_available",
           "plane_layout", "CUDA_KERNELS", "LAUNCHES", "SOURCE", "KINDS",
           "reset_launches"]

# one source holds the kernel and the decode pool
SOURCE = "image_decode"
CUDA_KERNELS = {"crop_mirror_normalize": "_crop_mirror_normalize_plain"}
LAUNCHES = {name: 0 for name in CUDA_KERNELS}

# the planes' layout an item's kind names, by nvjpegChromaSubsampling_t
# (NVJPEG_CSS_444 0, _422 1, _420 2, _GRAY 6); other subsamplings (4:4:0,
# 4:1:1, ...) are refused
KINDS = {"gray": 0, "444": 1, "422": 2, "420": 3}
_CSS_KIND = {0: KINDS["444"], 1: KINDS["422"], 2: KINDS["420"],
             6: KINDS["gray"]}
_ITEM = 9

_P = ctypes.c_void_p
_SYMBOLS = {
    # src, items, n, channels, out_h, out_w, mean, std, out, stream
    "crop_mirror_normalize": [_P, _P, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, _P, _P, _P, _P],
    "imgdec_nv_create": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "imgdec_nv_create_error": [],
    "imgdec_nv_info": [_P, ctypes.c_int, _P, _P, _P],
    "imgdec_nv_decode": [_P, ctypes.c_int, _P, _P, _P, _P, _P, _P],
    "imgdec_nv_last_error": [_P],
    "imgdec_nv_destroy": [_P],
}
_RESTYPES = {"imgdec_nv_create": ctypes.c_void_p,
             "imgdec_nv_create_error": ctypes.c_char_p,
             "imgdec_nv_last_error": ctypes.c_char_p,
             "imgdec_nv_destroy": None}
_lock = threading.Lock()
_lib = []


def reset_launches():
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _cuda_home():
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def nvjpeg_available():
    """Whether the CUDA toolkit here has nvJPEG's header and library."""
    home = _cuda_home()
    return (os.path.exists(os.path.join(home, "include", "nvjpeg.h"))
            and bool(glob.glob(os.path.join(home, "lib64", "libnvjpeg.so*"))))


def _library():
    """The kernel library, built on first use, with nvJPEG loaded first
    (the library names it; the CUDA toolkit's lib64 is not on every
    loader path)."""
    with _lock:
        if not _lib:
            libs = sorted(glob.glob(os.path.join(_cuda_home(), "lib64",
                                                 "libnvjpeg.so*")))
            if not libs:
                raise MXNetError("nvJPEG not found under %s/lib64"
                                 % _cuda_home())
            ctypes.CDLL(libs[0], mode=ctypes.RTLD_GLOBAL)
            lib = _build.load(SOURCE, _SYMBOLS)
            for sym, res in _RESTYPES.items():
                getattr(lib, sym).restype = res
            _lib.append(lib)
        return _lib[0]


def _upsample(c, kind, h, w):
    """A chroma plane (int32) at full resolution (h, w), as libjpeg-turbo
    upsamples it (jdsample.c): "fancy" triangular filters with their
    rounding, edges replicated; replication where the plane is at most 2
    samples wide."""
    ch, cw = c.shape
    dev = c.device
    x = torch.arange(w, device=dev)
    cc = x >> 1
    odd = (x & 1).bool()
    nb = torch.where(odd, (cc + 1).clamp(max=cw - 1), (cc - 1).clamp(min=0))
    if kind == KINDS["444"]:
        return c[:h, :w]
    if kind == KINDS["422"]:
        if cw <= 2:
            return c[:h, cc]
        return (3 * c[:h, cc] + c[:h, nb] + torch.where(odd, 2, 1)) >> 2
    y = torch.arange(h, device=dev)
    near = y >> 1
    if cw <= 2:
        return c[near][:, cc]
    far = torch.where((y & 1).bool(), (near + 1).clamp(max=ch - 1),
                      (near - 1).clamp(min=0))
    cs = 3 * c[near] + c[far]
    return (3 * cs[:, cc] + cs[:, nb] + torch.where(odd, 7, 8)) >> 4


def _rgb(src, item, channels):
    """(h, w, channels) int32 of one item's planes."""
    off, h, w, _x0, _y0, _m, kind, ch, cw = item
    yp = src[off:off + h * w].reshape(h, w).to(torch.int32)
    if channels == 1:
        return yp[..., None]
    if kind == KINDS["gray"]:
        return yp[..., None].expand(h, w, 3)
    cb = src[off + h * w:off + h * w + ch * cw].reshape(ch, cw)
    cr = src[off + h * w + ch * cw:off + h * w + 2 * ch * cw].reshape(
        ch, cw)
    u = _upsample(cb.to(torch.int32), kind, h, w) - 128
    v = _upsample(cr.to(torch.int32), kind, h, w) - 128
    # jdcolor.c ycc_rgb_convert: FIX(x) = x * 2^16 rounded
    r = yp + ((91881 * v + 32768) >> 16)
    g = yp + ((-22554 * u + 32768 - 46802 * v) >> 16)
    b = yp + ((116130 * u + 32768) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255)


def _crop_mirror_normalize_plain(src, items, out_shape, mean, std,
                                 out=None):
    """Plain version of :func:`crop_mirror_normalize`: one image at a
    time, libjpeg-turbo's RGB of the planes (int32 arithmetic), then
    ``(crop.float() - mean) / std`` in float32."""
    c, oh, ow = out_shape
    n = items.shape[0]
    if out is None:
        out = torch.empty((n, c, oh, ow), dtype=torch.float32,
                          device=src.device)
    m = torch.tensor(mean, dtype=torch.float32,
                     device=src.device).reshape(c, 1, 1)
    s = torch.tensor(std, dtype=torch.float32,
                     device=src.device).reshape(c, 1, 1)
    for i, item in enumerate(items.tolist()):
        x0, y0, mirror = item[3:6]
        crop = _rgb(src, item, c)[y0:y0 + oh, x0:x0 + ow]
        if mirror:
            crop = crop.flip(1)
        out[i] = (crop.permute(2, 0, 1).float() - m) / s
    return out


def plane_layout(info, channels):
    """(kinds, bytes) of images whose :meth:`NvJpegPool.info` rows are
    ``info`` (n, 6), decoded for ``channels`` output channels: each
    image's item kind and the size of its planes. Raises for a
    subsampling the kernel does not convert."""
    kinds = np.empty(len(info), dtype=np.int64)
    nbytes = np.empty(len(info), dtype=np.int64)
    for i, (h, w, ncomp, css, ch, cw) in enumerate(info.tolist()):
        kind = KINDS["gray"] if channels == 1 or ncomp == 1 \
            else _CSS_KIND.get(css)
        if kind is None or ncomp not in (1, 3):
            raise MXNetError(
                "image %d of the batch: %d components, nvJPEG chroma "
                "subsampling %d; the nvjpeg backend converts grayscale, "
                "4:4:4, 4:2:2 and 4:2:0 YCbCr (others: ROADMAP A8.1b)"
                % (i, ncomp, css))
        kinds[i] = kind
        nbytes[i] = h * w + (0 if kind == KINDS["gray"] else 2 * ch * cw)
    return kinds, nbytes


def crop_mirror_normalize(src, items, out_shape, mean, std, out=None):
    """``out[i] = (crop_i - mean) / std`` in float32 NCHW, ``crop_i``
    the (out_h, out_w) window at (x0, y0) of image i's RGB (or its Y
    plane for c = 1), mirrored when its flag is set. ``src``: uint8, the
    images' planes; ``items``: int64 (n, 9) ``(offset, height, width,
    x0, y0, mirror, kind, chroma height, chroma width)`` on the host,
    where the plan is drawn: every item is checked against ``src`` there
    and, for a card's ``src``, copied to it from pinned memory without
    waiting; ``out_shape``: (c, out_h, out_w), c 1 or 3; ``mean``,
    ``std``: c floats; ``out``: float32 (n, c, out_h, out_w) contiguous
    on ``src``'s device, or None."""
    fn = "crop_mirror_normalize"
    c, oh, ow = (int(v) for v in out_shape)
    if c not in (1, 3):
        raise MXNetError("%s: %d channels (1 or 3)" % (fn, c))
    if src.dtype != torch.uint8 or src.dim() != 1:
        raise MXNetError("%s: src must be a flat uint8 tensor" % fn)
    if items.dtype != torch.int64 or items.dim() != 2 \
            or items.shape[1] != _ITEM or items.device.type != "cpu":
        raise MXNetError("%s: items must be int64 (n, %d) on the host"
                         % (fn, _ITEM))
    mean = [float(v) for v in mean]
    std = [float(v) for v in std]
    if len(mean) != c or len(std) != c:
        raise MXNetError("%s: mean and std need %d values" % (fn, c))
    n = int(items.shape[0])
    if out is not None and (out.dtype != torch.float32
                            or tuple(out.shape) != (n, c, oh, ow)
                            or not out.is_contiguous()
                            or out.device != src.device):
        raise MXNetError("%s: out must be float32 (%d, %d, %d, %d) "
                         "contiguous on %s" % (fn, n, c, oh, ow, src.device))
    if src.device.type != "cuda":
        return _crop_mirror_normalize_plain(src, items, (c, oh, ow), mean,
                                            std, out)
    rows = items.numpy()
    if n and ((rows[:, 3] < 0).any() or (rows[:, 4] < 0).any()
              or (rows[:, 3] + ow > rows[:, 2]).any()
              or (rows[:, 4] + oh > rows[:, 1]).any()
              or ((rows[:, 6] < 0) | (rows[:, 6] > 3)).any()
              or (rows[:, 0] + rows[:, 1] * rows[:, 2]
                  + np.where(rows[:, 6] > 0, 2 * rows[:, 7] * rows[:, 8], 0)
                  > src.numel()).any()):
        raise MXNetError("%s: an item reaches outside src or its image"
                         % fn)
    if out is None:
        out = torch.empty((n, c, oh, ow), dtype=torch.float32,
                          device=src.device)
    if n == 0:
        return out
    lib = _library()
    m = (ctypes.c_float * c)(*mean)
    s = (ctypes.c_float * c)(*std)
    # the pinned block is not reused before the copy has run (PyTorch's
    # host allocator records the copy's stream)
    dev_items = items.contiguous().pin_memory().to(src.device,
                                                   non_blocking=True)
    with _build.on_device(src.device):
        err = lib.crop_mirror_normalize(
            src.data_ptr(), dev_items.data_ptr(), n, c, oh, ow,
            ctypes.cast(m, _P), ctypes.cast(s, _P), out.data_ptr(),
            torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise MXNetError("%s: CUDA kernel launch failed (cudaError_t %d)"
                         % (fn, err))
    LAUNCHES["crop_mirror_normalize"] += 1
    return out


class NvJpegPool(object):
    """nvJPEG decode on ``device`` by ``threads`` host threads (0: one a
    core), each with its own nvJPEG state and stream; ``channels`` 3
    (RGB) or 1 (Y)."""

    def __init__(self, threads, device, channels):
        self._lib = _library()
        self.device = torch.device(device)
        self.channels = int(channels)
        self._h = self._lib.imgdec_nv_create(
            int(threads), int(self.device.index or 0), self.channels)
        if not self._h:
            raise MXNetError("nvJPEG decoder: %s" % self._lib
                             .imgdec_nv_create_error().decode())

    def _error(self):
        return self._lib.imgdec_nv_last_error(self._h).decode(
            "utf-8", "replace")

    @staticmethod
    def _buffers(bufs):
        n = len(bufs)
        arr = (ctypes.c_char_p * n)(*bufs)
        lens = np.array([len(b) for b in bufs], dtype=np.int64)
        return arr, lens

    def info(self, bufs):
        """(n, 6) int32 of the JPEG buffers: height, width, components,
        nvJPEG chroma subsampling, chroma height, chroma width."""
        arr, lens = self._buffers(bufs)
        info = np.empty((len(bufs), 6), dtype=np.int32)
        if self._lib.imgdec_nv_info(self._h, len(bufs), ctypes.cast(arr, _P),
                                    lens.ctypes.data, info.ctypes.data) != 0:
            raise MXNetError("nvJPEG decode failed: %s" % self._error())
        return info

    def decode(self, bufs, dst, offsets, info):
        """Decode ``bufs`` into the uint8 device tensor ``dst``, each
        image's planes (:func:`plane_layout`) at its byte offset in
        ``offsets`` (int64), ``info`` as :meth:`info` gave it. Returns
        when every image is written; the pool waits for the current
        stream's work first."""
        arr, lens = self._buffers(bufs)
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        info = np.ascontiguousarray(info, dtype=np.int32)
        _, nbytes = plane_layout(info, self.channels)
        if len(bufs) and ((offsets + nbytes).max() > dst.numel()
                          or offsets.min() < 0):
            raise MXNetError("nvJPEG decode: the images do not fit dst")
        with _build.on_device(self.device):
            rc = self._lib.imgdec_nv_decode(
                self._h, len(bufs), ctypes.cast(arr, _P), lens.ctypes.data,
                dst.data_ptr(), offsets.ctypes.data, info.ctypes.data,
                torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise MXNetError("nvJPEG decode failed: %s" % self._error())

    def close(self):
        h, self._h = self._h, None
        if h:
            self._lib.imgdec_nv_destroy(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
