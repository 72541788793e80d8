"""The nvJPEG backend of ``image.ImageIter``'s "native" route, and its
kernel, written by hand in CUDA for Hopper.

    crop_mirror_normalize(src, items, out_shape, mean, std, out=None)

reads each decoded image from ``src``, its JPEG component planes (Y,
then Cb and Cr at their subsampled size) one image after another, and
writes float32 NCHW ``(v - mean[c]) / std[c]`` of what the JAX
package's host decoder (``src/native/imagedec.cc``) makes of them: the
RGB image, resized to its resized size (the short side to the
iterator's ``resize``), the crop at (x0, y0), resized to the output
where it is smaller, mirrored where the plan says so. The RGB value is
libjpeg-turbo's for those planes: its "fancy" chroma upsampling (4:2:0,
4:2:2 and 4:4:0; plain replication for 4:1:1 and 4:1:0; 4:4:4 and
grayscale need none) and its integer YCbCr-to-RGB tables, which is what
OpenCV's decoder computes after the inverse DCT. The resizes are
OpenCV's ``INTER_CUBIC`` on 8-bit data, bit for bit
(:func:`_resize_cubic_plain`). ``items`` holds one int64 row an image:
``(byte offset, height, width, x0, y0, mirror, kind, chroma height,
chroma width, resized height, resized width, crop height, crop
width)``, ``kind`` one of :data:`KINDS`. One launch a batch
(``csrc/image_decode.cu``), two where an image is resized below its
crop (the first writes those crops, resized, as uint8 to a scratch
buffer, and counts as a launch); the kernel equals the plain version,
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
# (NVJPEG_CSS_444 0, _422 1, _420 2, _440 3, _411 4, _410 5, _GRAY 6);
# 4:1:0 with vertical subsampling (_410V 7) and four components (CMYK,
# YCCK) are refused
KINDS = {"gray": 0, "444": 1, "422": 2, "420": 3, "440": 4, "411": 5,
         "410": 6}
_CSS_KIND = {0: KINDS["444"], 1: KINDS["422"], 2: KINDS["420"],
             3: KINDS["440"], 4: KINDS["411"], 5: KINDS["410"],
             6: KINDS["gray"]}
# (horizontal, vertical) chroma subsampling of each colour kind
_SUBSAMPLING = {1: (1, 1), 2: (2, 1), 3: (2, 2), 4: (1, 2), 5: (4, 1),
                6: (4, 2)}
_ITEM = 13
# the kernel's output tile: _TILE x _TILE a CTA
_TILE = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_SYMBOLS = {
    # src, src_bytes, items, n, channels, out_h, out_w, crops, wx_cap,
    # wy_cap, cx_cap, cy_cap, hsub, vsub, resizes, vec, mean, std,
    # scratch, out, stream
    "crop_mirror_normalize": [_P, ctypes.c_longlong, _P] + [_I] * 13
    + [_P] * 5,
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
    rounding (h2v1, h2v2, h1v2), edges replicated; replication where an
    h2 plane is at most 2 samples wide, and for 4:1:1 and 4:1:0
    (``int_upsample``)."""
    ch, cw = c.shape
    dev = c.device
    x = torch.arange(w, device=dev)
    y = torch.arange(h, device=dev)
    if kind == KINDS["444"]:
        return c[:h, :w]
    if kind in (KINDS["411"], KINDS["410"]):
        return c[y >> 1 if kind == KINDS["410"] else y][:, x >> 2]
    if kind == KINDS["440"]:
        near = y >> 1
        odd = (y & 1).bool()
        far = torch.where(odd, (near + 1).clamp(max=ch - 1),
                          (near - 1).clamp(min=0))
        return (3 * c[near, :w] + c[far, :w]
                + torch.where(odd, 2, 1)[:, None]) >> 2
    cc = x >> 1
    odd = (x & 1).bool()
    nb = torch.where(odd, (cc + 1).clamp(max=cw - 1), (cc - 1).clamp(min=0))
    if kind == KINDS["422"]:
        if cw <= 2:
            return c[:h, cc]
        return (3 * c[:h, cc] + c[:h, nb] + torch.where(odd, 2, 1)) >> 2
    near = y >> 1
    if cw <= 2:
        return c[near][:, cc]
    far = torch.where((y & 1).bool(), (near + 1).clamp(max=ch - 1),
                      (near - 1).clamp(min=0))
    cs = 3 * c[near] + c[far]
    return (3 * cs[:, cc] + cs[:, nb] + torch.where(odd, 7, 8)) >> 4


def _rgb(src, item, channels):
    """(h, w, channels) uint8 of one item's planes."""
    off, h, w = item[:3]
    kind, ch, cw = item[6:9]
    yp = src[off:off + h * w].reshape(h, w)
    if channels == 1:
        return yp[..., None]
    if kind == KINDS["gray"]:
        return yp[..., None].expand(h, w, 3)
    yp = yp.to(torch.int32)
    cb = src[off + h * w:off + h * w + ch * cw].reshape(ch, cw)
    cr = src[off + h * w + ch * cw:off + h * w + 2 * ch * cw].reshape(
        ch, cw)
    u = _upsample(cb.to(torch.int32), kind, h, w) - 128
    v = _upsample(cr.to(torch.int32), kind, h, w) - 128
    # jdcolor.c ycc_rgb_convert: FIX(x) = x * 2^16 rounded
    r = yp + ((91881 * v + 32768) >> 16)
    g = yp + ((-22554 * u + 32768 - 46802 * v) >> 16)
    b = yp + ((116130 * u + 32768) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)


def _cubic_tables(n_in, n_out):
    """One axis of OpenCV's ``INTER_CUBIC`` resize of ``n_in`` samples to
    ``n_out`` (imgproc/src/resize.cpp, ``interpolateCubic``): for each
    output index its four source taps, clamped to the axis (replicate),
    and their coefficients as 11-bit integers, int64 (n_out, 4) each.
    The coordinate in float64, the coefficients in float32 with A =
    -0.75, each operation rounded on its own (numpy fuses none), then
    rounded half to even times 2048."""
    f = np.float32
    scale = 1.0 / (n_out / n_in)
    fx = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(f)
    s = np.floor(fx)
    x = fx - s
    a = f(-0.75)
    x1 = x + f(1)
    c0 = ((a * x1 - f(5) * a) * x1 + f(8) * a) * x1 - f(4) * a
    c1 = ((a + f(2)) * x - (a + f(3))) * x * x + f(1)
    omx = f(1) - x
    c2 = ((a + f(2)) * omx - (a + f(3))) * omx * omx + f(1)
    c3 = f(1) - c0 - c1 - c2
    alpha = np.rint(np.stack([c0, c1, c2, c3], 1) * f(2048)).astype(np.int64)
    taps = np.clip(s.astype(np.int64)[:, None] - 1 + np.arange(4), 0,
                   n_in - 1)
    return taps, alpha


def _resize_cubic_plain(img, nh, nw):
    """uint8 (h, w, c) resized to (nh, nw) as OpenCV's ``cv::resize``
    with ``INTER_CUBIC`` computes it on 8-bit data (the generic path of
    the x86 build the JAX package's decoder links): an exact int32
    horizontal pass with :func:`_cubic_tables`' coefficients, then the
    vertical pass in float32, ``t = S3*b3; t = S2*b2 + t; t = S1*b1 + t;
    t = S0*b0 + t`` with ``b = beta * 2^-22``, each product and sum
    rounded, then rounded half to even, except in the last ``(nw * c) %
    8`` values of each row, which its 8-lane SIMD loop leaves to the
    integer formula ``(sum beta*S + 2^21) >> 22``; clamped to 0..255.
    The same size is a copy."""
    h, w, c = img.shape
    if (nh, nw) == (h, w):
        return img
    dev = img.device
    tx, ax = (torch.from_numpy(v).to(dev) for v in _cubic_tables(w, nw))
    ty, ay = (torch.from_numpy(v).to(dev) for v in _cubic_tables(h, nh))
    src = img.to(torch.int32)
    hor = src[:, tx[:, 0]] * ax[:, 0, None].to(torch.int32)
    for k in (1, 2, 3):
        hor += src[:, tx[:, k]] * ax[:, k, None].to(torch.int32)
    rows = [hor[ty[:, k]] for k in range(4)]        # (nh, nw, c) each
    b = ay.to(torch.float32)[:, :, None, None] * 2.0 ** -22
    t = rows[3].to(torch.float32) * b[:, 3]         # exact: |S| < 2^24
    for k in (2, 1, 0):
        t = rows[k].to(torch.float32) * b[:, k] + t
    v = torch.round(t).to(torch.int32)
    # the row's last (nw * c) % 8 values: the integer formula
    x0 = nw * c // 8 * 8 // c
    beta = ay.to(torch.int32)[:, :, None, None]
    fixed = (sum(rows[k][:, x0:] * beta[:, k] for k in range(4))
             + (1 << 21)) >> 22
    e = (torch.arange(x0, nw, device=dev)[:, None] * c
         + torch.arange(c, device=dev)[None, :])
    v[:, x0:] = torch.where(e >= nw * c // 8 * 8, fixed, v[:, x0:])
    return v.clamp(0, 255).to(torch.uint8)


def _augment_plain(rgb, item, oh, ow):
    """(oh, ow, c) uint8: ``rgb`` (an item's image) resized to the item's
    resized size, cropped, the crop resized to (oh, ow), mirrored."""
    x0, y0, mirror = item[3:6]
    rh, rw, ch, cw = item[9:13]
    img = _resize_cubic_plain(rgb, rh, rw)
    crop = _resize_cubic_plain(img[y0:y0 + ch, x0:x0 + cw], oh, ow)
    return crop.flip(1) if mirror else crop


def _crop_mirror_normalize_plain(src, items, out_shape, mean, std,
                                 out=None):
    """Plain version of :func:`crop_mirror_normalize`: one image at a
    time, libjpeg-turbo's RGB of the planes (int32 arithmetic), OpenCV's
    cubic resizes (:func:`_augment_plain`), then ``(crop.float() - mean)
    / std`` in float32."""
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
        crop = _augment_plain(_rgb(src, item, c), item, oh, ow)
        out[i] = (crop.permute(2, 0, 1).float() - m) / s
    return out


def plane_layout(info, channels):
    """(kinds, bytes) of images whose :meth:`NvJpegPool.info` rows are
    ``info`` (n, 6), decoded for ``channels`` output channels: each
    image's item kind and the size of its planes. Raises for what the
    kernel does not convert: four components (CMYK, YCCK) and 4:1:0 with
    vertical subsampling."""
    kinds = np.empty(len(info), dtype=np.int64)
    nbytes = np.empty(len(info), dtype=np.int64)
    for i, (h, w, ncomp, css, ch, cw) in enumerate(info.tolist()):
        kind = KINDS["gray"] if channels == 1 or ncomp == 1 \
            else _CSS_KIND.get(css)
        if kind is None or ncomp not in (1, 3):
            raise MXNetError(
                "image %d of the batch: %d components, nvJPEG chroma "
                "subsampling %d; the nvjpeg backend converts grayscale "
                "and 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, 4:1:0 YCbCr "
                "(CMYK, YCCK and 4:1:0 vertical: ROADMAP A8.1b)"
                % (i, ncomp, css))
        kinds[i] = kind
        nbytes[i] = h * w + (0 if kind == KINDS["gray"] else 2 * ch * cw)
    return kinds, nbytes


def _check_items(rows, src_bytes, c, oh, ow, fn):
    """Raise unless every item lies inside ``src`` and its image, and
    its crop inside the (oh, ow) output (which a smaller crop is resized
    to)."""
    off, h, w, x0, y0, mirror, kind, ch, cw, rh, rw, crh, crw = rows.T
    colour = (kind > 0) & (c == 3)
    hs, vs = np.array([(1, 1)] + [_SUBSAMPLING[k] for k in range(1, 7)])[
        np.clip(kind, 0, 6)].T
    bad = ((kind < 0) | (kind > 6) | (np.minimum(h, w) < 1) | (off < 0)
           | (off + h * w + colour * 2 * ch * cw > src_bytes)
           | (np.minimum(x0, y0) < 0) | (np.minimum(crh, crw) < 1)
           | (crh > oh) | (crw > ow) | (x0 + crw > rw) | (y0 + crh > rh) | (mirror >> 1 != 0)
           | (colour & ((ch * vs < h) | (cw * hs < w))))
    if bad.any():
        raise MXNetError("%s: item %d reaches outside src or its image"
                         % (fn, int(np.argmax(bad))))


def _axis_cap(n_in, n_out):
    """The most source samples a tile's 32 outputs of n_in -> n_out axes
    can need: the tile itself for the identity, else the span of their
    taps (with float32's slack), at most 4 a tile output (the kernel then
    gathers 4 taps an output)."""
    span = np.floor((_TILE - 1) * (n_in / n_out) + 0.01).astype(np.int64)
    return int(np.where(n_in == n_out, _TILE,
                        np.minimum(4 * _TILE, span + 6)).max())


def crop_mirror_normalize(src, items, out_shape, mean, std, out=None):
    """``out[i] = (crop_i - mean) / std`` in float32 NCHW, ``crop_i``
    image i's RGB (or its Y plane for c = 1) resized to its resized
    size, the crop at (x0, y0), resized to (out_h, out_w) where it is
    smaller, mirrored when its flag is set. ``src``: uint8, the images'
    planes; ``items``: int64 (n, 13) ``(offset, height, width, x0, y0,
    mirror, kind, chroma height, chroma width, resized height, resized
    width, crop height, crop width)`` on the host, where the plan is
    drawn: every item is checked against ``src`` there and, for a card's
    ``src``, copied to it from pinned memory without waiting;
    ``out_shape``: (c, out_h, out_w), c 1 or 3;
    ``mean``, ``std``: c floats; ``out``: float32 (n, c, out_h, out_w)
    contiguous on ``src``'s device, or None."""
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
    rows = items.numpy()
    if n:
        _check_items(rows, src.numel(), c, oh, ow, fn)
    if src.device.type != "cuda":
        return _crop_mirror_normalize_plain(src, items, (c, oh, ow), mean,
                                            std, out)
    if out is None:
        out = torch.empty((n, c, oh, ow), dtype=torch.float32,
                          device=src.device)
    if n == 0:
        return out
    lib = _library()
    m = (ctypes.c_float * c)(*mean)
    s = (ctypes.c_float * c)(*std)
    h, w, rh, rw, crh, crw = (rows[:, k] for k in (1, 2, 9, 10, 11, 12))
    small = (crh != oh) | (crw != ow)
    crops = small & ((rh != h) | (rw != w))
    # the final pass's axes: the crop resized to the output, or the
    # short side's resize (the identity without one)
    wy = _axis_cap(np.where(small, crh, h), np.where(small, oh, rh))
    wx = _axis_cap(np.where(small, crw, w), np.where(small, ow, rw))
    cy = cx = 1
    scratch = out
    if crops.any():
        # the crops pass: the short side's resize of the crops of images
        # resized below them, uint8 HWC at i * oh * ow * c
        cy, cx = _axis_cap(h[crops], rh[crops]), _axis_cap(w[crops],
                                                         rw[crops])
        scratch = torch.empty(n * oh * ow * c, dtype=torch.uint8,
                              device=src.device)
    # the pinned block is not reused before the copy has run (PyTorch's
    # host allocator records the copy's stream)
    dev_items = items.contiguous().pin_memory().to(src.device,
                                                   non_blocking=True)
    vec = int(ow % 4 == 0 and out.data_ptr() % 16 == 0)
    # the least chroma subsampling of the colour planes sizes the
    # kernel's chroma buffers
    colour = rows[:, 6][rows[:, 6] > 0] if c == 3 else rows[:0, 6]
    sub = np.array([_SUBSAMPLING[k] for k in set(colour.tolist())] or
                   [(0, 0)])
    with _build.on_device(src.device):
        err = lib.crop_mirror_normalize(
            src.data_ptr(), src.numel(), dev_items.data_ptr(), n, c, oh, ow,
            int(crops.any()), wx, wy, cx, cy, int(sub[:, 0].min()),
            int(sub[:, 1].min()), int((small | (rh != h) | (rw != w)).any()),
            vec, ctypes.cast(m, _P),
            ctypes.cast(s, _P), scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise MXNetError("%s: CUDA kernel launch failed (cudaError_t %d)"
                         % (fn, err))
    LAUNCHES["crop_mirror_normalize"] += 1 + int(crops.any())
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
