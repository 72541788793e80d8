"""The int8 kernels of quantized serving, written by hand in CUDA for
Hopper.

Counterpart of the JAX package's ``ops/pallas/int8_matmul.py``:

    int8_matmul(x, w, scale)            # (m, n) float32
    int8_conv_im2col(q, wq, scale, stride, dilate, pad, num_group=1)

``int8_matmul`` is ``(x . w^T) * scale[None, :]`` for int8 ``x`` (m, k)
and ``w`` (n, k), with exact int32 sums and the float32 per-channel
rescale in the kernel's epilogue (``csrc/int8_matmul.cu``).
``int8_conv_im2col`` is the NCHW int8 convolution (stride, dilation,
symmetric padding, groups) with the same epilogue, ``q`` (b, cin, h, w),
``wq`` (cout, cin // num_group, kh, kw), ``scale`` (cout,) ->
(b, cout, oh, ow) float32. On the TPU it unfolds the patches and runs
the matmul kernel per group; here ``csrc/int8_conv_im2col.cu`` is an
implicit GEMM that loads the patches without building them.

Each kernel has two routes, picked before the launch from shapes,
memory formats and alignment alone (:func:`matmul_route`,
:func:`conv_route`); a failed launch raises and nothing retries on the
other route. ``wgmma``: TMA rings feeding Hopper's warpgroup products,
A and B swapped so that the weights fill the 64-row operand; the matmul
splits K across CTAs at small m (its int32 partials meet in a workspace
kept per device and stream, zero between launches), the convolution
takes ``q`` and ``wq`` in channels-last memory (NHWC / OHWI, K-major
as wgmma reads 8-bit operands), which quantized serving gives it (the
activation quantizer writes channels-last, the Predictor binds the
weights so). ``mma_sync``: the first design, for ragged or unaligned
matmuls, the 3-channel stem, narrow groups and NCHW callers; an operand
in the other memory format is copied to the route's, and each copy is
counted in :data:`CONVERSIONS`.

Beside them, ``_int8_matmul_plain`` and ``_int8_conv_plain`` are the
plain PyTorch versions. PyTorch has no integer matrix product or
convolution on the card, so they sum in float64, which is exact here
(|sum| <= 127 * 127 * k < 2^53 for any k the kernels take) and does not
depend on the order of the sums; then int32, float32 and one multiply,
as the JAX twins. The kernels agree with them, and with the JAX twins,
bitwise.

A wrapper launches its kernel for CUDA tensors, on
``torch.cuda.current_stream()``, and raises when the launch returns a
CUDA error. It takes the plain version only because the tensors it was
given lie on the CPU (or on the ``meta`` device, where shapes are
inferred); nothing falls back to it. Every kernel launch adds one to
:data:`LAUNCHES` and to its route's count in :data:`ROUTES` (plain calls
do not).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ...base import MXNetError
from . import _build

__all__ = ["int8_matmul", "int8_conv_im2col", "CUDA_KERNELS", "LAUNCHES",
           "ROUTES", "CONVERSIONS", "reset_launches", "exact_conv",
           "matmul_route", "conv_route", "conv_wgmma_shape_ok"]

# kernel-contract registry: every CUDA kernel maps to its plain PyTorch
# version in this module (tests/test_torch_contract.py checks each has
# its csrc/<kernel>.cu source and a CPU test naming both)
CUDA_KERNELS = {
    "int8_matmul": "_int8_matmul_plain",
    "int8_conv_im2col": "_int8_conv_plain",
}

# kernel launches since the last reset_launches(), by kernel name, and
# by kernel and route; operands the conv wrapper copied to its route's
# memory format
LAUNCHES = {name: 0 for name in CUDA_KERNELS}
ROUTES = {name: {"wgmma": 0, "mma_sync": 0} for name in CUDA_KERNELS}
CONVERSIONS = {"int8_conv_im2col": 0}

# one int32 sum of int8 products is exact while k * 128 * 128 < 2^31
MAX_K = 131071

# the wgmma routes' tiles: 64 weight rows by 8-128 rows of x (matmul),
# 64 or 128 output channels by 128 positions (conv); the matmul's K chunk
WG_ROWS, WG_BK = 64, 128
CONV_TILE = 128
# the matmul splits K until its grid has this many CTAs (132 SMs); the
# conv takes 64-channel tiles where 128-channel ones give fewer
MIN_CTAS = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {
    # x, w, scale, out, m, n, k, stream; then the wgmma route:
    # x, w, scale, out, workspace, m, n, k, bn, splits, stream
    "int8_matmul": {"int8_matmul": [_P, _P, _P, _P, _I, _I, _I, _P],
                    "int8_matmul_wgmma": [_P] * 5 + [_I] * 5 + [_P]},
    # x, w, scale, out, b, c, h, w, cout, groups, kh, kw, sh, sw, ph, pw,
    # dh, dw, oh, ow, stream; the wgmma route adds bk and bm before the
    # stream
    "int8_conv_im2col": {"int8_conv_im2col": [_P] * 4 + [_I] * 16 + [_P],
                         "int8_conv_wgmma": [_P] * 4 + [_I] * 18 + [_P]},
}


def reset_launches():
    """Set every kernel's launch count, route count and conversion count
    to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        for route in ROUTES[name]:
            ROUTES[name][route] = 0
    for name in CONVERSIONS:
        CONVERSIONS[name] = 0


def conv_out_size(size, k, stride, dilate, pad):
    """Output length of one convolution axis (symmetric padding)."""
    return (size + 2 * pad - ((k - 1) * dilate + 1)) // stride + 1


# ---------------------------------------------------------------------------
# plain versions: the JAX twins' arithmetic, exact in float64
# ---------------------------------------------------------------------------

def _int8_matmul_plain(x, w, scale):
    """Plain version of :func:`int8_matmul`: the JAX package's
    ``_int8_matmul_xla``."""
    acc = (x.double() @ w.double().t()).to(torch.int32)
    return acc.float() * scale.float()[None, :]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def exact_conv(q, w, stride, dilate, pad, groups):
    """The int32 sums of a convolution of integer-valued tensors, exact:
    summed in float64 (any order), with cuDNN kept out, whose float64
    algorithms may transform the operands (FFT, Winograd)."""
    with torch.backends.cudnn.flags(enabled=False):
        acc = _CONV[w.dim() - 2](q.double(), w.double(), None, tuple(stride),
                                 tuple(pad), tuple(dilate), int(groups))
    return acc.to(torch.int32)


def _int8_conv_plain(q, wq, scale, stride, dilate, pad, num_group=1):
    """Plain version of :func:`int8_conv_im2col`: the JAX package's
    ``_int8_conv_xla``."""
    acc = exact_conv(q, wq, stride, dilate, pad, num_group)
    return (acc.float() * scale.float().reshape(1, -1, 1, 1)).contiguous()


# ---------------------------------------------------------------------------
# routes: pure functions of shapes, memory formats and alignment
# ---------------------------------------------------------------------------

def _ceil(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def matmul_route(m, n, k, aligned=True):
    """``("wgmma", bn, splits)`` or ``("mma_sync", None, None)`` for an
    (m, k) x (n, k) int8 matmul. The wgmma route needs k % 16 == 0 (TMA's
    16-byte row strides) and 16-byte aligned operands (``aligned``); its
    CTA covers 64 rows of w by ``bn`` rows of x, the smallest of 8, 16,
    32, 64 and 128 that holds m (128 beyond), and K is split into
    ``splits`` slices, the smallest power of two that gives the grid
    :data:`MIN_CTAS` CTAs, at most one a 128-byte K chunk."""
    if min(m, n, k) <= 0 or k % 16 or not aligned:
        return ("mma_sync", None, None)
    bn = next((b for b in (8, 16, 32, 64) if m <= b), 128)
    tiles = _ceil(n, WG_ROWS) * _ceil(m, bn)
    chunks = _ceil(k, WG_BK)
    splits = 1
    while tiles * splits < MIN_CTAS and splits * 2 <= chunks:
        splits *= 2
    return ("wgmma", bn, splits)


def matmul_workspace_ints(m, n, bn):
    """int32s of the split-K workspace: a 64 x bn partial tile and a
    counter per output tile."""
    return _ceil(n, WG_ROWS) * _ceil(m, bn) * (WG_ROWS * bn + 1)


@functools.lru_cache(maxsize=4096)
def conv_wgmma_shape_ok(wshape, stride, dilate, pad, groups=1):
    """Whether the wgmma conv route can take a convolution with weights
    of logical shape ``wshape`` (cout, cin // groups, kh, kw), whatever
    its input's batch and size: channel chunks of 32 (cin // groups %
    32 == 0), and what an im2col tensor map encodes (strides at most 8,
    the window's corners -pad and pad - (k - 1) * dilate within
    [-128, 127]). Arguments hashable (shapes, tuples): every forward of
    a quantized conv asks."""
    cout, cin_g, kh, kw = (int(v) for v in wshape)
    if cin_g <= 0 or cin_g % 32 or int(groups) < 1:
        return False
    for k, s, d, p in zip((kh, kw), stride, dilate, pad):
        if not 1 <= s <= 8 or not 0 <= p <= 128 \
                or not -128 <= p - (k - 1) * d <= 127:
            return False
    return True


@functools.lru_cache(maxsize=4096)
def conv_route(qshape, wshape, stride, dilate, pad, groups=1,
               channels_last=True, aligned=True):
    """``("wgmma", bk, bm)`` or ``("mma_sync", None, None)`` for a
    convolution of an input of shape ``qshape`` whose memory is
    channels-last (NHWC) when ``channels_last``, both operands 16-byte
    aligned when ``aligned`` (shapes and 2-tuples, hashable). The wgmma
    route takes a channels-last input and a shape
    :func:`conv_wgmma_shape_ok` accepts; its K chunks are ``bk`` = 64
    channels where cin // groups allows, else 32; its CTAs cover ``bm``
    = 128 output channels where the group has more than 64 and that
    still gives MIN_CTAS CTAs, else 64, by 128 positions."""
    b, cin, h, w = (int(v) for v in qshape)
    if not (channels_last and aligned and b * cin * h * w > 0
            and conv_wgmma_shape_ok(wshape, stride, dilate, pad, groups)):
        return ("mma_sync", None, None)
    cout_g = int(wshape[0]) // int(groups)
    kh, kw = int(wshape[2]), int(wshape[3])
    m = b * conv_out_size(h, kh, stride[0], dilate[0], pad[0]) \
        * conv_out_size(w, kw, stride[1], dilate[1], pad[1])
    tiles = _ceil(m, CONV_TILE) * _ceil(cout_g, 128) * int(groups)
    bm = 128 if cout_g > 64 and tiles >= MIN_CTAS else 64
    return ("wgmma", 64 if int(wshape[1]) % 64 == 0 else 32, bm)


def _channels_last(t):
    return t.is_contiguous(memory_format=torch.channels_last)


# split-K workspaces, one a (device, stream), zero between launches
_workspaces = {}


def _workspace(device, stream, ints):
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < ints:
        ws = _workspaces[key] = torch.zeros(ints, dtype=torch.int32,
                                            device=device)
    return ws


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def int8_matmul(x, w, scale):
    """``(x . w^T) * scale[None, :]``: ``x`` (m, k) and ``w`` (n, k) int8,
    ``scale`` (n,) float32 (for a quantized dense layer ``w_scale /
    act_scale``), int32 sums; returns (m, n) float32."""
    _check_tensors("int8_matmul", (("x", x, torch.int8, 2),
                                   ("w", w, torch.int8, 2),
                                   ("scale", scale, torch.float32, 1)))
    m, k = x.shape
    n = w.shape[0]
    if w.shape[1] != k or scale.shape[0] != n:
        raise MXNetError("int8_matmul: x %s, w %s, scale %s do not agree"
                         % (tuple(x.shape), tuple(w.shape),
                            tuple(scale.shape)))
    if x.device.type != "cuda":
        return _int8_matmul_plain(x, w, scale)
    if min(m, n, k) == 0:
        raise MXNetError("int8_matmul: empty operand x %s, w %s"
                         % (tuple(x.shape), tuple(w.shape)))
    _check_k("int8_matmul", k)
    xp, wp = x.data_ptr(), w.data_ptr()
    route, bn, splits = matmul_route(m, n, k, xp % 16 == 0 and wp % 16 == 0)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = _build.load("int8_matmul", _SYMBOLS["int8_matmul"])
    with _build.on_device(x.device):
        stream = _raw_stream(x.device)
        if route == "wgmma":
            ws = None if splits == 1 else _workspace(
                x.device, stream, matmul_workspace_ints(m, n, bn)).data_ptr()
            err = lib.int8_matmul_wgmma(xp, wp, scale.data_ptr(),
                                        out.data_ptr(), ws, m, n, k, bn,
                                        splits, stream)
        else:
            err = lib.int8_matmul(xp, wp, scale.data_ptr(), out.data_ptr(),
                                  m, n, k, stream)
    _raise_on("int8_matmul", err, route)
    return out


def int8_conv_im2col(q, wq, scale, stride, dilate, pad, num_group=1):
    """2-D int8 convolution with a per-channel rescale: ``q`` (b, cin, h,
    w) int8 NCHW, ``wq`` (cout, cin // num_group, kh, kw) int8, ``scale``
    (cout,) float32 (``w_scale / act_scale`` for the quantized conv op);
    ``stride``, ``dilate``, ``pad`` 2-tuples, symmetric padding. ``q``
    and ``wq`` may lie in contiguous or channels-last memory. Returns
    (b, cout, oh, ow) float32, contiguous."""
    _check_tensors("int8_conv_im2col", (("q", q, torch.int8, 4),
                                        ("wq", wq, torch.int8, 4),
                                        ("scale", scale, torch.float32, 1)),
                   channels_last=("q", "wq"))
    stride, dilate, pad = (tuple(int(v) for v in a)
                           for a in (stride, dilate, pad))
    if not len(stride) == len(dilate) == len(pad) == 2:
        raise MXNetError("int8_conv_im2col: stride, dilate and pad must be "
                         "2-tuples, got %s, %s, %s" % (stride, dilate, pad))
    if min(stride) < 1 or min(dilate) < 1 or min(pad) < 0:
        raise MXNetError("int8_conv_im2col: stride %s, dilate %s, pad %s"
                         % (stride, dilate, pad))
    b, cin, h, w = q.shape
    cout, cin_g, kh, kw = wq.shape
    groups = int(num_group)
    if (groups < 1 or cin % groups or cout % groups
            or cin_g * groups != cin or scale.shape[0] != cout):
        raise MXNetError(
            "int8_conv_im2col: q %s, wq %s, scale %s, num_group %d do not "
            "agree" % (tuple(q.shape), tuple(wq.shape), tuple(scale.shape),
                       groups))
    oh = conv_out_size(h, kh, stride[0], dilate[0], pad[0])
    ow = conv_out_size(w, kw, stride[1], dilate[1], pad[1])
    if oh < 1 or ow < 1:
        raise MXNetError("int8_conv_im2col: the window is larger than the "
                         "padded input %s" % (tuple(q.shape),))
    if q.device.type != "cuda":
        return _int8_conv_plain(q, wq, scale, stride, dilate, pad, groups)
    if min(b, cin, cout) == 0:
        raise MXNetError("int8_conv_im2col: empty operand q %s, wq %s"
                         % (tuple(q.shape), tuple(wq.shape)))
    _check_k("int8_conv_im2col", cin_g * kh * kw)
    if cin * h * w >= 2 ** 31 or b * oh * ow >= 2 ** 31:
        raise MXNetError("int8_conv_im2col: q %s is too large for the "
                         "kernel's 32-bit offsets" % (tuple(q.shape),))
    route, bk, bm = conv_route(
        q.shape, wq.shape, stride, dilate, pad, groups,
        channels_last=_channels_last(q),
        aligned=q.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0)
    # an operand in the other memory format is copied to the route's
    want = torch.channels_last if route == "wgmma" \
        else torch.contiguous_format
    if not q.is_contiguous(memory_format=want):
        q = q.contiguous(memory_format=want)
        CONVERSIONS["int8_conv_im2col"] += 1
    if not wq.is_contiguous(memory_format=want):
        wq = wq.contiguous(memory_format=want)
        CONVERSIONS["int8_conv_im2col"] += 1
    out = torch.empty((b, cout, oh, ow), dtype=torch.float32,
                      device=q.device)
    lib = _build.load("int8_conv_im2col", _SYMBOLS["int8_conv_im2col"])
    shape = (b, cin, h, w, cout, groups, kh, kw, stride[0], stride[1],
             pad[0], pad[1], dilate[0], dilate[1], oh, ow)
    with _build.on_device(q.device):
        stream = _raw_stream(q.device)
        if route == "wgmma":
            err = lib.int8_conv_wgmma(q.data_ptr(), wq.data_ptr(),
                                      scale.data_ptr(), out.data_ptr(),
                                      *shape, bk, bm, stream)
        else:
            err = lib.int8_conv_im2col(q.data_ptr(), wq.data_ptr(),
                                       scale.data_ptr(), out.data_ptr(),
                                       *shape, stream)
    _raise_on("int8_conv_im2col", err, route)
    return out


def _check_tensors(fn, specs, channels_last=()):
    """Type, rank, device and contiguity of each (name, tensor, dtype,
    ndim) (the names in ``channels_last`` may also lie in channels-last
    memory); all on one device, which is the CPU, the card or ``meta``."""
    dev = None
    for name, t, dtype, ndim in specs:
        if not isinstance(t, torch.Tensor):
            raise MXNetError("%s: %s is not a tensor" % (fn, name))
        if t.dtype != dtype:
            raise MXNetError("%s: %s has dtype %s, expected %s"
                             % (fn, name, t.dtype, dtype))
        if t.dim() != ndim:
            raise MXNetError("%s: %s has shape %s, expected %d dims"
                             % (fn, name, tuple(t.shape), ndim))
        if not (t.is_contiguous()
                or (name in channels_last and _channels_last(t))):
            raise MXNetError("%s: %s must be contiguous%s" % (
                fn, name, " or channels-last" if name in channels_last
                else ""))
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise MXNetError("%s: %s is on %s, expected %s"
                             % (fn, name, t.device, dev))
    if dev.type not in ("cpu", "cuda", "meta"):
        raise MXNetError("%s: unsupported device %s" % (fn, dev))


def _raw_stream(device):
    """The current stream of ``device`` as its ``cudaStream_t`` (an int),
    without building a ``torch.cuda.Stream`` (which costs host
    microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _check_k(fn, k):
    if k > MAX_K:
        raise MXNetError("%s: a contraction of %d values can overflow the "
                         "kernel's int32 sums (at most %d)" % (fn, k, MAX_K))


def _raise_on(name, err, route):
    if err != 0:
        raise MXNetError("%s: CUDA kernel launch failed on the %s route "
                         "(cudaError_t %d)" % (name, route, err))
    LAUNCHES[name] += 1
    ROUTES[name][route] += 1
