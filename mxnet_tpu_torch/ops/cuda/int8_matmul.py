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
implicit GEMM that gathers the patches while it loads them.

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
:data:`LAUNCHES` (plain calls do not).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...base import MXNetError
from . import _build

__all__ = ["int8_matmul", "int8_conv_im2col", "CUDA_KERNELS", "LAUNCHES",
           "reset_launches", "exact_conv"]

# kernel-contract registry: every CUDA kernel maps to its plain PyTorch
# version in this module (tests/test_torch_contract.py checks each has
# its csrc/<kernel>.cu source and a CPU test naming both)
CUDA_KERNELS = {
    "int8_matmul": "_int8_matmul_plain",
    "int8_conv_im2col": "_int8_conv_plain",
}

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {name: 0 for name in CUDA_KERNELS}

# one int32 sum of int8 products is exact while k * 128 * 128 < 2^31
MAX_K = 131071

_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {
    # x, w, scale, out, m, n, k, stream
    "int8_matmul": {"int8_matmul": [_P, _P, _P, _P, _I, _I, _I, _P]},
    # x, w, scale, out, b, c, h, w, cout, groups, kh, kw, sh, sw, ph, pw,
    # dh, dw, oh, ow, stream
    "int8_conv_im2col": {"int8_conv_im2col": [_P] * 4 + [_I] * 16 + [_P]},
}


def reset_launches():
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    return acc.float() * scale.float().reshape(1, -1, 1, 1)


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
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = _build.load("int8_matmul", _SYMBOLS["int8_matmul"])
    with torch.cuda.device(x.device):
        err = lib.int8_matmul(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                              out.data_ptr(), m, n, k,
                              torch.cuda.current_stream().cuda_stream)
    _raise_on("int8_matmul", err)
    return out


def int8_conv_im2col(q, wq, scale, stride, dilate, pad, num_group=1):
    """2-D int8 convolution with a per-channel rescale: ``q`` (b, cin, h,
    w) int8 NCHW, ``wq`` (cout, cin // num_group, kh, kw) int8, ``scale``
    (cout,) float32 (``w_scale / act_scale`` for the quantized conv op);
    ``stride``, ``dilate``, ``pad`` 2-tuples, symmetric padding. Returns
    (b, cout, oh, ow) float32."""
    _check_tensors("int8_conv_im2col", (("q", q, torch.int8, 4),
                                        ("wq", wq, torch.int8, 4),
                                        ("scale", scale, torch.float32, 1)))
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
    out = torch.empty((b, cout, oh, ow), dtype=torch.float32,
                      device=q.device)
    lib = _build.load("int8_conv_im2col", _SYMBOLS["int8_conv_im2col"])
    with torch.cuda.device(q.device):
        err = lib.int8_conv_im2col(
            q.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
            b, cin, h, w, cout, groups, kh, kw, stride[0], stride[1], pad[0],
            pad[1], dilate[0], dilate[1], oh, ow,
            torch.cuda.current_stream().cuda_stream)
    _raise_on("int8_conv_im2col", err)
    return out


def _check_tensors(fn, specs):
    """Type, rank, device and contiguity of each (name, tensor, dtype,
    ndim); all on one device, which is the CPU, the card or ``meta``."""
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
        if not t.is_contiguous():
            raise MXNetError("%s: %s must be contiguous" % (fn, name))
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise MXNetError("%s: %s is on %s, expected %s"
                             % (fn, name, t.device, dev))
    if dev.type not in ("cpu", "cuda", "meta"):
        raise MXNetError("%s: unsupported device %s" % (fn, dev))


def _check_k(fn, k):
    if k > MAX_K:
        raise MXNetError("%s: a contraction of %d values can overflow the "
                         "kernel's int32 sums (at most %d)" % (fn, k, MAX_K))


def _raise_on(name, err):
    if err != 0:
        raise MXNetError("%s: CUDA kernel launch failed (cudaError_t %d)"
                         % (name, err))
    LAUNCHES[name] += 1
