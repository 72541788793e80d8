"""Inference BatchNorm, written by hand in CUDA for Hopper.

    batch_norm_inference(x, gamma, beta, mean, var, eps, fix_gamma)

is ``x * a + b`` per channel (axis 1) with ``a = gamma / sqrt(var +
eps)`` and ``b = beta - mean * a``: the BatchNorm op with the moving
statistics, as in every scoring forward (the fp32 and the int8
Predictor, ``Module.predict``, calibration). The JAX package leaves it
to XLA; there is no Pallas kernel to replace. The kernel
(``csrc/batch_norm_inference.cu``) does each of these operations
correctly rounded and in this order, so its output equals the plain
version's, :func:`_batch_norm_inference_plain`, bitwise, and the card
equals the CPU. PyTorch's own inference BatchNorm (``F.batch_norm``)
does not, and a quantized network turns an ulp before a rounding
boundary into an int8 step.

A wrapper launches the kernel for CUDA tensors, on
``torch.cuda.current_stream()``, and raises when the launch returns a
CUDA error. It takes the plain version only because the tensors it was
given lie on the CPU (or on the ``meta`` device); nothing falls back to
it. When a gradient is wanted (BatchNorm with ``use_global_stats`` in
training), the kernel runs forward and the backward is that of the
plain version. Every kernel launch adds one to :data:`LAUNCHES` (plain
calls do not).
"""
from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from . import _build

__all__ = ["batch_norm_inference", "CUDA_KERNELS", "LAUNCHES",
           "reset_launches"]

# kernel-contract registry: every CUDA kernel maps to its plain PyTorch
# version in this module (tests/test_torch_contract.py checks each has
# its csrc/<kernel>.cu source and a CPU test naming both)
CUDA_KERNELS = {"batch_norm_inference": "_batch_norm_inference_plain"}

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {name: 0 for name in CUDA_KERNELS}

_P = ctypes.c_void_p
# x, gamma, beta, mean, var, y, n, c, inner, eps, fix_gamma, stream
_SYMBOLS = {"batch_norm_inference": [_P] * 6 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
    ctypes.c_int, _P]}


def reset_launches():
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _batch_norm_inference_plain(x, gamma, beta, mean, var, eps,
                                fix_gamma=False):
    """Plain version of :func:`batch_norm_inference`, in ``x``'s type
    (float32, or float64 for a float64 witness). The square root is taken
    in float64 and rounded to the type: PyTorch's float32 ``sqrt`` on the
    CPU (MKL's vector math) is not always correctly rounded, and a
    float64 root within an ulp rounds to the correctly rounded float32
    one."""
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    a = gamma / torch.sqrt((var + eps).double()).to(var.dtype)
    b = beta - mean * a
    chan = (1, -1) + (1,) * (x.dim() - 2)
    return x * a.reshape(chan) + b.reshape(chan)


def _launch(x, gamma, beta, mean, var, eps, fix_gamma):
    y = torch.empty_like(x)
    inner = 1
    for d in x.shape[2:]:
        inner *= int(d)
    lib = _build.load("batch_norm_inference",
                      {"batch_norm_inference": _SYMBOLS[
                          "batch_norm_inference"]})
    with torch.cuda.device(x.device):
        err = lib.batch_norm_inference(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(),
            var.data_ptr(), y.data_ptr(), int(x.shape[0]), int(x.shape[1]),
            inner, float(eps), int(bool(fix_gamma)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise MXNetError("batch_norm_inference: CUDA kernel launch failed "
                         "(cudaError_t %d)" % err)
    LAUNCHES["batch_norm_inference"] += 1
    return y


class _KernelWithPlainBackward(torch.autograd.Function):
    """The kernel forward; the gradients of the plain version."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mean, var, eps, fix_gamma):
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps, ctx.fix_gamma = eps, fix_gamma
        return _launch(x, gamma, beta, mean, var, eps, fix_gamma)

    @staticmethod
    def backward(ctx, dy):
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in ins if t.requires_grad]
        with torch.enable_grad():
            y = _batch_norm_inference_plain(*ins, ctx.eps, ctx.fix_gamma)
            grads = iter(torch.autograd.grad(y, wanted, dy,
                                             allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None
                     for t in ins) + (None, None)


def batch_norm_inference(x, gamma, beta, mean, var, eps, fix_gamma=False):
    """``x * a + b`` per channel of axis 1, ``a = gamma / sqrt(var +
    eps)``, ``b = beta - mean * a``: ``x`` (n, c, ...) float32
    contiguous, ``gamma``, ``beta``, ``mean``, ``var`` (c,) float32;
    ``fix_gamma`` takes gamma as ones. Returns float32 of ``x``'s shape."""
    fn = "batch_norm_inference"
    if not isinstance(x, torch.Tensor) or x.dim() < 2:
        raise MXNetError("%s: x must be a tensor of at least 2 dims" % fn)
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta),
                    ("mean", mean), ("var", var)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise MXNetError("%s: %s must be a float32 tensor" % (fn, name))
        if t.device != x.device:
            raise MXNetError("%s: %s is on %s, x on %s"
                             % (fn, name, t.device, x.device))
        if not t.is_contiguous():
            raise MXNetError("%s: %s must be contiguous" % (fn, name))
        if t is not x and tuple(t.shape) != (x.shape[1],):
            raise MXNetError("%s: %s has shape %s, expected (%d,)"
                             % (fn, name, tuple(t.shape), x.shape[1]))
    if x.device.type != "cuda":
        return _batch_norm_inference_plain(x, gamma, beta, mean, var, eps,
                                           fix_gamma)
    if x.numel() == 0:
        raise MXNetError("%s: empty input %s" % (fn, tuple(x.shape)))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gamma, beta, mean, var)):
        return _KernelWithPlainBackward.apply(x, gamma, beta, mean, var,
                                              eps, fix_gamma)
    return _launch(x, gamma, beta, mean, var, eps, fix_gamma)
