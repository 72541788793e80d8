"""Runtime-compiled CUDA kernels: ``CudaModule`` over NVRTC.

Counterpart of the JAX package's ``rtc.py``, whose ``Kernel.launch``
compiles a user-supplied Pallas body with ``pl.pallas_call``; a Pallas
body cannot run on a CUDA card, so this module takes the API that the
JAX module's docstring names as its reference, MXNet's ``CudaModule``
(python/mxnet/rtc.py, src/common/rtc.cc:35-61):

    mod = CudaModule(source, options=(), exports=())
    k = mod.get_kernel("axpy", "const float *x, float *y, float a, int n")
    k.launch([x, y, 2.0, n], ctx, grid_dims, block_dims, shared_mem=0)

``source`` is CUDA C, compiled by NVRTC for ``sm_90a`` when the module
is made (``ops/cuda/_nvrtc.py``). A kernel declared ``extern "C"`` is
found by its name; a template or C++-mangled one by a name expression
listed in ``exports`` (``"axpy<float>"``), which NVRTC lowers to its
mangled name. Compilation happens once per (source, options, exports):
a second module of the same source reuses the cubin, and the cubin is
loaded once per device (the device's primary context).

The signature is the reference's C-style list: each argument is
``[const] type [*] [name]`` with type one of ``float``, ``double``,
``__half``, ``uint8_t``, ``int``, ``int32_t``, ``int8_t``, ``char``,
``int64_t``. A pointer argument takes an NDArray of that type,
contiguous, on the launch's device; a ``const`` pointer is read, any
other is written in place (a CUDA kernel has no ``out_shape``; the
caller allocates its outputs), so a written array may not share memory
with another argument. A scalar is packed as its C type. Every check
runs before the launch. The kernel runs on PyTorch's current stream of
the device, in order with PyTorch's work, and the launch does not
synchronize. Each launch adds one to ``LAUNCHES[name]``.

There is no fallback: CPU arrays, a missing NVRTC, a compile error (with
NVRTC's log) and a launch error (with the driver's message) raise
:class:`MXNetError`.
"""
from __future__ import annotations

import ctypes
import re
import threading

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "LAUNCHES", "reset_launches",
           "parse_signature"]

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {}

# C type -> (numpy dtype, ctypes scalar type)
_CTYPES = {
    "float": (np.float32, ctypes.c_float),
    "double": (np.float64, ctypes.c_double),
    "__half": (np.float16, ctypes.c_uint16),
    "uint8_t": (np.uint8, ctypes.c_uint8),
    "int": (np.int32, ctypes.c_int32),
    "int32_t": (np.int32, ctypes.c_int32),
    "int8_t": (np.int8, ctypes.c_int8),
    "char": (np.int8, ctypes.c_int8),
    "int64_t": (np.int64, ctypes.c_int64),
}
_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")

_lock = threading.Lock()
_CUBINS = {}      # (source, options, exports) -> (cubin, lowered names)
_MODULES = {}     # (cubin key, device) -> CUmodule


def reset_launches():
    """Set every kernel's launch count to 0."""
    LAUNCHES.clear()


def parse_signature(signature):
    """``[(is_const, ctype, is_pointer)]`` of a C-style argument list
    (reference: rtc.py CudaModule.get_kernel)."""
    if not isinstance(signature, str):
        raise MXNetError("signature must be a string")
    args = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(arg)
        if not m or m.group(2) == "const":
            raise MXNetError(
                'invalid kernel argument "%s": must be of the form '
                '"[const] type [*] [name]"' % arg.strip())
        const, ctype, ptr = m.group(1), m.group(2), m.group(3)
        if ctype not in _CTYPES:
            raise MXNetError("unsupported kernel argument type %s; "
                             "supported: %s" % (ctype, ", ".join(_CTYPES)))
        if const and not ptr:
            const = None            # a const scalar is a scalar
        args.append((bool(const), ctype, bool(ptr)))
    return args


class CudaModule(object):
    """CUDA C ``source`` compiled at run time by NVRTC (reference:
    rtc.py CudaModule). ``options`` are further NVRTC options
    (``--use_fast_math``, ``-D...``); ``exports`` the name expressions of
    kernels without ``extern "C"`` linkage (templates among them)."""

    def __init__(self, source, options=(), exports=()):
        from .ops.cuda import _nvrtc
        if not isinstance(source, str):
            raise MXNetError("source must be CUDA C source text")
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        if not all(isinstance(e, str)
                   for e in tuple(options) + tuple(exports)):
            raise MXNetError("options and exports must be strings")
        self.options = tuple(options)
        self.exports = tuple(exports)
        self._key = (source, self.options, self.exports)
        with _lock:
            entry = _CUBINS.get(self._key)
        if entry is None:
            entry = _nvrtc.compile_source(source, self.options, self.exports)
            with _lock:
                _CUBINS[self._key] = entry
        self._lowered = entry[1]

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an ``extern "C"`` name or one of
        ``exports``) with its argument ``signature``."""
        return CudaKernel(self, name, signature)

    def _function(self, lowered, device):
        from .ops.cuda import _nvrtc
        with _lock:
            mod = _MODULES.get((self._key, device))
            if mod is None:
                mod = _nvrtc.load_module(_CUBINS[self._key][0], device)
                _MODULES[(self._key, device)] = mod
        return _nvrtc.get_function(mod, lowered)


class CudaKernel(object):
    """A launchable kernel of a :class:`CudaModule` (reference: rtc.py
    CudaKernel)."""

    def __init__(self, module, name, signature):
        self.name = name
        self.args = parse_signature(signature)
        self._module = module
        self._lowered = module._lowered.get(name, name)
        self._funcs = {}        # device -> (CUfunction, dyn. shared max)

    def _pack(self, args, dev):
        """ctypes values of ``args``, each checked against the
        signature."""
        if len(args) != len(self.args):
            raise MXNetError("%s: %d arguments for a signature of %d"
                             % (self.name, len(args), len(self.args)))
        values, written, read = [], [], []
        for i, (arg, (const, ctype, ptr)) in enumerate(zip(args, self.args)):
            dtype, cscalar = _CTYPES[ctype]
            if not ptr:
                if isinstance(arg, NDArray) or not np.isscalar(arg):
                    raise MXNetError("%s: argument %d is the scalar %s, got "
                                     "%s" % (self.name, i, ctype,
                                             type(arg).__name__))
                v = np.asarray(arg).astype(dtype)
                values.append(cscalar(int(v.view(np.uint16)))
                              if ctype == "__half" else cscalar(v.item()))
                continue
            if not isinstance(arg, NDArray):
                raise MXNetError("%s: argument %d is a %s pointer and takes "
                                 "an NDArray, got %s" % (
                                     self.name, i, ctype,
                                     type(arg).__name__))
            t = arg._data
            if t.device.type != "cuda":
                raise MXNetError(
                    "%s: argument %d lies on %s; rtc launches CUDA kernels "
                    "and needs arrays on a CUDA card" % (self.name, i,
                                                         t.device))
            if t.device != dev:
                raise MXNetError("%s: argument %d is on %s, the launch on %s"
                                 % (self.name, i, t.device, dev))
            if arg.dtype != np.dtype(dtype):
                raise MXNetError("%s: argument %d is %s%s *, got an array of "
                                 "%s" % (self.name, i,
                                         "const " if const else "", ctype,
                                         arg.dtype))
            if not t.is_contiguous():
                raise MXNetError("%s: argument %d must be contiguous"
                                 % (self.name, i))
            span = (t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
            (read if const else written).append((i, span))
            values.append(ctypes.c_void_p(t.data_ptr()))
        for i, (lo, hi) in written:
            for j, (lo2, hi2) in written + read:
                if j != i and lo < hi2 and lo2 < hi:
                    raise MXNetError(
                        "%s: argument %d is written (not const) and shares "
                        "memory with argument %d" % (self.name, i, j))
        return values

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a CUDA device) with ``grid_dims`` and
        ``block_dims`` (3-tuples) and ``shared_mem`` bytes of dynamic
        shared memory, on PyTorch's current stream of that device."""
        from .ops.cuda import _nvrtc
        dev = torch.device(ctx)
        if dev.type != "cuda":
            raise MXNetError("%s: rtc launches CUDA kernels and needs a "
                             "CUDA card (ctx %s)" % (self.name, dev))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        grid, block = tuple(grid_dims), tuple(block_dims)
        if len(grid) != 3 or len(block) != 3:
            raise MXNetError("%s: grid_dims and block_dims must be 3-tuples"
                             % self.name)
        values = self._pack(args, dev)
        fn, shared_max = self._funcs.get(dev.index, (None, 48 << 10))
        if fn is None:
            fn = self._module._function(self._lowered, dev.index)
        if shared_mem > shared_max:
            _nvrtc.set_max_dynamic_shared(fn, shared_mem)
            shared_max = shared_mem
        self._funcs[dev.index] = (fn, shared_max)
        params = (ctypes.c_void_p * len(values))(
            *[ctypes.cast(ctypes.byref(v), ctypes.c_void_p) for v in values])
        stream = torch.cuda.current_stream(dev).cuda_stream
        _nvrtc.launch(fn, dev.index, grid, block, int(shared_mem),
                      ctypes.c_void_p(stream), params)
        LAUNCHES[self.name] = LAUNCHES.get(self.name, 0) + 1
