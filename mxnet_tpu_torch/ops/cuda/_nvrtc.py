"""NVRTC and the CUDA driver, bound with ctypes, for ``rtc``.

Two libraries, each opened on first use and never at import:

* ``libnvrtc``: compiles CUDA C source to a cubin for ``sm_90a``
  (``nvrtcCreateProgram``, ``nvrtcAddNameExpression`` for the exported
  names, ``nvrtcCompileProgram``, ``nvrtcGetProgramLog``,
  ``nvrtcGetCUBIN``, ``nvrtcGetLoweredName``). It is looked for in
  ``$CUDA_HOME/lib64`` (default ``/usr/local/cuda``, where ``_build``
  finds ``nvcc``), then in the ``nvidia/cuda_nvrtc/lib`` directory that
  PyTorch's CUDA wheels install.
* ``libcuda.so.1``, the driver: loads a cubin into the device's primary
  context (``cuModuleLoadData``), finds a function
  (``cuModuleGetFunction``), raises its dynamic shared memory limit
  (``cuFuncSetAttribute``) and launches it (``cuLaunchKernel``).

PyTorch's runtime makes the primary context current only on threads that
have used CUDA, so :func:`set_context` retains the device's primary
context once (``cuDevicePrimaryCtxRetain``) and makes it current
(``cuCtxSetCurrent``) before every module load and launch: a launch from
any thread runs in the context PyTorch's tensors live in.

Every failure raises :class:`MXNetError`: a missing library, a compile
error (with NVRTC's log), a driver error (with ``cuGetErrorString``).
"""
from __future__ import annotations

import ctypes
import glob
import os
import sys
import threading

from ...base import MXNetError

__all__ = ["ARCH", "compile_source", "load_module", "get_function",
           "set_context", "launch", "set_max_dynamic_shared"]

ARCH = "sm_90a"
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8
_lock = threading.Lock()
_LIBS = {}        # "nvrtc" / "cuda" -> ctypes.CDLL, once opened
_CONTEXTS = {}    # device ordinal -> CUcontext


def _cuda_home():
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def nvrtc_candidates():
    """Paths where ``libnvrtc`` is looked for, in order."""
    dirs = [os.path.join(_cuda_home(), "lib64")]
    dirs += [os.path.join(p, "nvidia", "cuda_nvrtc", "lib")
             for p in sys.path if p and os.path.isdir(p)]
    found = []
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "libnvrtc.so*"))):
            if "builtins" not in os.path.basename(path):
                found.append(path)
    return found


def _nvrtc():
    with _lock:
        lib = _LIBS.get("nvrtc")
        if lib is not None:
            return lib
        paths = nvrtc_candidates()
        if not paths:
            raise MXNetError(
                "rtc: libnvrtc not found in %s/lib64 or in PyTorch's "
                "nvidia/cuda_nvrtc/lib (set CUDA_HOME); runtime compilation "
                "needs the CUDA toolkit's NVRTC" % _cuda_home())
        lib = ctypes.CDLL(paths[0])
        for name, args in (
                ("nvrtcCreateProgram", [_P, ctypes.c_char_p,
                                        ctypes.c_char_p, _I, _P, _P]),
                ("nvrtcAddNameExpression", [_P, ctypes.c_char_p]),
                ("nvrtcCompileProgram", [_P, _I, _P]),
                ("nvrtcGetProgramLogSize", [_P, _P]),
                ("nvrtcGetProgramLog", [_P, ctypes.c_char_p]),
                ("nvrtcGetCUBINSize", [_P, _P]),
                ("nvrtcGetCUBIN", [_P, ctypes.c_char_p]),
                ("nvrtcGetLoweredName", [_P, ctypes.c_char_p, _P]),
                ("nvrtcDestroyProgram", [_P])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, _I
        lib.nvrtcGetErrorString.argtypes = [_I]
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        _LIBS["nvrtc"] = lib
        return lib


def _driver():
    with _lock:
        lib = _LIBS.get("cuda")
        if lib is not None:
            return lib
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise MXNetError("rtc: the CUDA driver (libcuda.so.1) cannot be "
                             "loaded: %s" % e) from None
        for name, args in (
                ("cuInit", [_U]),
                ("cuDeviceGet", [_P, _I]),
                ("cuDevicePrimaryCtxRetain", [_P, _I]),
                ("cuCtxSetCurrent", [_P]),
                ("cuModuleLoadData", [_P, ctypes.c_char_p]),
                ("cuModuleGetFunction", [_P, _P, ctypes.c_char_p]),
                ("cuFuncSetAttribute", [_P, _I, _I]),
                ("cuLaunchKernel", [_P, _U, _U, _U, _U, _U, _U, _U, _P, _P,
                                    _P]),
                ("cuGetErrorString", [_I, _P])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, _I
        _check(lib, lib.cuInit(0), "cuInit")
        _LIBS["cuda"] = lib
        return lib


def _check(lib, rc, what):
    if rc != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(rc, ctypes.byref(msg))
        raise MXNetError("rtc: %s failed: CUDA error %d (%s)" % (
            what, rc, (msg.value or b"unknown").decode()))


def _nvrtc_check(lib, rc, what):
    if rc != 0:
        raise MXNetError("rtc: %s failed: %s" % (
            what, lib.nvrtcGetErrorString(rc).decode()))


def compile_source(source, options=(), exports=(), name="rtc.cu"):
    """Compile CUDA C ``source`` with NVRTC for ``sm_90a``; returns
    ``(cubin bytes, {exported name: lowered name})``. Raises
    :class:`MXNetError` carrying NVRTC's log when compilation fails."""
    lib = _nvrtc()
    prog = _P()
    _nvrtc_check(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), name.encode(), 0, None, None),
        "nvrtcCreateProgram")
    try:
        for e in exports:
            _nvrtc_check(lib, lib.nvrtcAddNameExpression(prog, e.encode()),
                         "nvrtcAddNameExpression(%r)" % e)
        opts = ["--gpu-architecture=%s" % ARCH,
                "-I%s" % os.path.join(_cuda_home(), "include")]
        opts += list(options)
        arr = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        rc = lib.nvrtcCompileProgram(prog, len(opts), arr)
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetProgramLog(prog, log)
        if rc != 0:
            raise MXNetError("rtc: compilation failed (%s), options %s:\n%s"
                             % (lib.nvrtcGetErrorString(rc).decode(), opts,
                                log.value.decode(errors="replace")))
        lib.nvrtcGetCUBINSize(prog, ctypes.byref(size))
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for e in exports:
            ptr = ctypes.c_char_p()
            _nvrtc_check(lib, lib.nvrtcGetLoweredName(
                prog, e.encode(), ctypes.byref(ptr)),
                "nvrtcGetLoweredName(%r)" % e)
            lowered[e] = ptr.value.decode()
        return cubin.raw, lowered
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def set_context(device):
    """Make ``device``'s primary context current on this thread."""
    lib = _driver()
    ctx = _CONTEXTS.get(device)
    if ctx is None:
        dev = _I()
        _check(lib, lib.cuDeviceGet(ctypes.byref(dev), device),
               "cuDeviceGet(%d)" % device)
        ctx = _P()
        _check(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
               "cuDevicePrimaryCtxRetain")
        _CONTEXTS[device] = ctx
    _check(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def load_module(cubin, device):
    """A CUmodule of ``cubin`` in ``device``'s primary context."""
    set_context(device)
    lib = _driver()
    mod = _P()
    _check(lib, lib.cuModuleLoadData(ctypes.byref(mod), cubin),
           "cuModuleLoadData")
    return mod


def get_function(module, name):
    lib = _driver()
    fn = _P()
    _check(lib, lib.cuModuleGetFunction(ctypes.byref(fn), module,
                                        name.encode()),
           "cuModuleGetFunction(%r)" % name)
    return fn


def set_max_dynamic_shared(fn, nbytes):
    lib = _driver()
    _check(lib, lib.cuFuncSetAttribute(
        fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES, nbytes),
        "cuFuncSetAttribute(max dynamic shared memory %d)" % nbytes)


def launch(fn, device, grid, block, shared_mem, stream, params):
    """``cuLaunchKernel`` on ``stream`` (a ``CUstream`` handle), the
    device's primary context made current first; ``params`` a ctypes
    array of pointers to each argument's value."""
    set_context(device)
    lib = _driver()
    _check(lib, lib.cuLaunchKernel(
        fn, grid[0], grid[1], grid[2], block[0], block[1], block[2],
        shared_mem, stream, params, None), "cuLaunchKernel")
