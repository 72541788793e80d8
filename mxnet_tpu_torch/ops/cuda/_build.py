"""Build and load the hand-written CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under
``build/mxnet_tpu_torch_kernels/`` at the repository root, and loads
with :mod:`ctypes`. A library's file name carries a hash of its sources
and the flags, so an edited source rebuilds and an unchanged one loads
from the previous build. :func:`build_all` starts one ``nvcc`` per
source at once and waits for all of them.

Nothing here runs at import: importing this module neither looks for
``nvcc`` nor touches the GPU.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ...base import MXNetError

__all__ = ["SOURCES", "LINK", "NVCC_FLAGS", "BUILD_DIR", "build_all", "load",
           "library_path", "on_device"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
# the repository root holds mxnet_tpu_torch/, which holds ops/cuda/
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_HERE))),
    "build", "mxnet_tpu_torch_kernels")

# kernel name -> its translation unit; the attention and update units
# include common.cuh (the bf16 flash attention units also hopper.cuh),
# the int8 units common.cuh, int8_gemm.cuh and int8_wgmma.cuh (which
# includes hopper.cuh). Every header of csrc/ is in _HEADERS, so that an
# edit of any of them rebuilds every library.
SOURCES = {
    "paged_decode_attention": "paged_decode_attention.cu",
    "flash_prefill_paged": "flash_prefill_paged.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "fused_update": "fused_update.cu",
    "int8_matmul": "int8_matmul.cu",
    "int8_conv_im2col": "int8_conv_im2col.cu",
    "batch_norm_inference": "batch_norm_inference.cu",
    "image_decode": "image_decode.cu",
}
# libraries a kernel library links beyond the CUDA runtime (image_decode:
# the CUDA toolkit's nvJPEG, preloaded by its module before the load)
LINK = {"image_decode": ("-lnvjpeg",)}
_HEADERS = ("common.cuh", "hopper.cuh", "int8_gemm.cuh", "int8_wgmma.cuh")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded = {}      # name -> ctypes.CDLL


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise MXNetError("nvcc not found (set CUDA_HOME or put nvcc on "
                         "PATH); the CUDA kernels build from source")
    return path


def library_path(name):
    """Path of ``name``'s library for the current sources and flags."""
    h = hashlib.sha256()
    for fname in (SOURCES[name],) + _HEADERS:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    h.update("\0".join(NVCC_FLAGS + LINK.get(name, ())).encode())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:16]))


def build_all(names=None):
    """Compile every kernel library that is missing, one ``nvcc`` per
    source, all started together. Returns {name: nvcc output} for the
    libraries built by this call. Raises :class:`MXNetError` carrying
    nvcc's stderr when a build fails."""
    names = list(SOURCES if names is None else names)
    todo = [(n, library_path(n)) for n in names
            if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    try:
        for name, path in todo:
            tmp = "%s.tmp.%d" % (path, os.getpid())
            cmd = [nvcc] + list(NVCC_FLAGS) + [
                "-I", CSRC, "-o", tmp, os.path.join(CSRC, SOURCES[name])
            ] + list(LINK.get(name, ()))
            procs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed, logs = [], {}
        for name, path, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append("%s (nvcc exit %d):\n%s"
                              % (name, proc.returncode, out))
                continue
            os.replace(tmp, path)   # atomic: a reader never sees half
            logs[name] = out
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise MXNetError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def load(name, symbols):
    """The ``ctypes.CDLL`` of kernel ``name``, built on first use.

    ``symbols`` maps each exported C function to its ``argtypes``; every
    one returns an ``int`` cudaError_t."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = ctypes.CDLL(path)
            for sym, argtypes in symbols.items():
                fn = getattr(lib, sym)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def on_device(device):
    """``torch.cuda.device(device)`` for a launch, or nothing where that
    device is current already (entering the guard costs host
    microseconds a launch). A kernel library's runtime launches on the
    calling thread's current device."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
