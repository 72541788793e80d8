"""Build and load the package's native (C++) components at first use.

The sources under ``mxnet_tpu_torch/native/`` compile with ``g++`` into
shared libraries under ``build/mxnet_tpu_torch_native/`` at the
repository root and load with :mod:`ctypes` (a flat C ABI):

* ``recordio``: the RecordIO reader and writer (``native/recordio.cc``);
* ``imageplan``: the image pipeline's per-image crop and mirror
  decisions (``native/imagedec.cc`` without OpenCV), which the nvJPEG
  backend uses;
* ``imagedec_opencv``: the OpenCV backend of the image decode pool
  (``native/imagedec.cc`` with ``-DMXT_IMGDEC_OPENCV``).

A library's file name carries a hash of its source and flags, so an
edited source rebuilds. A build that fails raises :class:`MXNetError`
with the compiler's output; nothing falls back to another route.
Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from .base import MXNetError

__all__ = ["load", "recordio_lib", "imageplan_lib", "imagedec_lib",
           "opencv_include", "BUILD_DIR"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "native")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build",
                         "mxnet_tpu_torch_native")
# where the OpenCV backend looks for OpenCV's C++ headers
OPENCV_INCLUDE = "/usr/include/opencv4"

_lock = threading.Lock()
_loaded = {}
_BASE_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def _library_path(name, source, flags):
    h = hashlib.sha256()
    with open(os.path.join(SRC, source), "rb") as f:
        h.update(f.read())
    h.update("\0".join(_BASE_FLAGS + tuple(flags)).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, h.hexdigest()[:16]))


def load(name, source, flags=()):
    """The ``ctypes.CDLL`` of ``native/<source>`` built as ``name`` with
    ``flags``, compiled on first use. Raises :class:`MXNetError` carrying
    g++'s output when the build fails."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = _library_path(name, source, flags)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = "%s.tmp.%d" % (path, os.getpid())
            cmd = (["g++"] + list(_BASE_FLAGS) + ["-o", tmp,
                                                  os.path.join(SRC, source)]
                   + list(flags))
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise MXNetError("cannot build native %s: %s" % (name, e))
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise MXNetError("native %s failed to build (g++ exit %d):\n"
                                 "%s\n%s" % (name, proc.returncode,
                                             " ".join(cmd),
                                             proc.stdout + proc.stderr))
            os.replace(tmp, path)   # atomic: a reader never sees half
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
        return lib


def _typed(lib, table):
    for sym, (restype, argtypes) in table.items():
        fn = getattr(lib, sym)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def recordio_lib():
    lib = load("recordio", "recordio.cc")
    return _typed(lib, {
        "rio_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int]),
        "rio_close": (None, [ctypes.c_void_p]),
        "rio_write": (ctypes.c_longlong, [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_uint64]),
        "rio_read": (ctypes.c_int, [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_uint64)]),
        "rio_seek": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_uint64]),
        "rio_tell": (ctypes.c_longlong, [ctypes.c_void_p]),
        "rio_free": (None, [ctypes.c_void_p])})


_PLAN_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64,
              ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p]


def imageplan_lib():
    """The per-image crop / mirror plan alone (no OpenCV)."""
    return _typed(load("imageplan", "imagedec.cc"),
                  {"imgdec_plan": (ctypes.c_int, _PLAN_ARGS)})


def opencv_include():
    """OpenCV's C++ include directory, or None where it is missing."""
    hdr = os.path.join(OPENCV_INCLUDE, "opencv2", "core.hpp")
    return OPENCV_INCLUDE if os.path.exists(hdr) else None


def imagedec_lib():
    """The OpenCV decode pool. Raises :class:`MXNetError` where OpenCV's
    C++ headers or libraries are missing."""
    inc = opencv_include()
    if inc is None:
        raise MXNetError("the OpenCV image decoder needs OpenCV's C++ "
                         "headers (%s)" % OPENCV_INCLUDE)
    lib = load("imagedec_opencv", "imagedec.cc", flags=(
        "-DMXT_IMGDEC_OPENCV", "-I" + inc, "-pthread", "-lopencv_core",
        "-lopencv_imgcodecs", "-lopencv_imgproc"))
    f = ctypes.POINTER(ctypes.c_float)
    return _typed(lib, {
        "imgdec_create": (ctypes.c_void_p, [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, f, f,
            ctypes.c_uint64]),
        "imgdec_decode_batch": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p]),
        "imgdec_last_error": (ctypes.c_char_p, [ctypes.c_void_p]),
        "imgdec_destroy": (None, [ctypes.c_void_p]),
        "imgdec_plan": (ctypes.c_int, _PLAN_ARGS)})
