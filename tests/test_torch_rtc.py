"""``rtc``: runtime-compiled CUDA kernels (``CudaModule`` over NVRTC).

On the CPU: the signature parser over the reference's C types
(``const``, pointer spacing, bad strings), the argument checks a launch
makes before it touches the driver (count, scalar vs array, dtype,
contiguity, device, a written array that shares memory with another
argument), the ``exports`` names resolved through NVRTC's lowered names,
``MXNetError`` for arrays on the CPU and for a missing ``libnvrtc``, and
that importing the package opens no CUDA library. The launch itself
needs a card and NVRTC: it is tested in ``test_torch_cuda.py`` and
``chip_smoke.py`` (phases 19-21), and by the ``cuda``-marked test here.
"""
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.cuda import _nvrtc

AXPY = """
extern "C" __global__ void axpy(const float *x, float *y, float a, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] += a * x[i];
}
"""


@pytest.mark.parametrize("sig,want", [
    ("const float *x, float *y, float a, int n",
     [(True, "float", True), (False, "float", True), (False, "float", False),
      (False, "int", False)]),
    ("const float* x,float*y", [(True, "float", True),
                                (False, "float", True)]),
    ("const  __half  *  a, double b, int64_t", [
        (True, "__half", True), (False, "double", False),
        (False, "int64_t", False)]),
    ("uint8_t *m, int8_t *q, char *c, int32_t k",
     [(False, "uint8_t", True), (False, "int8_t", True),
      (False, "char", True), (False, "int32_t", False)]),
    ("const int n", [(False, "int", False)]),      # a const scalar
])
def test_signature_parser(sig, want):
    assert rtc.parse_signature(sig) == want


@pytest.mark.parametrize("sig", [
    "const *x", "float x y", "long *x", "const const float *x",
    "float **x", "float *x,", "", "unsigned int n"])
def test_signature_parser_refuses(sig):
    with pytest.raises(MXNetError):
        rtc.parse_signature(sig)


def _kernel(sig="const float *x, float *y, float a, int n"):
    """A kernel of a module that was never compiled: every check below
    raises before the launch reaches the module or the driver."""
    return rtc.CudaKernel(types.SimpleNamespace(_lowered={}), "axpy", sig)


def _cpu(shape=(8,), dtype=np.float32):
    return tmx.nd.array(np.zeros(shape, dtype), ctx=tmx.cpu(), dtype=dtype)


def test_cpu_arrays_raise_naming_the_card():
    k = _kernel()
    before = dict(rtc.LAUNCHES)
    with pytest.raises(MXNetError, match="needs arrays on a CUDA card"):
        k._pack([_cpu(), _cpu(), 2.0, 8], torch.device("cuda", 0))
    with pytest.raises(MXNetError, match="needs a CUDA card"):
        k.launch([_cpu(), _cpu(), 2.0, 8], tmx.cpu(), (1, 1, 1),
                 (8, 1, 1))
    assert rtc.LAUNCHES == before


class _FakeTensor(object):
    """Just enough of a CUDA tensor for the argument checks."""

    def __init__(self, n, dtype=torch.float32, ptr=1 << 20, contiguous=True,
                 device="cuda:0"):
        self.device = torch.device(device)
        self.dtype = dtype
        self._n, self._ptr, self._c = n, ptr, contiguous
        self.shape = (n,)

    def data_ptr(self):
        return self._ptr

    def numel(self):
        return self._n

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()

    def is_contiguous(self):
        return self._c


def _fake(n=8, **kw):
    arr = tmx.nd.NDArray.__new__(tmx.nd.NDArray)
    arr._data = _FakeTensor(n, **kw)
    arr._grad = arr._grad_req = None
    return arr


CUDA0 = torch.device("cuda", 0)


def test_arguments_are_packed_as_their_c_types():
    k = _kernel("const float *x, float *y, float a, int n, __half h, "
                "int8_t c, int64_t big, double d")
    vals = k._pack([_fake(ptr=4096), _fake(ptr=8192), 2.5, 7, 1.5, -3,
                    1 << 40, 0.25], CUDA0)
    assert [v.value for v in vals[:2]] == [4096, 8192]
    assert vals[2].value == 2.5 and vals[3].value == 7
    assert vals[4].value == int(np.float16(1.5).view(np.uint16))
    assert vals[5].value == -3 and vals[6].value == 1 << 40
    assert vals[7].value == 0.25


@pytest.mark.parametrize("args,match", [
    ([_fake(), _fake(ptr=8192), 2.0], "3 arguments"),
    ([_fake(), _fake(ptr=8192), _fake(ptr=1 << 24), 8], "scalar float"),
    ([2.0, _fake(ptr=8192), 2.0, 8], "takes an NDArray"),
    ([_fake(dtype=torch.float64), _fake(ptr=8192), 2.0, 8],
     "const float \\*, got an array of float64"),
    ([_fake(), _fake(ptr=8192, dtype=torch.int32), 2.0, 8],
     "float \\*, got an array of int32"),
    ([_fake(), _fake(ptr=8192, contiguous=False), 2.0, 8], "contiguous"),
    ([_fake(), _fake(ptr=8192, device="cuda:1"), 2.0, 8], "is on cuda:1"),
    # the written y overlaps the read x: a "const" violation
    ([_fake(ptr=4096), _fake(ptr=4096 + 16), 2.0, 8],
     "written \\(not const\\) and shares memory"),
])
def test_argument_checks(args, match):
    with pytest.raises(MXNetError, match=match):
        _kernel()._pack(args, CUDA0)


def test_exports_resolve_through_lowered_names(monkeypatch):
    calls = []

    def fake_compile(source, options, exports):
        calls.append((source, options, exports))
        return b"cubin", {"axpy<float>": "_Z4axpyIfEvPKT_PS0_S0_i"}

    monkeypatch.setattr(_nvrtc, "compile_source", fake_compile)
    monkeypatch.setattr(rtc, "_CUBINS", {})
    mod = rtc.CudaModule("template <typename T> __global__ void axpy();",
                         options=["--use_fast_math"],
                         exports=["axpy<float>"])
    assert mod.exports == ("axpy<float>",)
    k = mod.get_kernel("axpy<float>", "const float *x, float *y")
    assert k._lowered == "_Z4axpyIfEvPKT_PS0_S0_i"
    assert mod.get_kernel("plain", "int n")._lowered == "plain"
    rtc.CudaModule("template <typename T> __global__ void axpy();",
                   options=["--use_fast_math"], exports=["axpy<float>"])
    assert len(calls) == 1          # once per (source, options, exports)
    with pytest.raises(MXNetError, match="strings"):
        rtc.CudaModule("", exports=[3])


def test_missing_nvrtc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(sys, "path", [str(tmp_path)])
    monkeypatch.setattr(_nvrtc, "_LIBS", {})
    monkeypatch.setattr(rtc, "_CUBINS", {})
    with pytest.raises(MXNetError, match="libnvrtc not found"):
        rtc.CudaModule(AXPY)


def test_import_opens_no_cuda_library():
    code = ("import mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch.ops.cuda import _nvrtc\n"
            "print(sorted(_nvrtc._LIBS), len(mx.rtc._CUBINS))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[] 0"


@pytest.mark.cuda
def test_axpy_launch_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and NVRTC (a runtime-compiled "
                    "CUDA kernel has no CPU mode)")
    n = 1000
    x = tmx.nd.array(np.arange(n, dtype=np.float32), ctx=tmx.gpu(0))
    y = tmx.nd.array(np.ones(n, np.float32), ctx=tmx.gpu(0))
    want = y._data.clone().add_(x._data, alpha=2.0)
    k = rtc.CudaModule(AXPY).get_kernel(
        "axpy", "const float *x, float *y, float a, int n")
    k.launch([x, y, 2.0, n], tmx.gpu(0), (4, 1, 1), (256, 1, 1))
    torch.testing.assert_close(y._data, want, rtol=1e-6, atol=0)
