"""Contracts of the PyTorch/CUDA package (mxnet_tpu_torch).

* no file of the package, and not chip_smoke.py or the port's tools
  (``tools/torch_*.py``), imports ``jax`` or the JAX package
  ``mxnet_tpu`` (AST scan);
* importing the package pulls in neither ``mxnet_tpu`` nor ``triton``
  and builds or loads no CUDA library: no kernel library, and neither
  ``libnvrtc`` nor ``libcuda`` through ``rtc``'s bindings (checked in a
  fresh interpreter);
* every header under ``ops/cuda/csrc`` is hashed into every kernel
  library's file name (``_build._HEADERS``), so an edit of any header
  rebuilds;
* every ``CUDA_KERNELS`` entry of every kernel module under
  ``ops/cuda`` has its ``csrc/<source>.cu`` (the kernel's name, or the
  module's ``SOURCE`` where one file holds several kernels), a plain
  PyTorch version in the same module, a launch counter, and a CPU test
  that names both;
* ``chip_smoke.py`` on a machine without a CUDA device, or alone in a
  directory, exits non-zero and never prints its ``"ok": true`` line.
"""
import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

from mxnet_tpu_torch.ops import cuda
from mxnet_tpu_torch.ops.cuda import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")
FORBIDDEN = ("jax", "mxnet_tpu")


def _port_files():
    files = sorted(glob.glob(os.path.join(PKG, "**", "*.py"),
                             recursive=True))
    return files + [os.path.join(ROOT, "chip_smoke.py")] + sorted(
        glob.glob(os.path.join(ROOT, "tools", "torch_*.py")))


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_never_imports_jax_or_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, "%s imports %s" % (os.path.relpath(path, ROOT), bad)


def test_import_pulls_in_no_jax_package_triton_or_cuda_library():
    code = ("import sys, mxnet_tpu_torch\n"
            "from mxnet_tpu_torch.ops.cuda import _build, _nvrtc\n"
            "print(sorted(m for m in ('mxnet_tpu', 'triton') "
            "if m in sys.modules), len(_build._loaded), "
            "sorted(_nvrtc._LIBS))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # neither libnvrtc nor libcuda is opened by rtc's bindings
    assert out.stdout.split("\n")[-2] == "[] 0 []"


def test_every_header_is_in_the_build_hash():
    headers = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(_build.CSRC, "*.cuh")))
    assert headers and sorted(_build._HEADERS) == headers


# (module, kernel) for every CUDA_KERNELS registry of the port
KERNELS = [(mod, k) for mod in cuda.KERNEL_MODULES
           for k in sorted(mod.CUDA_KERNELS)]


def test_every_kernel_registry_is_checked():
    """Each module under ops/cuda that defines a CUDA_KERNELS registry is
    in ops.cuda.KERNEL_MODULES, so the check below sees its kernels."""
    listed = {m.__name__.rsplit(".", 1)[1] for m in cuda.KERNEL_MODULES}
    for path in glob.glob(os.path.join(PKG, "ops", "cuda", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        names = {t.id for node in tree.body if isinstance(node, ast.Assign)
                 for t in node.targets if isinstance(t, ast.Name)}
        if "CUDA_KERNELS" in names:
            assert os.path.basename(path)[:-3] in listed, path


@pytest.mark.parametrize("mod,kernel", KERNELS, ids=[k for _, k in KERNELS])
def test_every_cuda_kernel_has_source_plain_version_and_cpu_test(mod,
                                                                 kernel):
    plain = mod.CUDA_KERNELS[kernel]
    source = getattr(mod, "SOURCE", kernel)     # one .cu may hold several
    assert _build.SOURCES[source] == source + ".cu"
    assert os.path.exists(os.path.join(_build.CSRC, source + ".cu"))
    assert callable(getattr(mod, kernel))
    assert callable(getattr(mod, plain))
    assert kernel in mod.LAUNCHES
    here = os.path.abspath(__file__)
    naming = [p for p in glob.glob(os.path.join(ROOT, "tests",
                                                "test_torch_*.py"))
              if os.path.abspath(p) != here
              and kernel in open(p).read() and plain in open(p).read()]
    assert naming, "no CPU test names both %s and %s" % (kernel, plain)


def _assert_smoke_fails(cwd, script):
    out = subprocess.run([sys.executable, script], cwd=cwd,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_a_card():
    _assert_smoke_fails(ROOT, "chip_smoke.py")


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    _assert_smoke_fails(str(tmp_path), "chip_smoke.py")
