#!/usr/bin/env python3
"""Time the int8 kernels of this checkout against those of another
checkout on one NVIDIA card, in one process.

    python3 tools/torch_int8_ab.py OTHER_ROOT [--iters 30] [--report PATH]

OTHER_ROOT is the root of another checkout of the repository, for
example the parent commit unpacked by ``git archive`` into a directory
that ``.gitignore`` lists. Its ``int8_matmul.cu`` and
``int8_conv_im2col.cu`` are built with this checkout's nvcc flags and
called through their C entry points ``int8_matmul`` and
``int8_conv_im2col`` (contiguous NCHW / OIHW operands, as that design
takes them); this checkout's kernels run through its wrappers, on the
operands quantized serving gives them (the conv's in channels-last
memory), so each takes the route it takes in serving. Both run on the
same seeded inputs at ResNet-50's batch-32 shapes: the FC (32 x 2048 x
1000) and every distinct convolution, each weighed by its count in a
forward (53 convs):

* each version's output against the plain version, bitwise;
* ms by CUDA events with the L2 flushed and a 0.5 ms device-side hold
  before every launch (``chip_smoke.Timer``), in turns: other, this,
  this, other, per shape; the conv summed over the forward;
* the yardsticks in the same process: ``torch._int_mm`` + the scale at
  the FC, and ``torch._int_mm`` over prebuilt patch matrices for the 52
  convs it takes (K and N multiples of 8: all but the stem), twice;
* the host microseconds a call of each version's Python wrapper takes
  (the FC, and a 3x3 conv at 56 x 56 with the operands each version
  serves: NCHW for the other, channels-last for this), each measured in
  a child process of its own checkout, in turns other, this, this,
  other.

Prints the card line, a line per shape, and one JSON line; exits
non-zero without a card.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("int8_matmul", "int8_conv_im2col")
TURNS = ("other", "this", "this", "other")


def build_other(other, out_dir, nvcc, flags):
    """Compile the other checkout's two int8 sources; {name: path}."""
    csrc = os.path.join(other, "mxnet_tpu_torch", "ops", "cuda", "csrc")
    os.makedirs(out_dir, exist_ok=True)
    procs, libs = [], {}
    for name in NAMES:
        path = os.path.join(out_dir, name + ".so")
        cmd = [nvcc] + list(flags) + ["-I", csrc, "-o", path,
                                      os.path.join(csrc, name + ".cu")]
        procs.append((name, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for name, path, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("building the other %s failed:\n%s"
                               % (name, out))
        libs[name] = path
    return libs


# run in a child process with one checkout's root first on sys.path:
# host microseconds of its wrappers, as JSON on the last line
HOST_PROBE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from mxnet_tpu_torch.ops.cuda import int8_matmul as i8


def host_us(fn, n=1000, reps=3):
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        best = t if best is None else min(best, t)
    return best


rng = np.random.RandomState(0)
dev = torch.device("cuda")


def i8s(*shape):
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(
        np.int8)).to(dev)


x, w, s = i8s(32, 2048), i8s(1000, 2048), torch.ones(1000, device=dev)
q, wq = i8s(32, 64, 56, 56), i8s(64, 64, 3, 3)
if sys.argv[2] == "this":
    q = q.contiguous(memory_format=torch.channels_last)
    wq = wq.contiguous(memory_format=torch.channels_last)
cs_ = torch.ones(64, device=dev)
a = ((1, 1), (1, 1), (1, 1), 1)
print(json.dumps({"int8_matmul": host_us(lambda: i8.int8_matmul(x, w, s)),
                  "int8_conv_im2col": host_us(lambda: i8.int8_conv_im2col(
                      q, wq, cs_, *a))}))
"""


def host_us(root, version):
    """{wrapper: host us a call} of the checkout at ``root``, measured in
    a child process: the least of 3 runs of 1000 calls enqueued back to
    back, the synchronise outside the clock (as ``chip_smoke.host_us``)."""
    out = subprocess.run([sys.executable, "-c", HOST_PROBE, root, version],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError("host probe of %s failed:\n%s" % (root,
                                                             out.stderr))
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--report", help="also write the JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_int8_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda import _build
    from mxnet_tpu_torch.ops.cuda import int8_matmul as i8

    card = cs.card_line()
    print(card, flush=True)
    _build.build_all(list(NAMES))
    paths = build_other(os.path.abspath(args.other),
                        os.path.join(_build.BUILD_DIR,
                                     "ab_int8_other_%d" % os.getpid()),
                        _build._nvcc(), _build.NVCC_FLAGS)
    other = {}
    for name, path in paths.items():
        fn = getattr(ctypes.CDLL(path), name)
        fn.argtypes = i8._SYMBOLS[name][name]
        fn.restype = ctypes.c_int
        other[name] = fn
    dev = torch.device("cuda")

    def other_matmul(x, w, s):
        out = torch.empty((x.shape[0], w.shape[0]), dtype=torch.float32,
                          device=dev)
        err = other["int8_matmul"](
            x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
            x.shape[0], w.shape[0], x.shape[1],
            torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, "other int8_matmul launch failed (%d)" % err)
        return out

    def other_conv(q, wq, s, stride, dilate, pad, groups):
        b, c, h, w = q.shape
        co, _, kh, kw = wq.shape
        oh = i8.conv_out_size(h, kh, stride[0], dilate[0], pad[0])
        ow = i8.conv_out_size(w, kw, stride[1], dilate[1], pad[1])
        out = torch.empty((b, co, oh, ow), dtype=torch.float32, device=dev)
        err = other["int8_conv_im2col"](
            q.data_ptr(), wq.data_ptr(), s.data_ptr(), out.data_ptr(), b, c,
            h, w, co, groups, kh, kw, stride[0], stride[1], pad[0], pad[1],
            dilate[0], dilate[1], oh, ow,
            torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, "other int8_conv_im2col launch failed (%d)" % err)
        return out

    timer = cs.Timer(torch)

    def t(fn):
        return timer(fn, iters=args.iters, hold_ms=0.5)

    rng = np.random.RandomState(16)
    result = {"card": card, "turns": list(TURNS), "fc": {}, "convs": [],
              "conv_sum_ms": {"other": [0.0, 0.0], "this": [0.0, 0.0]},
              "int_mm_patch_sum_ms": [0.0, 0.0], "int_mm_patch_convs": 0}
    # the FC
    x = torch.from_numpy(rng.randint(-127, 128, (cs.SERVE_BATCH, 2048))
                         .astype(np.int8)).to(dev)
    w = torch.from_numpy(rng.randint(-127, 128, (1000, 2048)).astype(
        np.int8)).to(dev)
    s = torch.from_numpy(rng.rand(1000).astype(np.float32) * 0.1).to(dev)
    ref = i8._int8_matmul_plain(x, w, s)
    fns = {"other": lambda: other_matmul(x, w, s),
           "this": lambda: i8.int8_matmul(x, w, s)}
    fc = result["fc"] = {
        "shape": [cs.SERVE_BATCH, 2048, 1000],
        "route": i8.matmul_route(cs.SERVE_BATCH, 1000, 2048)[0],
        "bitwise": {v: bool(torch.equal(fn(), ref))
                    for v, fn in fns.items()},
        "ms": [], "int_mm_ms": []}
    for v in TURNS:
        fc["ms"].append(t(fns[v]))
    for _ in range(2):
        fc["int_mm_ms"].append(t(lambda: torch._int_mm(x, w.t()).float()
                                 * s[None, :]))
    print("fc %s: other/this/this/other %s ms; _int_mm + scale %s ms; "
          "bitwise %s" % (fc["route"], " ".join("%.4f" % m for m in fc["ms"]),
                          " ".join("%.4f" % m for m in fc["int_mm_ms"]),
                          fc["bitwise"]), flush=True)
    # the convolutions
    for key, count in cs.distinct_rows(cs.int8_conv_layers(
            mx, cs.SERVE_BATCH)):
        q0, wq0, s = cs.int8_inputs(torch, rng, key, dev)
        q = q0.contiguous(memory_format=torch.channels_last)
        wq = wq0.contiguous(memory_format=torch.channels_last)
        a = key[2:]
        ref = i8._int8_conv_plain(q0, wq0, s, *a)
        fns = {"other": lambda: other_conv(q0, wq0, s, *a),
               "this": lambda: i8.int8_conv_im2col(q, wq, s, *a)}
        row = {"shape": str(key), "count": count,
               "route": i8.conv_route(q.shape, wq.shape, *a)[0],
               "bitwise": {v: bool(torch.equal(fn(), ref))
                           for v, fn in fns.items()},
               "ms": [t(fns[v]) for v in TURNS], "int_mm_patch_ms": None}
        for i, v in enumerate(TURNS):
            result["conv_sum_ms"][v][i // 2] += count * row["ms"][i]
        ops, _, m, n, k = cs.conv_cost(key)
        if k % 8 == 0 and n % 8 == 0 and key[5] == 1:
            kh, kw = key[1][2:]
            patches = F.unfold(q0.float(), (kh, kw), dilation=a[1],
                               padding=a[2], stride=a[0]).transpose(
                1, 2).reshape(m, k).to(torch.int8).contiguous()
            wmat = wq0.reshape(n, k)
            row["int_mm_patch_ms"] = [
                t(lambda: torch._int_mm(patches, wmat.t()).float() * s)
                for _ in range(2)]
            for i in range(2):
                result["int_mm_patch_sum_ms"][i] += \
                    count * row["int_mm_patch_ms"][i]
            result["int_mm_patch_convs"] += count
            del patches
        result["convs"].append(row)
        print("conv %s x%d %s: other/this/this/other %s ms; bitwise %s"
              % (key, count, row["route"],
                 " ".join("%.4f" % v for v in row["ms"]), row["bitwise"]),
              flush=True)
        del q, wq, q0, wq0, s, ref
    result["all_bitwise"] = all(fc["bitwise"].values()) and all(
        all(r["bitwise"].values()) for r in result["convs"])
    print("conv sum over 53 convs: other %s ms, this %s ms; _int_mm over "
          "patches (%d convs) %s ms" % (
              " ".join("%.4f" % v for v in result["conv_sum_ms"]["other"]),
              " ".join("%.4f" % v for v in result["conv_sum_ms"]["this"]),
              result["int_mm_patch_convs"],
              " ".join("%.4f" % v for v in result["int_mm_patch_sum_ms"])),
          flush=True)
    result["host_us"] = []
    for v in TURNS:
        h = host_us(os.path.abspath(args.other) if v == "other" else ROOT, v)
        result["host_us"].append(dict(h, version=v))
        print("host us a wrapper call (%s): int8_matmul %.2f, "
              "int8_conv_im2col %.2f" % (v, h["int8_matmul"],
                                         h["int8_conv_im2col"]), flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if result["all_bitwise"] else 1


if __name__ == "__main__":
    sys.exit(main())
