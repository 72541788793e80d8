#!/usr/bin/env python3
"""Time the card's image-decode kernel (``crop_mirror_normalize``) on one
NVIDIA card against the one-thread-a-pixel design of another checkout,
in one process.

    python3 tools/torch_image_decode_ab.py OTHER_ROOT [--rounds 2]
        [--report PATH]

OTHER_ROOT holds that design (9-column items, no resize; for example
``git archive 03905d3 | tar -x -C build/parent_tree``): its
``ops/cuda/csrc/image_decode.cu`` is built with this checkout's nvcc
flags and bound with its own signature.
Both decode a batch of 32 of ``chip_smoke.smoke_records``' images with
nvJPEG (3x224x224, random crop and mirror: phase 24's shape) and must
give the same bits; their kernels' device times (torch.profiler, after
the smoke's L2-evicting write) are read in turns, other / this / this /
other, each round. Beside them, this kernel at resize 256 and 160 on
``chip_smoke.domain_records``' images, this kernel after a read-only
L2 eviction and after none, and a ``zero_`` of the same 19.3 MB output
(the card's floor for the writes). Prints the card line and one JSON
line.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (3, 224, 224)
BATCH = 32


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="checkout with the one-thread-a-pixel "
                    "kernel")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--report", help="write the JSON here too")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_image_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda import _build
    from mxnet_tpu_torch.ops.cuda import image_decode as idec

    out_dir = os.path.join(ROOT, "build", "image_decode_ab")
    os.makedirs(out_dir, exist_ok=True)
    other_lib = os.path.join(out_dir, "other_image_decode.so")
    csrc = os.path.join(os.path.abspath(args.other), "mxnet_tpu_torch",
                        "ops", "cuda", "csrc")
    build = subprocess.run(
        [_build._nvcc()] + list(_build.NVCC_FLAGS)
        + ["-I", csrc, "-o", other_lib, os.path.join(csrc,
                                                      "image_decode.cu"),
           "-lnvjpeg"], capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    idec._library()                         # nvJPEG loaded globally
    other = ctypes.CDLL(other_lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    other.crop_mirror_normalize.argtypes = [p, p, i, i, i, i, p, p, p, p]

    card = cs.card_line()
    print(card, flush=True)
    timer = cs.Timer(torch)
    mean = np.array(cs.CLI_MEAN, np.float32)
    std = np.array(cs.CLI_STD, np.float32)
    data = os.path.join(out_dir, "data")
    rec = os.path.join(data, "train.rec")
    cs.smoke_records(mx, rec, n=BATCH)
    rec2 = os.path.join(data, "domain.rec")
    cs.domain_records(mx, rec2, n=BATCH)

    def batch(path, resize):
        dec = mx.image.NativeImageDecoder(
            SHAPE, resize=resize, rand_crop=True, rand_mirror=True,
            mean=mean, std=std, num_threads=4, backend="nvjpeg")
        reader = mx.recordio.MXIndexedRecordIO(
            os.path.splitext(path)[0] + ".idx", path, "r")
        bufs = [mx.recordio.unpack(reader.read_idx(k))[1]
                for k in range(BATCH)]
        reader.close()
        return dec.decode_planes(bufs, base=0)

    src, items = batch(rec, 0)
    out = torch.empty((BATCH,) + SHAPE, dtype=torch.float32, device="cuda")
    items9 = items[:, :9].contiguous().cuda()
    m = (ctypes.c_float * 3)(*mean)
    s = (ctypes.c_float * 3)(*std)

    def run_other():
        other.crop_mirror_normalize(
            src.data_ptr(), items9.data_ptr(), BATCH, 3, SHAPE[1], SHAPE[2],
            ctypes.cast(m, p), ctypes.cast(s, p), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    def run_this(source=src, rows=items):
        return idec.crop_mirror_normalize(source, rows, SHAPE, mean, std,
                                          out=out)

    run_other()
    want = out.clone()
    run_this()
    cs.check(torch.equal(out, want), "the two kernels' bits differ")
    turns = {"other": [], "this": []}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            fn = run_other if name == "other" else run_this
            turns[name].append(cs.kernel_device_ms(torch, timer, fn,
                                                   "crop_mirror_normalize"))
    res = {"card": card, "phase24_ms": turns,
           "bound_ms": cs._plane_cost(items, *SHAPE[1:]) / cs.HBM_BPS * 1e3}
    for resize in (256, 160):
        src2, items2 = batch(rec2, resize)
        res["resize%d_ms" % resize] = cs.kernel_device_ms(
            torch, timer, lambda: run_this(src2, items2),
            "crop_mirror_normalize")
        res["resize%d_bound_ms" % resize] = cs._plane_cost(
            items2, *SHAPE[1:]) / cs.HBM_BPS * 1e3

    # the L2's state before the kernel: evicted by a read (clean lines),
    # or left warm; and a plain write of the same output bytes after the
    # read eviction, the card's floor for the kernel's writes
    def read_evict():
        timer.flush.sum()

    res["phase24_read_evicted_ms"] = cs.kernel_device_ms(
        torch, timer, run_this, "crop_mirror_normalize", evict=read_evict)
    res["phase24_warm_ms"] = cs.kernel_device_ms(
        torch, timer, run_this, "crop_mirror_normalize", evict=lambda: None)
    res["zero_same_bytes_ms"] = cs.kernel_device_ms(
        torch, timer, lambda: out.zero_(), "elementwise", evict=read_evict)
    line = json.dumps(res)
    print(line)
    if args.report:
        with open(args.report, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
