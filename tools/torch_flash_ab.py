#!/usr/bin/env python3
"""Time the bf16 flash attention kernels of this checkout against those
of another checkout on one NVIDIA card, in one process.

    python3 tools/torch_flash_ab.py OTHER_ROOT [--shape B,H,S,D]
                                    [--iters 50] [--report PATH]

OTHER_ROOT is the root of another checkout of the repository, for
example the parent commit unpacked by ``git archive`` into a directory
that ``.gitignore`` lists. Its ``flash_attention.cu`` and
``flash_attention_bwd.cu`` are built with this checkout's nvcc flags and
bound through the same C entry points (an older entry that takes one
length for q, k and v gets s_q), then both versions run on the same
seeded causal bf16 inputs at ``--shape`` (default: the train path's (8,
16, 1024, 64)):

* each version's outputs against the plain versions (relative RMS error
  per (batch, head) slice, the largest), and whether a second run of
  each version is bitwise equal to its first;
* forward and backward ms by CUDA events with the L2 flushed before
  every launch and a 0.5 ms device-side wait after it, so the host's
  enqueue time stays out of the device time (``chip_smoke.Timer``), in
  turns: other, this, this, other, then ``scaled_dot_product_attention``
  twice;
* this checkout's device time per kernel (``torch.profiler``, 10 calls
  of each), so the backward's passes show apart.

Prints the card line and one JSON line; exits non-zero without a card.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("flash_attention", "flash_attention_bwd")
HOLD_MS = 0.5   # device-side wait before each timed launch


def build_other(other, out_dir, nvcc, flags):
    """Compile the other checkout's two flash sources; {name: path}."""
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


def bind_other(other, name, path, argtypes):
    """The other checkout's "wgmma" entry <name>_bf16, called with this
    checkout's arguments (..., b*h, s_q, s_k, hd, causal, sm_scale,
    stream). An older entry that takes one length s for q, k and v (the
    shape here has s_q == s_k) gets s_q and not s_k."""
    fn = getattr(ctypes.CDLL(path), name + "_bf16")
    fn.restype = ctypes.c_int
    with open(os.path.join(other, "mxnet_tpu_torch", "ops", "cuda", "csrc",
                           name + ".cu")) as f:
        src = f.read()
    if re.search(r"%s_bf16\([^)]*\bint s, int hd" % name, src):
        fn.argtypes = argtypes[:-5] + argtypes[-4:]
        return lambda *a: fn(*(a[:-5] + a[-4:]))
    fn.argtypes = argtypes
    return fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--shape", default="8,16,1024,64")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--report", help="also write the JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from mxnet_tpu_torch.ops.cuda import _build
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    card = cs.card_line()
    print(card, flush=True)
    _build.build_all(list(NAMES))
    other_dir = os.path.join(_build.BUILD_DIR, "ab_other_%d" % os.getpid())
    paths = build_other(os.path.abspath(args.other), other_dir,
                        _build._nvcc(), _build.NVCC_FLAGS)
    other_fns = {name: bind_other(os.path.abspath(args.other), name, path,
                                  fa._SYMBOLS[name])
                 for name, path in paths.items()}
    this_kernel_fn = fa._kernel_fn

    def use(version):
        # the shape's bf16 calls take the "wgmma" route, whose entries
        # (<name>_bf16) both versions share
        fa._kernel_fn = (this_kernel_fn if version == "this"
                         else (lambda name, route, dtype: other_fns[name]))

    shape = tuple(int(x) for x in args.shape.split(","))
    scale = 1.0 / shape[3] ** 0.5
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = cs.attn_inputs(torch, gen, shape, torch.bfloat16)
    ref = cs.plain_flash(torch, fa, q, k, v, do, True, scale)
    result = {"card": card, "shape": list(shape), "causal": True,
              "dtype": "bfloat16", "check": {}, "turns": [],
              "sdpa": [], "profile_us": {}}
    saved = {}
    for version in ("other", "this"):
        use(version)
        runs = []
        for _ in range(2):
            o, lse = fa._flash_fwd(q, k, v, True)
            runs.append((o, lse) + tuple(
                fa.flash_attention_bwd(q, k, v, o, lse, do, True)))
        torch.cuda.synchronize()
        saved[version] = runs[0][:2]
        result["check"][version] = {
            "rel_err": {n: cs.rel_err(g, r) for n, g, r in
                        zip(cs.FLASH_OUTS, runs[0], ref)},
            "bitwise_repeat": all(torch.equal(a, b)
                                  for a, b in zip(*runs))}
    timer = cs.Timer(torch)
    for version in ("other", "this", "this", "other"):
        use(version)
        o, lse = saved[version]
        fwd = timer(lambda: fa._flash_fwd(q, k, v, True), iters=args.iters,
                    hold_ms=HOLD_MS)
        bwd = timer(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                   True), iters=args.iters,
                    hold_ms=HOLD_MS)
        result["turns"].append({"version": version, "fwd_ms": fwd,
                                "bwd_ms": bwd})
        print("%-5s fwd %.4f ms bwd %.4f ms" % (version, fwd, bwd),
              flush=True)
    use("this")
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    for _ in range(2):
        fwd = timer(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=args.iters,
            hold_ms=HOLD_MS)
        bwd = timer(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True), iters=args.iters,
            hold_ms=HOLD_MS)
        result["sdpa"].append({"fwd_ms": fwd, "bwd_ms": bwd})
        print("sdpa  fwd %.4f ms bwd %.4f ms" % (fwd, bwd), flush=True)
    o, lse = saved["this"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            timer.flush.zero_()
            fa._flash_fwd(q, k, v, True)
            timer.flush.zero_()
            fa.flash_attention_bwd(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if "anonymous namespace" in e.key and e.device_time_total > 0:
            name = e.key.split("::")[-1].split("(")[0]
            result["profile_us"][name] = e.device_time_total / e.count
    print("profile (this, us a call): %s" % ", ".join(
        "%s %.1f" % kv for kv in result["profile_us"].items()))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
