#!/usr/bin/env python3
"""Where the time of the decode kernel's "cluster" route goes, phase by
phase, on one NVIDIA card.

    python3 tools/torch_decode_phases.py [--rows 8] [--report PATH]

Builds a copy of ``csrc/paged_decode_attention.cu`` in which every line
``// phase N: ...`` of ``paged_decode_split_kernel`` is followed by a
statement that makes thread 0 of each CTA store ``clock64()`` (SM
cycles) into a device array, and runs that copy through the wrapper (its
entry point swapped in) at the serving shape: bf16, ``--rows`` rows of
the decode_serve mix's lengths, 4 kv heads x group 4, head_dim 64,
16-token pages, 16 pages a row. One launch after the L2 flush of
``chip_smoke.Timer`` (256 MB written) and one warm. For each phase it
prints the cycles since the CTA's phase 0, the median and the largest
over the CTAs that reached it (a CTA without live keys skips phases 3-5;
a stamp inside the token loop keeps its last step). Then the kernel's
device time by ``torch.profiler`` for the stamped copy and for the
checkout's own kernel: what the stamps themselves cost.

Prints the card line, a line a run, and one JSON line; exits non-zero
without a card.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE = re.compile(r"^\s*// phase (\d+): (.*)$")
SLOTS = 16           # stamps a CTA
MAX_CTAS = 1 << 14


def stamped_source(src):
    """The source with a clock64() store after each phase marker, and the
    device array and its C accessors; {phase: name}."""
    out, names = [], {}
    for line in src.split("\n"):
        out.append(line)
        m = PHASE.match(line)
        if m:
            k = int(m.group(1))
            names[k] = m.group(2)
            out.append(
                "if (threadIdx.x == 0) mxt_phase_cycles[((blockIdx.z * "
                "gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * %d + "
                "%d] = clock64();" % (SLOTS, k))
    text = "\n".join(out)
    text = text.replace(
        "namespace {\n",
        "namespace {\n__device__ long long mxt_phase_cycles[%d];\n"
        % (MAX_CTAS * SLOTS), 1)
    text += (
        '\nextern "C" int phase_cycles_read(void* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, mxt_phase_cycles, "
        "sizeof(mxt_phase_cycles));\n}\n"
        'extern "C" int phase_cycles_clear() {\n'
        "  static long long zeros[%d];\n"
        "  return (int)cudaMemcpyToSymbol(mxt_phase_cycles, zeros, "
        "sizeof(zeros));\n}\n" % (MAX_CTAS * SLOTS))
    return text, names


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--report", help="also write the JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from mxnet_tpu_torch.ops.cuda import _build
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    card = cs.card_line()
    print(card, flush=True)
    name = "paged_decode_attention"
    _build.build_all([name])
    with open(os.path.join(_build.CSRC, _build.SOURCES[name])) as f:
        text, names = stamped_source(f.read())
    out_dir = os.path.join(_build.BUILD_DIR, "phases_%d" % os.getpid())
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "stamped.cu")
    lib_path = os.path.join(out_dir, "stamped.so")
    with open(src, "w") as f:
        f.write(text)
    built = subprocess.run([_build._nvcc()] + list(_build.NVCC_FLAGS)
                           + ["-I", _build.CSRC, "-o", lib_path, src],
                           capture_output=True, text=True)
    if built.returncode:
        print(built.stdout[-4000:], built.stderr[-4000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(lib_path)
    sym, argtypes = fa._ROUTE_SYMBOLS[name][("cluster", "bf16")]
    stamped = getattr(lib, sym)
    stamped.argtypes = argtypes
    stamped.restype = ctypes.c_int
    lib.phase_cycles_read.argtypes = [ctypes.c_void_p]

    gen = torch.Generator().manual_seed(1)
    lengths = [int(x) for x in torch.randint(4, 145, (args.rows,),
                                             generator=gen)]
    call_args = cs.decode_inputs(torch, gen, args.rows, lengths,
                                 torch.bfloat16)
    route, splits = fa.decode_route(torch.bfloat16, 64, 16)
    ctas = args.rows * 4 * splits
    timer = cs.Timer(torch)
    key = (name, "cluster", torch.bfloat16)
    own = fa._route_fn(*key)
    result = {"card": card, "rows": args.rows, "lengths": lengths,
              "splits": splits, "phases": names, "runs": {},
              "device_us": {}}
    try:
        fa._route_fns[key] = stamped
        for run in ("flushed", "warm"):
            fa.paged_decode_attention(*call_args)
            torch.cuda.synchronize()
            if lib.phase_cycles_clear() != 0:
                raise RuntimeError("clearing the stamps failed")
            if run == "flushed":
                timer.flush.zero_()
            fa.paged_decode_attention(*call_args)
            torch.cuda.synchronize()
            buf = np.zeros(MAX_CTAS * SLOTS, np.int64)
            if lib.phase_cycles_read(buf.ctypes.data) != 0:
                raise RuntimeError("reading the stamps failed")
            t = buf[:ctas * SLOTS].reshape(ctas, SLOTS)
            rows = {}
            for k in sorted(names):
                if k == 0:
                    continue
                got = t[:, k] > 0
                rel = (t[got, k] - t[got, 0]).astype(np.float64)
                if rel.size:
                    rows[k] = {"median": float(np.median(rel)),
                               "max": float(rel.max()),
                               "ctas": int(got.sum())}
            result["runs"][run] = rows
            print("%-7s %s" % (run, "; ".join(
                "%d %s %d/%d" % (k, names[k].split(",")[0],
                                 r["median"], r["max"])
                for k, r in rows.items())), flush=True)
        for version, fn in (("stamped", stamped), ("checkout", own)):
            fa._route_fns[key] = fn
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    timer.flush.zero_()
                    fa.paged_decode_attention(*call_args)
                torch.cuda.synchronize()
            evs = [e for e in prof.key_averages()
                   if "paged_decode_split" in e.key]
            result["device_us"][version] = (
                sum(e.device_time_total for e in evs)
                / max(1, sum(e.count for e in evs)))
    finally:
        fa._route_fns[key] = own
    print("device us a launch (profiler, L2 flushed): %s" % ", ".join(
        "%s %.2f" % kv for kv in result["device_us"].items()), flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
