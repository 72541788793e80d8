#!/usr/bin/env python3
"""Time the first and the redesigned decode-serving kernels of this
checkout against each other on one NVIDIA card, in one process.

    python3 tools/torch_decode_ab.py [--iters 30] [--report PATH]

Both designs are routes of the same libraries: ``paged_decode_attention``
("serial", the first design, against "cluster") and
``flash_prefill_paged`` ("fma" against "mma"), so the wrappers run each
design by forcing its route (``chip_smoke.forced_route``). On seeded bf16
inputs at the serving shapes (decode: 1, 2, 4 and 8 rows of 4 kv heads x
group 4, head_dim 64, 16-token pages, lengths of the decode_serve mix;
prefill: batch 1, buckets 16-256, 16 heads over 4 kv heads):

* each design's output against the plain version (max abs error; pages
  bitwise), and whether a second call is bitwise equal to the first;
* ms by CUDA events with the L2 flushed before every launch and a
  0.5 ms device-side hold (``chip_smoke.Timer``), in turns old, new,
  new, old, then the library yardstick (scaled_dot_product_attention on
  gathered K/V; causal SDPA + page scatter) twice;
* each kernel's device time alone (``torch.profiler``, 20 calls each);
* the host microseconds of a wrapper call on each route (decode at
  b = 8, prefill at s = 128; the least of 3 runs of 1000 calls, in turns
  new, old, new, old).

Prints the card line, one line per shape, and one JSON line; exits
non-zero without a card.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = {  # kernel -> (route function, first design, redesign)
    "paged_decode_attention": ("decode_route", ("serial", None), "cluster"),
    "flash_prefill_paged": ("prefill_route", "fma", "mma"),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--report", help="also write the JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from mxnet_tpu_torch.ops.cuda import _build
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    card = cs.card_line()
    print(card, flush=True)
    _build.build_all(list(ROUTES))
    timer = cs.Timer(torch)
    gen = torch.Generator().manual_seed(5)
    bf16 = torch.bfloat16
    result = {"card": card, "shapes": []}

    def on(name, version, fn):
        """``fn()`` with ``name``'s wrapper on the old or new design."""
        fn_name, old, _ = ROUTES[name]
        if version == "new":
            return fn()
        with cs.forced_route(fa, fn_name, old):
            return fn()

    def profiled_us(name, version, call):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                timer.flush.zero_()
                on(name, version, call)
            torch.cuda.synchronize()
        key = "paged_decode" if name == "paged_decode_attention" \
            else "flash_prefill"
        evs = [e for e in prof.key_averages() if key in e.key]
        return sum(e.device_time_total for e in evs) / max(
            1, sum(e.count for e in evs))

    cases = []
    for b in (1, 2, 4, 8):
        lengths = [int(x) for x in torch.randint(4, 145, (b,),
                                                 generator=gen)]
        a = cs.decode_inputs(torch, gen, b, lengths, bf16)
        cases.append(("paged_decode_attention", "b=%d" % b, a,
                      cs.bound_of(*cs.decode_cost(a[0], a[3], a[4]))[0]))
    for s in (16, 32, 64, 128, 256):
        a = cs.prefill_inputs(torch, gen, 1, s, 16, 4, bf16)
        cases.append(("flash_prefill_paged", "b=1 s=%d" % s, a,
                      cs.bound_of(*cs.prefill_cost(a[0], a[1], a[5]))[0]))
    for name, shape, a, bound in cases:
        decode = name == "paged_decode_attention"
        if decode:
            def call(a=a):
                return fa.paged_decode_attention(*a)
            ref = fa._paged_decode_torch(*[t.float() if t.is_floating_point()
                                           else t for t in a], 1.0 / 8.0)
            library = lambda a=a: cs.library_decode(torch, *a)  # noqa: E731
        else:
            def call(a=a):
                return fa.flash_prefill_paged(*a)[0]
            q, kg, vg, kp, vp, bt = a
            kp_ref, vp_ref = kp.clone(), vp.clone()
            ref, _, _ = fa._flash_prefill_torch(
                q.float(), kg.float(), vg.float(), kp_ref.float(),
                vp_ref.float(), bt)
            fa._flash_prefill_torch(q, kg, vg, kp_ref, vp_ref, bt)
            library = lambda a=a: cs.library_prefill(torch, *a)  # noqa: E731
        row = {"name": name, "shape": shape, "bound_ms": bound, "check": {},
               "turns": []}
        for version in ("old", "new"):
            first = on(name, version, call)
            second = on(name, version, call)
            torch.cuda.synchronize()
            chk = {"max_abs_err": cs.max_err(first, ref),
                   "bitwise_repeat": bool(torch.equal(first, second))}
            if not decode:
                chk["pages_bitwise"] = bool(
                    torch.equal(a[3][1:], kp_ref[1:])
                    and torch.equal(a[4][1:], vp_ref[1:]))
            row["check"][version] = chk
        for version in ("old", "new", "new", "old"):
            row["turns"].append([version, on(
                name, version, lambda: timer(call, iters=args.iters,
                                             hold_ms=0.5))])
        row["library_ms"] = [timer(library, iters=args.iters)
                             for _ in range(2)]
        row["device_us"] = {v: profiled_us(name, v, call)
                            for v in ("old", "new")}
        if shape in ("b=8", "b=1 s=128"):
            row["host_us"] = [[v, on(name, v, lambda: cs.host_us(torch,
                                                                  call))]
                              for v in ("new", "old", "new", "old")]
        result["shapes"].append(row)
        print("%-24s %-10s turns %s library %s device_us %s%s bound %.5f "
              "check %s" % (
                  name, shape, " ".join("%s %.4f" % tuple(t)
                                        for t in row["turns"]),
                  " ".join("%.4f" % t for t in row["library_ms"]),
                  " ".join("%s %.2f" % kv for kv in row["device_us"].items()),
                  "" if "host_us" not in row else " host_us " + " ".join(
                      "%s %.2f" % tuple(h) for h in row["host_us"]),
                  bound, row["check"]), flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
