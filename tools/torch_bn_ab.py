#!/usr/bin/env python3
"""Time ResNet-50's scoring forwards on one NVIDIA card under three
inference BatchNorms, in one process:

* ``kernel``: the port's ``batch_norm_inference`` CUDA kernel (one
  launch a layer, correctly rounded, the CPU's bits);
* ``plain``: its plain version, ``x * a + b`` in eager PyTorch ops (5-6
  launches a layer, the same bits);
* ``library``: ``F.batch_norm(training=False)``, PyTorch's own inference
  kernel (one launch a layer, other bits).

    python3 tools/torch_bn_ab.py [--iters 10] [--rounds 2] [--report PATH]

Three forwards of the mxnet_tpu_torch package, seeded Xavier weights,
batch 32 of 3x224x224: the fp32 ``serving.Predictor`` (set_input,
forward, get_output), ``Module.predict`` over an ``NDArrayIter`` of 4
batches, and the int8 ``Predictor`` of the same checkpoint (naive
calibration over one batch). Rounds alternate the order of the variants
(kernel, plain, library, then library, plain, kernel); each variant's
host wall per batch is the median over ``iters`` forwards of every
round. One profiled Predictor forward per variant gives its device ms,
its kernels and copies, and the device's busy share. The kernel and
plain variants must give the same bits. Prints the card line and one
JSON line.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, IMAGE = 32, (3, 224, 224)
VARIANTS = ("kernel", "plain", "library")


def install(torch, op, real, variant):
    """Make the registry's BatchNorm take ``variant`` for its inference
    branch (float32, axis 1)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda import batch_norm as bnk
    if variant == "kernel":
        op.fn = real
        return

    def fn(data, gamma, beta, moving_mean, moving_var, **attrs):
        if (attrs.get("train_mode") and not attrs.get("use_global_stats")) \
                or attrs.get("output_mean_var") \
                or attrs.get("axis", 1) != 1 or data.dtype != torch.float32:
            return real(data, gamma, beta, moving_mean, moving_var, **attrs)
        fix, eps = attrs.get("fix_gamma", True), attrs.get("eps", 1e-3)
        if variant == "plain":
            return bnk._batch_norm_inference_plain(
                data, gamma, beta, moving_mean, moving_var, eps, fix)
        if fix:
            gamma = torch.ones_like(gamma)
        return F.batch_norm(data, moving_mean, moving_var, gamma, beta,
                            training=False, eps=eps)
    op.fn = fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--report")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_bn_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx
    from chip_smoke import _int8_classes, card_line, profile_run
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.ops.cuda import batch_norm as bnk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    op = registry.get_op("BatchNorm")
    real = op.fn

    sym = mx.models.resnet(num_classes=1000, num_layers=50,
                           image_shape=IMAGE)
    mod = mx.mod.Module(sym, context=dev)
    mod.bind(data_shapes=[("data", (BATCH,) + IMAGE)],
             label_shapes=[("softmax_label", (BATCH,))], for_training=False)
    mx.random.seed(0)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    rng = np.random.RandomState(0)
    x = rng.randn(BATCH, *IMAGE).astype(np.float32)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    prefix = os.path.join(tmp, "resnet50")
    mx.model.save_checkpoint(prefix, 0, sym, *mod.get_params())
    qp = mx.quantize.quantize_checkpoint(prefix, [x], calib_mode="naive",
                                         ctx=dev)
    with open(prefix + "-0000.params", "rb") as f:
        blob = f.read()
    shapes = {"data": (BATCH,) + IMAGE}
    preds = {"fp32_predictor": mx.serving.Predictor(
        sym.tojson(), blob, input_shapes=shapes),
        "int8_predictor": mx.serving.Predictor(
            qp.symbol_json, qp.param_bytes(), input_shapes=shapes)}
    it = mx.io.NDArrayIter(np.concatenate([x] * 4), None, batch_size=BATCH)

    def pred_forward(p):
        p.set_input("data", x.tobytes())
        p.forward()
        return np.frombuffer(p.get_output(0), np.float32)

    paths = {"fp32_predictor": lambda: pred_forward(preds["fp32_predictor"]),
             "int8_predictor": lambda: pred_forward(preds["int8_predictor"]),
             "module_predict": lambda: mod.predict(it).asnumpy()}
    per_batch = {"fp32_predictor": 1, "int8_predictor": 1,
                 "module_predict": 4}
    walls = {(p, v): [] for p in paths for v in VARIANTS}
    outs = {}
    for r in range(args.rounds):
        order = VARIANTS if r % 2 == 0 else VARIANTS[::-1]
        for v in order:
            install(torch, op, real, v)
            for p, fn in paths.items():
                outs[(p, v)] = fn()             # warm
                torch.cuda.synchronize()
                for _ in range(args.iters):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls[(p, v)].append((time.perf_counter() - t0) * 1e3
                                         / per_batch[p])
    profiles = {}
    for v in VARIANTS:
        install(torch, op, real, v)
        for p in ("fp32_predictor", "int8_predictor"):
            bnk.reset_launches()
            prof = profile_run(torch, paths[p], classify_seq=_int8_classes)
            prof["batch_norm_launches"] = bnk.LAUNCHES[
                "batch_norm_inference"]
            profiles[(p, v)] = prof
    install(torch, op, real, "kernel")
    for p in paths:
        if not np.array_equal(outs[(p, "kernel")], outs[(p, "plain")]):
            print("torch_bn_ab: %s: the kernel and the plain version differ"
                  % p, file=sys.stderr)
            return 1
    rows = []
    for p in paths:
        for v in VARIANTS:
            w = np.array(walls[(p, v)])
            row = {"path": p, "variant": v,
                   "wall_ms_median": float(np.median(w)),
                   "wall_ms_min": float(w.min()), "samples": int(w.size),
                   "max_abs_vs_kernel": float(np.abs(
                       outs[(p, v)] - outs[(p, "kernel")]).max())}
            prof = profiles.get((p, v))
            if prof is not None:
                row.update(device_ms=sum(prof["device_ms"].values()),
                           device_ms_by_class=prof["device_ms"],
                           kernels_and_copies=prof["kernels"],
                           busy_share=prof["busy_share"],
                           batch_norm_launches=prof["batch_norm_launches"])
            rows.append(row)
            print("%-15s %-8s wall/batch median %.3f ms (min %.3f, n %d)%s"
                  % (p, v, row["wall_ms_median"], row["wall_ms_min"],
                     row["samples"],
                     "" if prof is None else
                     "; profiled: %.3f device ms, %d kernels and copies, "
                     "busy %.1f%%, %d BatchNorm kernel launches"
                     % (row["device_ms"], row["kernels_and_copies"],
                        100 * (row["busy_share"] or 0.0),
                        row["batch_norm_launches"])), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    report = {"card": card, "torch": torch.__version__, "rows": rows}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"bn_ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
