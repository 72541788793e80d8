"""Runtime configuration: the MXNET_* environment-variable knobs this
package reads, with the same names, types and defaults as the JAX
package's table, but for the MFU peaks (``MXNET_TPU_PEAK_FLOPS``,
``MXNET_TPU_PEAK_HBM_GBPS``), whose defaults are the card's spec-sheet
figures."""
from __future__ import annotations

import os

__all__ = ["get", "VARS"]

# name -> (type, default, doc)
VARS = {
    "MXNET_SERVE_WORKER_RESTARTS": (int, 16,
                                    "Restart budget for crashed serve "
                                    "worker threads (shared across an "
                                    "InferenceEngine's crew, counted in "
                                    "serving/worker_restarts_total) and "
                                    "for a crashed decode scheduler thread "
                                    "(decode/worker_restarts_total). Past "
                                    "it the worker stays down."),
    "MXNET_TELEMETRY": (bool, True,
                        "Always-on runtime metrics (telemetry.py). 0 "
                        "turns the hot-path recording off; "
                        "telemetry.enable() flips it at runtime."),
    "MXNET_SERVE_SHADOW_FRACTION": (float, 0.0,
                                    "Default fraction of live requests "
                                    "ModelRegistry.enable_shadow mirrors "
                                    "to the shadow (quantized) engine "
                                    "for drift measurement "
                                    "(quantize/shadow_drift). Mirrors "
                                    "run on a side thread and never "
                                    "touch the primary request."),
    "MXNET_TRACING": (bool, True,
                      "End-to-end span tracing (tracing.py): request/"
                      "step timelines across the serve, executor, "
                      "module, io and checkpoint layers. 0 leaves every "
                      "call site at one module-bool check."),
    "MXNET_TRACE_SAMPLE": (float, 1.0,
                           "Head-sampling probability for new traces "
                           "(decided once at the root: an HTTP request "
                           "or a train step). 0 disables recording but "
                           "keeps the X-Request-Id echo."),
    "MXNET_TRACE_OPS": (bool, False,
                        "Record a per-op op.dispatch span for every "
                        "eager dispatch under a sampled trace. Off by "
                        "default: on microsecond-scale ops the span "
                        "write costs more than the dispatch."),
    "MXNET_TRACE_SLOW_MS": (int, 1000,
                            "Slow-exemplar threshold: sampled traces "
                            "whose root span exceeds this many ms (and "
                            "every sampled trace ending in an error/"
                            "timeout/injected fault) are kept in a "
                            "separate ring."),
    "MXNET_TRACE_RING": (int, 64,
                         "How many finished traces the in-memory ring "
                         "keeps for /traces."),
    "MXNET_NUMERICS": (str, "off",
                       "Numerics sentinel of the fused train step "
                       "(health.py): off | step (loss proxy + global "
                       "grad norm + nonfinite count: one device "
                       "reduction and one small fetch per step, read one "
                       "step behind) | full (adds per-parameter "
                       "attribution so a trip names the layer)."),
    "MXNET_NUMERICS_POLICY": (str, "warn",
                              "What a numerics-sentinel trip does: "
                              "warn (log + count + flight-record, "
                              "keep training) | raise "
                              "(health.NumericsError) | "
                              "checkpoint-and-raise (fit saves the "
                              "tripped state under <prefix>.numerics, "
                              "then raises)."),
    "MXNET_NUMERICS_SPIKE": (float, 0.0,
                             "Grad-norm spike threshold: trip when the "
                             "global grad norm exceeds this many times "
                             "its running EMA. 0 disables spike "
                             "detection (nonfinite detection stays "
                             "on)."),
    "MXNET_FLIGHT_RECORDER": (str, "",
                              "Crash-safe flight-recorder path "
                              "(blackbox.py): lifecycle events (swaps, "
                              "checkpoints, faults, alerts, numerics "
                              "trips) appended as CRC-framed fsync'd "
                              "records, readable post-mortem with "
                              "python -m mxnet_tpu_torch.blackbox. "
                              "Empty disables."),
    "MXNET_FLIGHT_RECORDER_MB": (float, 4.0,
                                 "Flight-recorder ring bound: the "
                                 "active segment rotates to <path>.1 "
                                 "at half this size."),
    "MXNET_SLO_INTERVAL_S": (float, 2.0,
                             "SLO evaluator wake period (health.py "
                             "background thread; it only reads "
                             "telemetry)."),
    "MXNET_SLO_SERVE_P99_MS": (float, 1000.0,
                               "Default serve_p99 SLO rule threshold "
                               "over the interval-local p99 of "
                               "serving/request_seconds."),
    "MXNET_SLO_DECODE_ITL_P99_MS": (float, 250.0,
                                    "Default decode_itl_p99 SLO rule "
                                    "threshold over decode/"
                                    "step_seconds p99 (inter-token "
                                    "latency)."),
    "MXNET_SLO_MFU_DIVERGENCE": (float, 0.20,
                                 "Default mfu_divergence SLO rule "
                                 "threshold on the health/"
                                 "mfu_divergence gauge (|measured/"
                                 "hand-counted - 1|), events mode."),
    "MXNET_SLO_BADPUT_FRACTION": (float, 0.5,
                                  "Default badput_fraction SLO rule "
                                  "threshold on the goodput/"
                                  "badput_fraction gauge."),
    "MXNET_TPU_PEAK_FLOPS": (float, 989.4e12,
                             "Peak FLOP/s, the MFU denominator of the "
                             "health gauges (the JAX package's knob "
                             "name). Default: the spec-sheet dense bf16 "
                             "figure of an NVIDIA H100 80GB HBM3 "
                             "(SXM5, 700 W)."),
    "MXNET_TPU_PEAK_HBM_GBPS": (float, 3350.0,
                                "Peak device-memory bandwidth (GB/s) for "
                                "the hbm_bw_util gauges (the JAX "
                                "package's knob name). Default: the "
                                "spec-sheet figure of an NVIDIA H100 "
                                "80GB HBM3 (SXM5)."),
    "MXNET_FAULT_INJECT": (str, "",
                           "Arm fault-injection points at import: "
                           "point:step:kind[:count] comma list "
                           "(kinds: raise/transient/partition/delay/"
                           "crash; see fault.py). Test-only."),
    "MXNET_SERVE_MAX_BATCH": (int, 8,
                              "Largest serving batch bucket "
                              "(serve.InferenceEngine). Buckets default "
                              "to the power-of-two ladder 1..max; one "
                              "bound executor per bucket."),
    "MXNET_SERVE_BUCKETS": (str, "", "Explicit serving batch buckets as "
                            "a comma list (e.g. '1,4,16'); empty = "
                            "power-of-two ladder up to "
                            "MXNET_SERVE_MAX_BATCH."),
    "MXNET_SERVE_QUEUE_DEPTH": (int, 64,
                                "Serve admission-control bound: requests "
                                "beyond this many queued are rejected "
                                "immediately, never queued into unbounded "
                                "latency."),
    "MXNET_SERVE_BATCH_WAIT_MS": (int, 2,
                                  "How long the micro-batcher holds the "
                                  "first queued request open for "
                                  "coalescing (higher = bigger batches, "
                                  "more latency floor)."),
    "MXNET_SERVE_DEADLINE_MS": (int, 2000,
                                "Default per-request serving deadline; "
                                "expired requests fail before they reach "
                                "the device. 0 disables."),
    "MXNET_SERVE_WORKERS": (int, 1,
                            "Serve worker threads pulling batches off "
                            "the queue. >1 overlaps host pad/unpad with "
                            "device compute (per-bucket executors are "
                            "lock-guarded)."),
    "MXNET_QUANT_PERCENTILE": (float, 99.99,
                               "Percentile of |x| the percentile/"
                               "entropy calibration observer clips "
                               "activation ranges at "
                               "(quantize.calibrate.PercentileObserver)."),
    "MXNET_DECODE_SLOTS": (int, 8,
                           "Concurrent sequences the decode engine "
                           "(serve.DecodeEngine) schedules per step; "
                           "decode steps run at power-of-two slot "
                           "buckets up to this."),
    "MXNET_DECODE_PAGE_SIZE": (int, 16,
                               "Tokens per KV-cache page. Smaller = "
                               "less reserved-memory waste per "
                               "sequence, more block-table entries per "
                               "step."),
    "MXNET_DECODE_NUM_PAGES": (int, 512,
                               "KV-cache page pool size (page 0 is a "
                               "reserved null page). Device memory: 2 * "
                               "layers * pages * page_size * kv_heads "
                               "* head_dim * itemsize. Admission "
                               "refuses requests the free list cannot "
                               "cover."),
    "MXNET_DECODE_MAX_CONTEXT": (int, 256,
                                 "Max prompt + generated tokens per "
                                 "sequence (a multiple of the page "
                                 "size; sets the block-table width and "
                                 "the prefill ladder top)."),
    "MXNET_DECODE_QUEUE_DEPTH": (int, 64,
                                 "Decode admission bound: requests "
                                 "waiting for a slot beyond this are "
                                 "rejected immediately."),
    "MXNET_DECODE_MAX_NEW_TOKENS": (int, 128,
                                    "Default and cap for a request's "
                                    "max_new_tokens (bounds its page "
                                    "reservation)."),
    "MXNET_DECODE_DEADLINE_MS": (int, 30000,
                                 "Default per-request decode deadline "
                                 "(queued or mid-stream; expired "
                                 "sessions are retired and their pages "
                                 "freed). 0 disables."),
    "MXNET_FUSED_STEP": (bool, True,
                         "Run Module's forward + backward + optimizer "
                         "update as one train step (Executor.train_step: "
                         "one torch.autograd.grad, then ONE fused-update "
                         "launch over every parameter). 0 restores the "
                         "separate forward/backward calls plus a "
                         "per-parameter update."),
    "MXNET_PALLAS_FUSED_UPDATE": (bool, True,
                                  "Route the SGD/Adam fused update rules "
                                  "through the hand-written kernel "
                                  "(ops/cuda/fused_update.py; on CPU "
                                  "tensors it runs its plain version). "
                                  "Declared for parity with the JAX "
                                  "package, where 0 selects the XLA "
                                  "rules; the port has no second route "
                                  "on the card, so 0 raises."),
    "MXNET_IO_WORKERS": (int, 0,
                         "Decode worker processes for io.DataPipeline. "
                         "0 = inline decode on the staging thread "
                         "(the same stream, no parallelism); -1 = host "
                         "cores minus one."),
    "MXNET_IO_PREFETCH": (int, 2,
                          "Depth of the DataPipeline staging buffer: how "
                          "many decoded batches are staged on the card "
                          "ahead of the consumer. Also bounds in-flight "
                          "decode (workers + prefetch), the pipeline's "
                          "backpressure."),
    "MXNET_IO_WORKER_RESTARTS": (int, 4,
                                 "Restart budget for crashed DataPipeline "
                                 "decode workers. In-flight batches are "
                                 "decoded again on restart; past the "
                                 "budget the pipeline raises."),
    "MXNET_DATALOADER_START_METHOD": (str, "fork",
                                      "Process start method for "
                                      "io.DataPipeline workers (fork / "
                                      "spawn / forkserver). fork shares "
                                      "the source copy-on-write; the "
                                      "workers never touch CUDA, so a "
                                      "parent holding a CUDA context "
                                      "forks safely. spawn / forkserver "
                                      "pickle the source and need the "
                                      "script's __main__ guard."),
}


def get(name):
    """A declared knob's value: the environment's, converted to its
    registered type, else its registered default."""
    typ, default, _ = VARS[name]
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return typ(raw)
