"""Runtime configuration: the MXNET_* environment-variable knobs this
package reads, with the same names, types and defaults as the JAX
package's table."""
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
