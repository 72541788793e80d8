"""Serving: micro-batched scoring (``InferenceEngine`` over a
``serving.Predictor``), continuous-batching decode over a paged KV cache
(``DecodeEngine``), the model registry (``ModelRegistry``: hot swap, the
int8 swap and its shadow canary) and the HTTP front end (``serve_http``:
``/predict``, streaming ``/generate``, ``/healthz``, ``/metrics``,
``/traces``, ``/alerts``).

Quick start::

    import mxnet_tpu_torch as mx

    reg = mx.serve.ModelRegistry(symbol_json, param_bytes,
                                 input_shapes={"data": (1, 3, 224, 224)})
    reg.warmup()                              # every bucket, on the card
    srv = mx.serve.serve_http(reg, port=8080)
    ...
    reg.swap(new_param_bytes)                 # zero-downtime weight update
    srv.close(); reg.close()

The fleet tier (``Router``, ``Fleet``) is ROADMAP A16.
"""
from .batching import (parse_buckets, pick_bucket, power_of_two_buckets,
                       validate_buckets)
from .decode import DecodeConfig, DecodeEngine, DecodeSession
from .engine import (DeadlineExceededError, EngineClosedError,
                     InferenceEngine, QueueFullError, ServeConfig,
                     engines_status)
from .http import ServeHTTPServer, serve_http
from .kv_pages import NULL_PAGE, PagePool, PagePoolExhausted, pages_needed
from .registry import ModelRegistry

__all__ = ["DecodeConfig", "DecodeEngine", "DecodeSession",
           "DeadlineExceededError", "EngineClosedError", "InferenceEngine",
           "QueueFullError", "ServeConfig", "PagePool", "PagePoolExhausted",
           "pages_needed", "NULL_PAGE", "parse_buckets", "pick_bucket",
           "power_of_two_buckets", "validate_buckets", "engines_status",
           "ModelRegistry", "serve_http", "ServeHTTPServer"]
