"""Serving: micro-batched scoring (``InferenceEngine`` over a
``serving.Predictor``) and continuous-batching decode over a paged KV
cache (``DecodeEngine``)."""
from .batching import (parse_buckets, pick_bucket, power_of_two_buckets,
                       validate_buckets)
from .decode import DecodeConfig, DecodeEngine, DecodeSession
from .engine import (DeadlineExceededError, EngineClosedError,
                     InferenceEngine, QueueFullError, ServeConfig)
from .kv_pages import NULL_PAGE, PagePool, PagePoolExhausted, pages_needed

__all__ = ["DecodeConfig", "DecodeEngine", "DecodeSession",
           "DeadlineExceededError", "EngineClosedError", "InferenceEngine",
           "QueueFullError", "ServeConfig", "PagePool", "PagePoolExhausted",
           "pages_needed", "NULL_PAGE", "parse_buckets", "pick_bucket",
           "power_of_two_buckets", "validate_buckets"]
