"""The type rule of the model builders."""
from __future__ import annotations

__all__ = ["check_dtype"]


def check_dtype(dtype):
    """Only float32 networks are ported; the others (float16, bfloat16
    weights with ``multi_precision``) are ROADMAP A8.4."""
    if str(dtype) != "float32":
        raise NotImplementedError(
            "dtype %r is not ported to mxnet_tpu_torch yet (float32 only; "
            "ROADMAP A8.4)" % (dtype,))
