"""Gluon utilities (the JAX package's ``gluon/utils.py``; reference:
python/mxnet/gluon/utils.py): ``split_and_load`` onto one device
(several devices are ROADMAP A12.6 with A13) and
``clip_global_norm``."""
from __future__ import annotations

import math
import warnings

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array

__all__ = ["split_and_load", "clip_global_norm"]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` placed on the one device of ``ctx_list`` (reference:
    gluon/utils.py split_and_load)."""
    if len(ctx_list) != 1:
        raise MXNetError("split_and_load over %d devices: mxnet_tpu_torch "
                         "trains on one device (ROADMAP A12.6 / A13)"
                         % len(ctx_list))
    if not isinstance(data, NDArray):
        return [array(data, ctx=ctx_list[0])]
    return [data.as_in_context(ctx_list[0])]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (reference:
    gluon/utils.py clip_global_norm)."""
    if not arrays:
        raise ValueError("arrays must not be empty")
    with torch.no_grad():
        total = torch.sqrt(sum(torch.sum(torch.square(
            a._data.to(torch.float32))) for a in arrays))
        total_norm = float(total)
        if check_isfinite and not math.isfinite(total_norm):
            warnings.warn("nan or inf is detected. Clipping results will "
                          "be undefined.", stacklevel=2)
        scale = max_norm / (total_norm + 1e-8)
        if scale < 1.0:
            for a in arrays:
                a._data.mul_(scale)
    return total_norm
