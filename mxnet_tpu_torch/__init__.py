"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

A package beside ``mxnet_tpu`` (the JAX reference, which it never
imports). Plain tensor code is PyTorch; every kernel the JAX package
wrote in Pallas for the TPU is a CUDA C++ kernel for ``sm_90a`` here,
built from ``ops/cuda/csrc`` with ``nvcc`` at first use. Entry points
run on ``cuda:0`` unless the caller passes ``device="cpu"``.

Ported so far: decode serving — :class:`serve.DecodeEngine` over the
paged transformer (``parallel.transformer``) with the
``paged_decode_attention`` and ``flash_prefill_paged`` kernels — and
single-device transformer LM training —
:func:`parallel.make_transformer_train_step` with the
``flash_attention`` forward and backward kernels.

Importing the package imports no triton, loads no CUDA library and
touches no GPU.
"""
from . import config, context, convert, ops, parallel, serve, telemetry
from .base import MXNetError
from .context import cpu, default_device, gpu

__all__ = ["MXNetError", "cpu", "gpu", "default_device", "config",
           "context", "convert", "ops", "parallel", "serve", "telemetry"]
