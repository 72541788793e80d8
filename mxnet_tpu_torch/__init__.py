"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

A package beside ``mxnet_tpu`` (the JAX reference, which it never
imports). Plain tensor code is PyTorch; every kernel the JAX package
wrote in Pallas for the TPU is a CUDA C++ kernel for ``sm_90a`` here,
built from ``ops/cuda/csrc`` with ``nvcc`` at first use. Entry points
run on ``cuda:0`` unless the caller passes ``device="cpu"`` / ``cpu()``.

Ported so far:

- decode serving: :class:`serve.DecodeEngine` over the paged transformer
  (``parallel.transformer``), kernels ``paged_decode_attention`` and
  ``flash_prefill_paged``;
- single-device transformer LM training:
  :func:`parallel.make_transformer_train_step`, the ``flash_attention``
  forward and backward kernels;
- symbolic training through ``Module.fit`` on one device (the ResNet
  path of ``examples/train_imagenet.py``): ``ndarray``, the op registry
  with the ResNet op set (``ops``), ``symbol``, ``models.resnet``,
  ``initializer``, ``executor``, ``optimizer`` (SGD, Adam),
  ``lr_scheduler``, ``io``, ``metric``, ``callback``, ``model`` and
  ``module``; the ``sgd_fused_update`` / ``adam_fused_update`` kernel
  updates every parameter in one launch a step;
- int8 quantized serving: checkpoint files (``ndarray.utils`` save/load
  in both of the JAX package's layouts, ``checkpoint``,
  ``model.save_checkpoint``), ``quantize`` (calibration, per-channel
  PTQ, the ``QuantizedParams`` artifact), the quantization ops,
  ``serving.Predictor`` and ``serve.InferenceEngine``; kernels
  ``int8_matmul`` and ``int8_conv_im2col``;
- the imperative API and Gluon: NDArray arithmetic and the generated
  ``nd.<op>`` functions, ``autograd`` (over ``torch.autograd``),
  ``operator`` (custom ops, ``nd.Custom`` / ``sym.Custom``), ``rtc``
  (CUDA C compiled at run time by NVRTC, ``CudaModule``: the port of the
  JAX package's runtime Pallas launcher), and ``gluon`` (Block,
  Parameter, nn, loss, Trainer, utils, data, the ResNet model zoo), whose
  ``Trainer.step`` runs the fused update kernel once a step;
- the north-star CLI on real data (``examples.train_imagenet``):
  ``recordio`` (a native reader built with g++ at first use), ``image``
  (augmenters, ``ImageIter`` with a native decode route: OpenCV on host
  threads, or nvJPEG on the card and the ``crop_mirror_normalize``
  kernel), ``io.ImageRecordIter`` and ``io.PrefetchingIter`` (batches
  staged onto the card through pinned buffers), and ``Module``
  checkpoints with optimizer states and ``fit(resume=True)``.

Importing the package imports no triton, loads no CUDA library (nor
NVRTC) and touches no GPU.
"""
from . import (autograd, callback, checkpoint, config, context, convert,
               executor, image, initializer, io, lr_scheduler, metric, model,
               models, module, ndarray, ops, optimizer, parallel, quantize,
               random, recordio, serve, serving, symbol, telemetry)
from . import operator, rtc  # after ndarray and symbol: adds Custom
from . import gluon
from .base import MXNetError
from .context import cpu, default_device, gpu

nd = ndarray
sym = symbol
mod = module
init = initializer

__all__ = ["MXNetError", "cpu", "gpu", "default_device", "autograd",
           "callback", "checkpoint", "config", "context", "convert",
           "executor", "gluon", "image", "init", "initializer", "io",
           "lr_scheduler",
           "metric", "mod", "model", "models", "module", "nd", "ndarray",
           "operator", "ops", "optimizer", "parallel", "quantize", "random",
           "recordio", "rtc", "serve", "serving", "sym", "symbol", "telemetry"]
