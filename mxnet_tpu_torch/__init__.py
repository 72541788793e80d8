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

- the core op surface (the JAX package's ``ops/{creation,elemwise,
  reduce,matrix,nn}.py`` but SyncBatchNorm and the contrib resizes),
  Dropout on the port's explicit generator, ``Context`` with
  ``with mx.cpu():`` scoping, and the CLI's other networks
  (``models.alexnet``, ``vgg``, ``mobilenet``, ``inception_bn``);
- recurrent language models: the ``RNN`` op (cuDNN on the card) and
  ``CTCLoss``, ``gluon.rnn`` and ``gluon.contrib.rnn``, the legacy
  ``rnn`` API (cells, ``BucketSentenceIter``, checkpoints),
  ``mod.BucketingModule`` and every metric (``Perplexity``);
- the JAX package's headline training path on one device:
  ``parallel.make_mesh`` and ``parallel.ShardedTrainer`` (the fused
  SGD-momentum step in float32 or bf16, ``run_steps`` as one CUDA
  graph), fed by ``io.DataPipeline`` (worker processes over
  ``ArrayBatchSource`` / ``RecordBatchSource``, a seekable cursor that
  ``fit(resume=True)`` restores), and ``io.CSVIter`` / ``MNISTIter``.

- the serving front and its observability: ``serve.serve_http``
  (``/predict``, streaming ``/generate``, ``/healthz``, ``/metrics``,
  ``/traces``, ``/alerts``) over ``serve.ModelRegistry`` (hot swap, the
  int8 swap and its shadow canary), with ``tracing``, ``fault``,
  ``health`` (MFU gauges, numerics sentinels, SLO alerts) and
  ``blackbox`` (the flight recorder).

Importing the package imports no triton, loads no CUDA library (nor
NVRTC) and touches no GPU.
"""
from . import (autograd, blackbox, callback, checkpoint, config, context,
               convert, executor, fault, health, image, initializer, io,
               lr_scheduler, metric, model, models, module, ndarray, ops,
               optimizer, parallel, quantize, random, recordio, rnn, serve,
               serving, symbol, telemetry, tracing)
from . import operator, rtc  # after ndarray and symbol: adds Custom
from . import gluon
from .base import MXNetError
from .context import (Context, cpu, current_context, default_device, gpu,
                      num_gpus)

nd = ndarray
sym = symbol
mod = module
init = initializer

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "default_device", "autograd", "blackbox",
           "callback", "checkpoint", "config", "context", "convert",
           "executor", "fault", "gluon", "health", "image", "init",
           "initializer", "io",
           "lr_scheduler",
           "metric", "mod", "model", "models", "module", "nd", "ndarray",
           "operator", "ops", "optimizer", "parallel", "quantize", "random",
           "recordio", "rnn", "rtc", "serve", "serving", "sym", "symbol",
           "telemetry", "tracing"]
