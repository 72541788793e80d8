"""Quantized serving: checkpoint -> calibrated int8 artifact -> serving.

Counterpart of the JAX package's ``quantize`` package:

* :mod:`~mxnet_tpu_torch.quantize.calibrate`: activation-range observers
  (:class:`MinMaxObserver`, :class:`PercentileObserver`) over a bound
  internals executor;
* :mod:`~mxnet_tpu_torch.quantize.ptq`: :func:`quantize_checkpoint`,
  checkpoint -> :class:`QuantizedParams` artifact (per-channel int8
  weights, float32 scales, calibrated activation scales, a checksummed
  manifest);
* the int8 compute is ``ops/quantization_ops.py``
  (``_contrib_quantized_fc_int8`` / ``_contrib_quantized_conv_int8``)
  over the hand-written kernels of ``ops/cuda/int8_matmul.py``;
* serving: ``serving.Predictor`` on the artifact, under
  ``serve.InferenceEngine``.

Quick start::

    import mxnet_tpu_torch as mx

    qp = mx.quantize.quantize_checkpoint("ckpt/run7", calib_iter,
                                         calib_mode="naive")
    pred = mx.serving.Predictor(qp.symbol_json, qp.param_bytes(),
                                input_shapes={"data": (1, 3, 224, 224)})
    eng = mx.serve.InferenceEngine(pred).start().warmup()

``serve.ModelRegistry.swap(quantized=...)`` hot-swaps a live server to
the artifact and ``enable_shadow`` canaries it under live traffic first;
``contrib.quantization.quantize_model`` (the reference's triple-op route)
is ROADMAP A11.
"""
from .calibrate import (MinMaxObserver, PercentileObserver, make_observer,
                        collect_activation_ranges)
from .ptq import (QuantizedParams, quantize_checkpoint, quantize_symbol,
                  validate_excluded_names)

__all__ = ["MinMaxObserver", "PercentileObserver", "make_observer",
           "collect_activation_ranges", "QuantizedParams",
           "quantize_checkpoint", "quantize_symbol",
           "validate_excluded_names"]
