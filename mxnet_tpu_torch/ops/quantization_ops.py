"""INT8 quantization operators.

Counterpart of the JAX package's ``ops/quantization_ops.py``, with the
same names, inputs, attrs and arithmetic:

* the reference's ``(out, min, max)`` triple ops (``_contrib_quantize``,
  ``_quantize_v2``, ``_dequantize``, ``_requantize``,
  ``_quantized_fully_connected``, ``_quantized_conv``,
  ``_quantized_pooling``, ``_quantized_flatten``), plain tensor code:
  their int32 products are summed in float64, which is exact at these
  sizes, then cast, as the JAX package's int32 dots and convolutions;
* the per-channel serving pair of quantized checkpoints
  (``_contrib_quantized_fc_int8``, ``_contrib_quantized_conv_int8``):
  int8 activations from a static calibrated scale, int8 weights with a
  float32 scale per output channel, one int8 product whose rescale is
  its kernel's epilogue. The dense op runs ``int8_matmul``; the 2-D
  convolution always runs ``int8_conv_im2col``, the TPU's route (both of
  ``ops/cuda/int8_matmul.py``; on CPU tensors their plain versions, which
  equal both JAX routes bitwise). 1-D and 3-D int8 convolutions, which
  the JAX package leaves to XLA, are an exact float64 convolution here
  on either device.

``out_scale`` is ``w_scale * f32(1 / act_scale)``: the JAX op writes
``w_scale / act_scale``, but every JAX graph (the executor and the
Predictor jit it) has XLA fold the division by the static ``act_scale``
into a multiply by its float32 reciprocal, which differs from a true
division in the last bit of about one value in five. The port computes
what the JAX package serves, the same on the CPU and the card (the
reciprocal is taken once, in numpy). The bias is a separate, rounded
add, as the op is written (XLA on the CPU may contract it with the
rescale into one fused multiply-add)."""
from __future__ import annotations

import numpy as np
import torch

from .cuda import int8_matmul as _i8
from .registry import get_op, register

_INT8_MIN, _INT8_MAX = -127.0, 127.0
_I32_MAX = 2.0 ** 31 - 1


def _f32(v, like):
    """``v`` as a float32 tensor beside ``like`` (a 0-dim tensor stays
    one; a Python number becomes one)."""
    if isinstance(v, torch.Tensor):
        return v.to(like.device, torch.float32)
    return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                        device=like.device)


def _safe_div(num, denom):
    """``num / denom`` with a zero denominator mapping to 1.0, the
    denominator substituted before the division (no inf/NaN branch)."""
    pos = denom > 0
    safe = torch.where(pos, denom, torch.ones_like(denom))
    return torch.where(pos, num / safe, torch.ones_like(denom))


def _range_scale(min_r, max_r):
    """127 / amax for a (min, max) range; 1.0 for a zero range."""
    amax = torch.maximum(min_r.abs(), max_r.abs())
    return _safe_div(torch.full_like(amax, _INT8_MAX), amax)


def _to_int8(x, memory_format=torch.contiguous_format):
    """``clip(round(x), -127, 127)`` as int8, written in ``memory_format``
    (the cast and the layout change are one copy either way)."""
    return torch.clamp(torch.round(x), _INT8_MIN, _INT8_MAX).to(
        torch.int8, memory_format=memory_format)


def _to_int32(x):
    """Round to int32, saturating as XLA's float-to-int conversion does
    (2^31 - 1 as float32 is 2^31, the top of every requantized range)."""
    return torch.round(x).to(torch.int64).clamp(
        -2 ** 31, 2 ** 31 - 1).to(torch.int32)


def _scalar(t):
    return t.reshape(())


@register("_contrib_quantize", num_outputs=3,
          attr_defaults={"out_type": "int8"})
def _quantize(data, min_range, max_range, out_type="int8", **_ig):
    """fp32 -> int8 with an explicit range (reference: quantize.cc).
    Returns (q, min, max)."""
    scale = _range_scale(min_range.float(), max_range.float())
    return (_to_int8(data * scale), _scalar(min_range),
            _scalar(max_range))


@register("_contrib_quantize_v2", num_outputs=3,
          attr_defaults={"out_type": "int8", "min_calib_range": None,
                         "max_calib_range": None})
def _quantize_v2(data, out_type="int8", min_calib_range=None,
                 max_calib_range=None, **_ig):
    """fp32 -> int8, the range from calibration or the data itself
    (reference: quantize_v2.cc)."""
    if min_calib_range is not None and max_calib_range is not None:
        mn, mx = _f32(min_calib_range, data), _f32(max_calib_range, data)
    else:
        mn, mx = data.min(), data.max()
    scale = _range_scale(mn, mx)
    return _to_int8(data * scale), _scalar(mn), _scalar(mx)


@register("_contrib_dequantize", attr_defaults={"out_type": "float32"})
def _dequantize(data, min_range, max_range, out_type="float32", **_ig):
    """int8 -> fp32 (reference: dequantize.cc)."""
    scale = _range_scale(min_range.float(), max_range.float())
    return data.float() / scale


@register("_contrib_requantize", num_outputs=3,
          attr_defaults={"min_calib_range": None, "max_calib_range": None})
def _requantize(data, min_range, max_range, min_calib_range=None,
                max_calib_range=None, **_ig):
    """int32 accumulators -> int8 (reference: requantize.cc)."""
    amax = torch.maximum(min_range.float().abs(), max_range.float().abs())
    real = data.float() * (amax / torch.full_like(amax, _I32_MAX))
    if min_calib_range is not None:
        mn, mx = _f32(min_calib_range, data), _f32(max_calib_range, data)
    else:
        mn, mx = real.min(), real.max()
    scale = _range_scale(mn, mx)
    return _to_int8(real * scale), _scalar(mn), _scalar(mx)


def _q_range_out(acc, min_a, max_a, min_b, max_b):
    """Real values of an int32 sum of int8 * int8 products."""
    scale_a = _range_scale(min_a.float(), max_a.float())
    scale_b = _range_scale(min_b.float(), max_b.float())
    return acc.float() / (scale_a * scale_b)


def _requantize_int32(real):
    """(q32, min, max): ``real`` over its own range in int32."""
    mn, mx = real.min(), real.max()
    amax = torch.maximum(mn.abs(), mx.abs())
    scale = _safe_div(torch.full_like(amax, _I32_MAX), amax)
    return _to_int32(real * scale), _scalar(mn), _scalar(mx)


@register("_contrib_quantized_fully_connected", num_outputs=3,
          attr_defaults={"num_hidden": 0, "no_bias": False, "flatten": True})
def _quantized_fc(*arrays, num_hidden=0, no_bias=False, flatten=True,
                  **_ig):
    """INT8 FC with int32 sums (reference: quantized_fully_connected.cc).
    Inputs: data, weight[, bias], min_data, max_data, min_weight,
    max_weight[, min_bias, max_bias]."""
    if no_bias or len(arrays) == 6:
        data, weight, min_data, max_data, min_weight, max_weight = arrays
        bias = None
    else:
        (data, weight, bias, min_data, max_data, min_weight, max_weight,
         min_bias, max_bias) = arrays
    x = data
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    acc = (x.double() @ weight.double().t()).to(torch.int32)
    real = _q_range_out(acc, min_data, max_data, min_weight, max_weight)
    if bias is not None:
        real = real + bias.float() / _range_scale(min_bias.float(),
                                                  max_bias.float())
    return _requantize_int32(real)


def _conv_attrs(kernel, stride, dilate, pad):
    nd = len(kernel)
    return (tuple(int(v) for v in stride) or (1,) * nd,
            tuple(int(v) for v in dilate) or (1,) * nd,
            tuple(int(v) for v in pad) or (0,) * nd)


@register("_contrib_quantized_conv", num_outputs=3,
          attr_defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                         "num_filter": 0, "num_group": 1, "no_bias": True,
                         "layout": None})
def _quantized_conv(data, weight, min_data, max_data, min_weight,
                    max_weight, kernel=(), stride=(), dilate=(), pad=(),
                    num_filter=0, num_group=1, no_bias=True, layout=None,
                    **_ig):
    """INT8 convolution (reference: quantized_conv.cc)."""
    stride, dilate, pad = _conv_attrs(kernel, stride, dilate, pad)
    acc = _i8.exact_conv(data, weight, stride, dilate, pad, num_group)
    real = _q_range_out(acc, min_data, max_data, min_weight, max_weight)
    return _requantize_int32(real)


@register("_contrib_quantized_pooling", num_outputs=3,
          attr_defaults={"kernel": (), "pool_type": "max",
                         "global_pool": False, "stride": (), "pad": (),
                         "pooling_convention": "valid"})
def _quantized_pooling(data, min_data, max_data, kernel=(), pool_type="max",
                       global_pool=False, stride=(), pad=(),
                       pooling_convention="valid", **_ig):
    """INT8 pooling (reference: quantized_pooling.cc): pooled in float32,
    cast back; the range passes through."""
    out = get_op("Pooling").fn(data.float(), kernel=kernel,
                               pool_type=pool_type, global_pool=global_pool,
                               stride=stride, pad=pad,
                               pooling_convention=pooling_convention)
    return out.to(data.dtype), _scalar(min_data), _scalar(max_data)


@register("_contrib_quantized_flatten", num_outputs=3)
def _quantized_flatten(data, min_data, max_data):
    return (data.reshape(data.shape[0], -1), _scalar(min_data),
            _scalar(max_data))


# ---------------------------------------------------------------------------
# per-channel serving ops (quantize/ptq.py artifacts)
# ---------------------------------------------------------------------------

def _quantize_act(data, act_scale, memory_format=torch.contiguous_format):
    """fp32 activations -> int8 with a static calibrated scale:
    ``clip(round(x * f32(act_scale)), -127, 127)``, half to even, written
    in ``memory_format`` (``torch.channels_last`` for the convolutions
    that the wgmma route of ``int8_conv_im2col`` takes)."""
    return _to_int8(data.float() * float(np.float32(act_scale)),
                    memory_format)


def _out_scale(scale, act_scale):
    """``w_scale * f32(1 / act_scale)``, the rescale the JAX package's
    graphs compute (see the module docstring)."""
    scale = scale.float()
    recip = np.float32(1.0) / np.float32(act_scale)
    return scale * torch.full_like(scale, float(recip))


@register("_contrib_quantized_fc_int8",
          attr_defaults={"num_hidden": 0, "no_bias": False, "flatten": True,
                         "act_scale": 1.0})
def _quantized_fc_int8(data, weight, scale, bias=None, num_hidden=0,
                       no_bias=False, flatten=True, act_scale=1.0, **_ig):
    """Per-channel INT8 fully connected for quantized serving:
    ``(q . weight^T) * (scale / act_scale) + bias`` with ``q =
    round(data * act_scale)`` int8, ``weight`` int8 ``(num_hidden, k)``,
    ``scale`` its float32 per-channel scales; the rescale is the
    ``int8_matmul`` kernel's epilogue, the bias added after it."""
    x = data
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    lead = tuple(x.shape[:-1])
    q = _quantize_act(x.reshape(-1, x.shape[-1]), act_scale)
    out = _i8.int8_matmul(q, weight.to(torch.int8).contiguous(),
                          _out_scale(scale, act_scale))
    if bias is not None and not no_bias:
        out = out + bias.float()
    return out.reshape(lead + (out.shape[-1],))


@register("_contrib_quantized_conv_int8",
          attr_defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                         "num_filter": 0, "num_group": 1, "no_bias": False,
                         "layout": None, "act_scale": 1.0})
def _quantized_conv_int8(data, weight, scale, bias=None, kernel=(),
                         stride=(), dilate=(), pad=(), num_filter=0,
                         num_group=1, no_bias=False, layout=None,
                         act_scale=1.0, **_ig):
    """Per-channel INT8 convolution for quantized serving (NCHW-family
    layouts; channel = filter axis 0), the scale contract of
    ``_contrib_quantized_fc_int8``. 2-D: the ``int8_conv_im2col`` kernel
    with the rescale in its epilogue. Where its wgmma route takes the
    shape, the activations are quantized into channels-last memory and
    the weights are used in the memory format they come in (the
    Predictor binds them channels-last), so neither is copied again."""
    nd = len(kernel)
    stride, dilate, pad = _conv_attrs(kernel, stride, dilate, pad)
    wq = weight.to(torch.int8)
    fmt = torch.contiguous_format
    if nd == 2 and _i8.conv_wgmma_shape_ok(wq.shape, stride, dilate, pad,
                                           num_group):
        fmt = torch.channels_last
    q = _quantize_act(data, act_scale, fmt)
    out_scale = _out_scale(scale, act_scale)
    chan = (1, -1) + (1,) * nd
    if nd == 2:
        out = _i8.int8_conv_im2col(q, wq, out_scale, stride, dilate, pad,
                                   num_group)
    else:
        wq = wq.contiguous()
        acc = _i8.exact_conv(q, wq, stride, dilate, pad, num_group)
        out = acc.float() * out_scale.reshape(chan)
    if bias is not None and not no_bias:
        out = out + bias.float().reshape(chan)
    return out
