"""Neural-network operators.

Counterpart of the JAX package's ``ops/nn.py`` (FullyConnected :32,
Convolution :62, Deconvolution :89, Pooling :136, UpSampling :199,
BatchNorm :230, LayerNorm :310, InstanceNorm :325, LRN :335, Activation
:353, LeakyReLU :368, softmax / log_softmax / softmin :387-406,
softmax_cross_entropy :409, SoftmaxOutput :475, the regression outputs
:491-540, Dropout :547), with the same names, input slots, attrs and
defaults, so that symbols built here get the same auto-created
variables (``fc1_weight``, ``bn0_moving_mean``) and load the JAX
package's JSON, and the fused ``RNN`` op (:570-700). (SyncBatchNorm is
ROADMAP A8.3, and the contrib resizes A15.)
Convolutions and matrix products go to cuDNN/cuBLAS through
``torch.nn.functional``, as the JAX package left them to XLA; BatchNorm
in training mode to ``F.batch_norm`` without running buffers (its batch
variance is the biased one the JAX op uses; the moving statistics are
updated by the graph evaluator, as in the JAX package); with the moving
statistics to the ``batch_norm_inference`` kernel (``cuda/batch_norm.py``).
``RNN`` reads its weights out of the JAX package's flat vector and runs
one of torch's recurrent calls (``_VF.lstm`` / ``gru`` / ``rnn_tanh`` /
``rnn_relu``: cuDNN on the card, ATen on the host) a layer, as the JAX
package left its ``lax.scan`` to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import _VF

from ..base import MXNetError
from .cuda.batch_norm import _batch_norm_inference_plain, batch_norm_inference
from .registry import alias, register


def _tup(v, n, default):
    if v is None or v == ():
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


# ---------------------------------------------------------------------------
# FullyConnected (reference: src/operator/nn/fully_connected.cc:239)
# ---------------------------------------------------------------------------

@register("FullyConnected", attr_defaults={"num_hidden": 0, "no_bias": False,
                                           "flatten": True})
def _fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                     flatten=True):
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


# ---------------------------------------------------------------------------
# Convolution (reference: src/operator/nn/convolution.cc)
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_NC_LAYOUTS = (None, "NCW", "NCHW", "NCDHW")


@register("Convolution", attr_defaults={
    "kernel": (), "stride": (), "dilate": (), "pad": (), "num_filter": 0,
    "num_group": 1, "no_bias": False, "layout": None, "workspace": 1024,
    "cudnn_tune": None, "cudnn_off": False})
def _convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=0, num_group=1, no_bias=False, layout=None,
                 **_ignored):
    """NCHW in and out, weight (num_filter, C / num_group, *kernel)."""
    nd = len(kernel)
    if nd not in _CONV:
        raise MXNetError("Convolution supports 1/2/3-d kernels")
    if layout not in _NC_LAYOUTS:
        raise MXNetError("Convolution layout %r is not ported (channels-"
                         "first only; ROADMAP A15)" % (layout,))
    return _CONV[nd](data, weight, None if no_bias else bias,
                     _tup(stride, nd, 1), _tup(pad, nd, 0),
                     _tup(dilate, nd, 1), int(num_group))


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution", attr_defaults={
    "kernel": (), "stride": (), "dilate": (), "pad": (), "adj": (),
    "num_filter": 0, "num_group": 1, "no_bias": True, "layout": None,
    "target_shape": (), "workspace": 1024})
def _deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                   pad=(), adj=(), num_filter=0, num_group=1, no_bias=True,
                   layout=None, target_shape=(), **_ignored):
    """Transposed convolution (reference: deconvolution.cc): weight
    (C, num_filter / num_group, *kernel); the output size is
    ``(in - 1) * stride - 2 * pad + dilate * (kernel - 1) + adj + 1``."""
    nd = len(kernel)
    if nd not in _CONV_T:
        raise MXNetError("Deconvolution supports 1/2/3-d kernels")
    if layout not in _NC_LAYOUTS:
        raise MXNetError("Deconvolution layout %r is not ported (channels-"
                         "first only; ROADMAP A15)" % (layout,))
    return _CONV_T[nd](data, weight, None if no_bias else bias,
                       _tup(stride, nd, 1), _tup(pad, nd, 0),
                       _tup(adj, nd, 0), int(num_group), _tup(dilate, nd, 1))


# ---------------------------------------------------------------------------
# Pooling (reference: src/operator/nn/pooling.cc)
# ---------------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_sum(x, kernel, stride):
    """Sum over each window of an already padded input."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(2)
    return _AVG_POOL[len(kernel)](x, kernel, stride, divisor_override=1)


@register("Pooling", attr_defaults={
    "kernel": (), "pool_type": "max", "global_pool": False, "stride": (),
    "pad": (), "pooling_convention": "valid", "count_include_pad": True,
    "cudnn_off": False})
def _pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
             pad=(), pooling_convention="valid", count_include_pad=True,
             **_ignored):
    """Max pads with -inf, avg/sum with 0. ``valid`` floors the output
    size; ``full`` takes its ceiling, padding the high side as far as the
    last window needs (the JAX op's convention, which unlike torch's
    ``ceil_mode`` keeps a last window that starts in the padding).
    ``count_include_pad=False`` averages over the input elements only."""
    nd = data.dim() - 2
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError("Pooling pool_type %r is not ported (max, avg, sum;"
                         " ROADMAP A15)" % (pool_type,))
    if global_pool:
        axes = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    if nd not in _MAX_POOL:
        raise MXNetError("Pooling supports 1/2/3-d windows")
    kernel = _tup(kernel, nd, 1)
    stride = _tup(stride, nd, 1)
    pad = _tup(pad, nd, 0)
    if pooling_convention not in ("valid", "full"):
        raise MXNetError("pooling_convention %r is not ported (valid, full;"
                         " ROADMAP A15)" % (pooling_convention,))
    if (pooling_convention == "valid" and pool_type != "sum"
            and all(p <= k // 2 for p, k in zip(pad, kernel))):
        # torch's own padding: -inf for max; for avg its divisor is the
        # whole window or, without count_include_pad, the input part
        if pool_type == "max":
            return _MAX_POOL[nd](data, kernel, stride, pad)
        return _AVG_POOL[nd](data, kernel, stride, pad,
                             count_include_pad=bool(count_include_pad))
    spans = []                       # F.pad order: last dim first
    for i, (k, s, p) in enumerate(zip(kernel, stride, pad)):
        hi = p
        if pooling_convention == "full":
            in_sz = data.shape[2 + i]
            out_sz = -(-(in_sz + 2 * p - k) // s) + 1
            hi = max(p, (out_sz - 1) * s + k - in_sz - p)
        spans = [p, hi] + spans
    if pool_type == "max":
        return _MAX_POOL[nd](F.pad(data, spans, value=-math.inf), kernel,
                             stride)
    summed = _window_sum(F.pad(data, spans), kernel, stride)
    if pool_type == "sum":
        return summed
    if count_include_pad:
        return summed / math.prod(kernel)
    counts = _window_sum(F.pad(torch.ones_like(data), spans), kernel,
                         stride)
    return summed / counts


@register("UpSampling", attr_defaults={
    "scale": 1, "sample_type": "nearest", "num_filter": 0,
    "multi_input_mode": "concat", "workspace": 512})
def _upsampling(*args, scale=1, sample_type="nearest", num_filter=0,
                multi_input_mode="concat", workspace=512):
    """The first input scaled up by ``scale`` in H and W: each pixel
    repeated (``nearest``), or linear interpolation at half-pixel
    centres (``bilinear``, ``jax.image.resize``'s)."""
    data = args[0]
    s = int(scale)
    if sample_type == "nearest":
        return data.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
    return F.interpolate(data, scale_factor=s, mode="bilinear",
                         align_corners=False)


# ---------------------------------------------------------------------------
# BatchNorm (reference: src/operator/nn/batch_norm.cc)
# ---------------------------------------------------------------------------

def _mean_var_outputs(attrs):
    return 3 if dict(attrs).get("output_mean_var", False) else 1


@register("BatchNorm", num_outputs=_mean_var_outputs,
          attr_defaults={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                         "use_global_stats": False, "output_mean_var": False,
                         "axis": 1, "cudnn_off": False, "train_mode": False})
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, train_mode=False, **_ignored):
    """Returns ``out``, or ``(out, mean, var)`` with ``output_mean_var``:
    the batch's mean and biased variance in training mode, the moving
    ones otherwise. ``fix_gamma`` uses ones for gamma (its gradient is
    then zero). Statistics and the affine run in float32, or in float64
    for float64 data.

    With the moving statistics (inference, ``use_global_stats``) the
    output is ``x * a + b`` per channel, ``a = gamma / sqrt(var + eps)``
    and ``b = beta - mean * a``, each operation correctly rounded: the
    ``batch_norm_inference`` kernel on the card, its plain version on the
    CPU (and for float64), the same bits on both (cuDNN's inference
    kernel does not give them), which keeps a quantized network's int8
    activations the same on both."""
    axis = axis % data.dim()
    x = data if axis == 1 else data.movedim(axis, 1)
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    x32 = x.to(ct)
    train = train_mode and not use_global_stats
    if train:
        if fix_gamma:
            gamma = torch.ones_like(gamma)
        out = F.batch_norm(x32, None, None, gamma.to(ct), beta.to(ct),
                           training=True, eps=eps)
    else:
        bn = batch_norm_inference if ct == torch.float32 \
            else _batch_norm_inference_plain
        out = bn(x32.contiguous(), gamma.to(ct), beta.to(ct),
                 moving_mean.to(ct), moving_var.to(ct), eps, fix_gamma)
    out = out.to(data.dtype)
    if axis != 1:
        out = out.movedim(1, axis)
    if not output_mean_var:
        return out
    if train:
        red = tuple(i for i in range(x32.dim()) if i != 1)
        var, mean = torch.var_mean(x32, dim=red, correction=0)
        return out, mean, var
    return out, moving_mean, moving_var


@register("LayerNorm", num_outputs=_mean_var_outputs,
          attr_defaults={"axis": -1, "eps": 1e-5, "output_mean_var": False})
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Normalized over ``axis`` with the biased variance; ``(out, mean,
    var)`` with ``output_mean_var``."""
    axis = axis % data.dim()
    var, mean = torch.var_mean(data, dim=axis, keepdim=True, correction=0)
    bshape = [data.shape[axis] if i == axis else 1
              for i in range(data.dim())]
    out = (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)
    if output_mean_var:
        return out, mean.squeeze(axis), var.squeeze(axis)
    return out


@register("InstanceNorm", attr_defaults={"eps": 1e-3})
def _instance_norm(data, gamma, beta, eps=1e-3):
    """Normalized over each sample's and channel's spatial axes."""
    red = tuple(range(2, data.dim()))
    var, mean = torch.var_mean(data, dim=red, keepdim=True, correction=0)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


@register("LRN", attr_defaults={"alpha": 1e-4, "beta": 0.75, "knorm": 2.0,
                                "nsize": 5})
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels (reference:
    lrn.cc): ``x / (knorm + alpha / nsize * S)^beta``, ``S`` the sum of
    ``x^2`` over the ``nsize`` channels centred on each, zero past the
    edges."""
    half = int(nsize) // 2
    c = data.shape[1]
    sq = F.pad(torch.square(data).movedim(1, -1), (half, half)).movedim(-1, 1)
    ssum = sq.narrow(1, 0, c)
    for i in range(1, int(nsize)):
        ssum = ssum + sq.narrow(1, i, c)
    return data / torch.pow(knorm + alpha * ssum / nsize, beta)


# ---------------------------------------------------------------------------
# activations / softmax output
# ---------------------------------------------------------------------------

@register("Activation", attr_defaults={"act_type": "relu"})
def _activation(data, act_type="relu"):
    if act_type == "relu":
        return F.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return torch.logaddexp(data, torch.zeros_like(data))
    if act_type == "softsign":
        return F.softsign(data)
    raise MXNetError("unknown act_type %r" % act_type)


_SELU_ALPHA, _SELU_LAMBDA = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU", attr_defaults={"act_type": "leaky", "slope": 0.25,
                                      "lower_bound": 0.125,
                                      "upper_bound": 0.334})
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334):
    """``leaky`` / ``prelu`` (a learned ``gamma`` per channel) /
    ``elu`` / ``selu`` / ``gelu`` (exact, by erf) (reference:
    leaky_relu.cc)."""
    pos = data >= 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(pos, data, g * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_LAMBDA * torch.where(pos, data,
                                          _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    raise MXNetError("unknown LeakyReLU act_type %r" % act_type)


@register("softmax", attr_defaults={"axis": -1, "temperature": None})
def _softmax(data, axis=-1, temperature=None):
    if temperature:
        data = data / temperature
    return torch.softmax(data, dim=axis)


@register("log_softmax", attr_defaults={"axis": -1, "temperature": None})
def _log_softmax(data, axis=-1, temperature=None):
    if temperature:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


@register("softmin", attr_defaults={"axis": -1, "temperature": None})
def _softmin(data, axis=-1, temperature=None):
    if temperature:
        data = data / temperature
    return torch.softmax(-data, dim=axis)


@register("softmax_cross_entropy")
def _softmax_cross_entropy(data, label):
    """The summed cross-entropy of softmax(data) at the labels: a
    scalar (reference: loss_binary_op.cc)."""
    logp = torch.log_softmax(data, dim=-1)
    lab = label.to(torch.int32).to(torch.int64)
    return -torch.gather(logp, -1, lab[:, None]).sum()


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax whose gradient is ``(softmax - onehot(label)) * scale``
    whatever the head gradient (reference:
    src/operator/softmax_output-inl.h; the JAX op's custom VJP,
    ``_softmax_output_core`` ops/nn.py:433)."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        out = torch.softmax(data, dim=1 if attrs["multi_output"] else -1)
        ctx.save_for_backward(out, label)
        ctx.attrs = attrs
        return out

    @staticmethod
    def backward(ctx, _head_grad):
        out, label = ctx.saved_tensors
        a = ctx.attrs
        axis = 1 if a["multi_output"] else out.dim() - 1
        depth = out.shape[axis]
        lab = label.long().unsqueeze(axis)    # astype(int32): truncation
        classes = torch.arange(depth, device=out.device).view(
            [depth if i == axis else 1 for i in range(out.dim())])
        oh = (lab == classes).to(out.dtype)   # out-of-range: all zeros
        if a["smooth_alpha"]:
            oh = oh * (1.0 - a["smooth_alpha"]) \
                + a["smooth_alpha"] / (depth - 1) * (1.0 - oh)
        grad = out - oh
        if a["use_ignore"]:
            keep = (label != a["ignore_label"]).to(out.dtype)
            if keep.dim() < grad.dim():
                keep = keep.unsqueeze(axis)
            grad = grad * keep
        scale = a["grad_scale"]
        if a["normalization"] == "batch":
            scale = scale / out.shape[0]
        if a["normalization"] == "valid" and a["use_ignore"]:
            valid = torch.clamp((label != a["ignore_label"]).sum(), min=1)
            scale = scale / valid
        return grad * scale, None, None


@register("SoftmaxOutput", attr_defaults={
    "grad_scale": 1.0, "ignore_label": -1.0, "multi_output": False,
    "use_ignore": False, "preserve_shape": False, "normalization": "null",
    "out_grad": False, "smooth_alpha": 0.0})
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False, preserve_shape=False,
                    normalization="null", out_grad=False, smooth_alpha=0.0):
    return _SoftmaxOutput.apply(data, label, {
        "grad_scale": float(grad_scale), "ignore_label": float(ignore_label),
        "multi_output": bool(multi_output), "use_ignore": bool(use_ignore),
        "normalization": str(normalization),
        "smooth_alpha": float(smooth_alpha)})


alias("Softmax", "SoftmaxOutput")


# ---------------------------------------------------------------------------
# regression outputs: the reference's gradient, not their forward's
# ---------------------------------------------------------------------------

class _RegressionOutput(torch.autograd.Function):
    """``forward(data)`` with the gradient ``grad(out, label) *
    grad_scale`` whatever the head gradient (reference:
    regression_output-inl.h; the JAX ops' custom VJPs)."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad, grad_scale):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.grad, ctx.grad_scale = grad, grad_scale
        return out

    @staticmethod
    def backward(ctx, _head_grad):
        out, label = ctx.saved_tensors
        g = ctx.grad(out, label.reshape(out.shape)) * ctx.grad_scale
        return g, None, None, None, None


def _regression(name, fwd, grad):
    def _g(data, label, grad_scale=1.0):
        return _RegressionOutput.apply(data, label, fwd, grad,
                                       float(grad_scale))
    register(name, attr_defaults={"grad_scale": 1.0})(_g)


_regression("LinearRegressionOutput", lambda d: d.clone(),
            lambda o, l: o - l)
_regression("LogisticRegressionOutput", torch.sigmoid, lambda o, l: o - l)
_regression("MAERegressionOutput", lambda d: d.clone(),
            lambda o, l: torch.sign(o - l))


# ---------------------------------------------------------------------------
# Dropout (reference: src/operator/nn/dropout.cc)
# ---------------------------------------------------------------------------

@register("Dropout", needs_rng=True,
          attr_defaults={"p": 0.5, "mode": "training", "axes": (),
                         "train_mode": False})
def _dropout(gen, data, p=0.5, mode="training", axes=(), train_mode=False,
             **_ignored):
    """In training (or ``mode="always"``) each value kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``, else zero; with
    ``axes`` one draw is shared along those axes. The mask is drawn from
    ``gen``, the port's generator of the data's device; outside training
    and at ``p = 0`` the identity. On meta tensors (shape inference)
    nothing is drawn."""
    if (not train_mode and mode != "always") or p <= 0.0 \
            or data.device.type == "meta":
        return data
    shape = tuple(1 if i in axes else s for i, s in enumerate(data.shape))
    keep = 1.0 - p
    draw = torch.rand(shape, generator=gen, device=data.device)
    mask = (draw < keep).to(data.dtype) / keep
    return data * mask


# ---------------------------------------------------------------------------
# Fused RNN (reference: src/operator/rnn.cc; the JAX package's ops/nn.py:570)
# ---------------------------------------------------------------------------

def _rnn_num_outputs(attrs):
    a = dict(attrs)
    if not a.get("state_outputs", False):
        return 1
    return 3 if a.get("mode", "lstm") == "lstm" else 2


def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode,
                   projection_size=None):
    """Length of the flat parameter vector: per layer and direction W
    (gates * state, input), R (gates * state, output), bW, bR, and with
    LSTMP ``projection_size`` P (projection, state)."""
    g = _gates(mode)
    dirs = 2 if bidirectional else 1
    hout = projection_size if projection_size else state_size
    size = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else hout * dirs
        size += dirs * g * state_size * (isz + hout + 2)
        if projection_size:
            size += dirs * projection_size * state_size
    return size


def _unpack_rnn_params(params, num_layers, input_size, state_size,
                       bidirectional, mode, projection_size=None):
    """``[[(W, R, bW, bR, P or None) per direction] per layer]``, views of
    the flat vector in the JAX package's layout (ops/nn.py:597)."""
    g = _gates(mode)
    dirs = 2 if bidirectional else 1
    hout = projection_size if projection_size else state_size
    offset = 0
    layers = []

    def take(n, shape):
        nonlocal offset
        t = params[offset: offset + n].reshape(shape)
        offset += n
        return t

    for layer in range(num_layers):
        isz = input_size if layer == 0 else hout * dirs
        per_dir = []
        for _ in range(dirs):
            W = take(g * state_size * isz, (g * state_size, isz))
            R = take(g * state_size * hout, (g * state_size, hout))
            bW = take(g * state_size, (g * state_size,))
            bR = take(g * state_size, (g * state_size,))
            P = take(projection_size * state_size,
                     (projection_size, state_size)) \
                if projection_size else None
            per_dir.append((W, R, bW, bR, P))
        layers.append(per_dir)
    if offset != params.shape[0]:
        raise MXNetError("RNN: %d parameters, the layers take %d"
                         % (params.shape[0], offset))
    return layers


_RNN_CALLS = {"lstm": _VF.lstm, "gru": _VF.gru, "rnn_tanh": _VF.rnn_tanh,
              "rnn_relu": _VF.rnn_relu}


@register("RNN", num_outputs=_rnn_num_outputs, needs_rng=True,
          attr_defaults={"state_size": 0, "num_layers": 1,
                         "bidirectional": False, "mode": "lstm", "p": 0.0,
                         "state_outputs": False, "projection_size": None,
                         "train_mode": False})
def _rnn(gen, data, params, state, *maybe_cell, state_size=0, num_layers=1,
         bidirectional=False, mode="lstm", p=0.0, state_outputs=False,
         projection_size=None, train_mode=False, **_ignored):
    """Multilayer RNN over time, layout TNC (reference: rnn.cc): the LSTM
    gates i, f, g, o, the GRU's r, z, n with bR inside ``r *``, as the
    JAX op's (:629) and torch's own. One torch recurrent call a layer
    (both directions in it, no dropout in it); inter-layer dropout ``p``
    masks the input of layers 1..L-1 in training only, from ``gen`` (the
    port's generator), as the JAX op does (:681-686). ``state`` is
    (layers * dirs, N, output), an LSTM's ``state_cell`` (layers * dirs,
    N, state_size); ``state_outputs`` adds the final states."""
    T, N, I = data.shape
    H = int(state_size)
    dirs = 2 if bidirectional else 1
    if projection_size and mode != "lstm":
        raise MXNetError("projection_size is only supported for lstm")
    if projection_size == H:
        raise MXNetError("projection_size must differ from state_size")
    hout = projection_size if projection_size else H
    cell = maybe_cell[0] if (mode == "lstm" and maybe_cell) else None
    if mode == "lstm" and cell is None:
        raise MXNetError("RNN(mode='lstm') takes a state_cell input")
    n_out = _rnn_num_outputs({"state_outputs": state_outputs, "mode": mode})
    if data.device.type == "meta":
        outs = [data.new_empty((T, N, hout * dirs)),
                data.new_empty((num_layers * dirs, N, hout)),
                data.new_empty((num_layers * dirs, N, H))]
        return tuple(outs[:n_out]) if state_outputs else outs[0]
    layers = _unpack_rnn_params(params, num_layers, I, H, bidirectional,
                                mode, projection_size)
    call = _RNN_CALLS[mode]
    train = torch.is_grad_enabled()
    x, hs, cs = data, [], []
    for li, per_dir in enumerate(layers):
        if li > 0 and p > 0.0 and train_mode:
            keep = 1.0 - p
            draw = torch.rand(x.shape, generator=gen, device=x.device)
            x = x * ((draw < keep).to(x.dtype) / keep)
        weights = [t for d in per_dir for t in d if t is not None]
        h0 = state[li * dirs:(li + 1) * dirs]
        if mode == "lstm":
            x, h, c = call(x, (h0, cell[li * dirs:(li + 1) * dirs]),
                           weights, True, 1, 0.0, train, dirs == 2, False)
            cs.append(c)
        else:
            x, h = call(x, h0, weights, True, 1, 0.0, train, dirs == 2,
                        False)
        hs.append(h)
    if not state_outputs:
        return x
    if mode == "lstm":
        return x, torch.cat(hs, 0), torch.cat(cs, 0)
    return x, torch.cat(hs, 0)
