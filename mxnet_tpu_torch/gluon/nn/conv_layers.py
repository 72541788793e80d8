"""Gluon convolution and pooling layers.

Counterpart of the JAX package's ``gluon/nn/conv_layers.py`` (reference:
python/mxnet/gluon/nn/conv_layers.py): ``Conv1D/2D/3D``, ``MaxPool``,
``AvgPool``, ``GlobalMaxPool`` and ``GlobalAvgPool`` in 1, 2 and 3 dims,
NC{W,HW,DHW} layouts, over the registry's ``Convolution`` and
``Pooling`` (cuDNN through ``torch.nn.functional``);
``Conv1D/2D/3DTranspose`` over ``Deconvolution`` (weight ``(in_channels,
channels // groups, *kernel)``, ``output_padding`` as ``adj``) and
``ReflectionPad2D`` over ``Pad`` in reflect mode.
"""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation, _init

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    assert len(v) == n
    return v


class _Conv(HybridBlock):
    """Base convolution layer (reference: conv_layers.py _Conv)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 **kwargs):
        super(_Conv, self).__init__(**kwargs)
        n = len(kernel_size)
        self._channels = channels
        self._in_channels = in_channels
        self._op_name = op_name
        self._kwargs = {
            "kernel": _tup(kernel_size, n), "stride": _tup(strides, n),
            "dilate": _tup(dilation, n), "pad": _tup(padding, n),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = _tup(adj, n)
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels), init=_init(weight_initializer),
                allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=_init(bias_initializer),
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _weight_shape(self, in_channels):
        """Convolution: (channels, in / groups, *k); Deconvolution:
        (in, channels / groups, *k); an unknown ``in_channels`` is 0."""
        groups = self._kwargs["num_group"]
        if self._op_name == "Convolution":
            return (self._channels, in_channels // groups) + \
                self._kwargs["kernel"]
        return (in_channels, self._channels // groups) + \
            self._kwargs["kernel"]

    def infer_shape(self, x, *args):
        self.weight._set_shape_from(self._weight_shape(x.shape[1]))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = getattr(F, self._op_name)(x, weight, bias, **self._kwargs)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        return "%s(%s -> %s, kernel_size=%s, stride=%s)" % (
            self.__class__.__name__, self._in_channels or None,
            self._channels, self._kwargs["kernel"], self._kwargs["stride"])


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super(Conv1D, self).__init__(
            channels, _tup(kernel_size, 1), strides, padding, dilation,
            groups, layout, in_channels, activation, use_bias,
            weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super(Conv2D, self).__init__(
            channels, _tup(kernel_size, 2), strides, padding, dilation,
            groups, layout, in_channels, activation, use_bias,
            weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super(Conv3D, self).__init__(
            channels, _tup(kernel_size, 3), strides, padding, dilation,
            groups, layout, in_channels, activation, use_bias,
            weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super(Conv1DTranspose, self).__init__(
            channels, _tup(kernel_size, 1), strides, padding, dilation,
            groups, layout, in_channels, activation, use_bias,
            weight_initializer, bias_initializer, op_name="Deconvolution",
            adj=output_padding, **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super(Conv2DTranspose, self).__init__(
            channels, _tup(kernel_size, 2), strides, padding, dilation,
            groups, layout, in_channels, activation, use_bias,
            weight_initializer, bias_initializer, op_name="Deconvolution",
            adj=output_padding, **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super(Conv3DTranspose, self).__init__(
            channels, _tup(kernel_size, 3), strides, padding, dilation,
            groups, layout, in_channels, activation, use_bias,
            weight_initializer, bias_initializer, op_name="Deconvolution",
            adj=output_padding, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Pad H and W of an NCHW input by reflection (reference:
    conv_layers.py ReflectionPad2D; op Pad, mode "reflect"); an int pads
    all four sides by that much."""

    def __init__(self, padding=0, **kwargs):
        super(ReflectionPad2D, self).__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)


class _Pooling(HybridBlock):
    """Base pooling layer (reference: conv_layers.py _Pooling)."""

    def __init__(self, n, pool_size, strides, padding, ceil_mode,
                 global_pool, pool_type, count_include_pad=None, **kwargs):
        super(_Pooling, self).__init__(**kwargs)
        pool_size = _tup(pool_size, n)
        self._kwargs = {
            "kernel": pool_size,
            "stride": pool_size if strides is None else _tup(strides, n),
            "pad": _tup(padding, n), "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "%s(size=%s, stride=%s, padding=%s, ceil_mode=%s)" % (
            self.__class__.__name__, self._kwargs["kernel"],
            self._kwargs["stride"], self._kwargs["pad"],
            self._kwargs["pooling_convention"] == "full")


def _pool(name, n, pool_type, default_size):
    def __init__(self, pool_size=default_size, strides=None, padding=0,
                 layout=None, ceil_mode=False, count_include_pad=None,
                 **kwargs):
        if pool_type == "avg" and count_include_pad is None:
            count_include_pad = True
        _Pooling.__init__(self, n, pool_size, strides, padding, ceil_mode,
                          False, pool_type, count_include_pad, **kwargs)
    return type(name, (_Pooling,), {"__init__": __init__,
                                    "__doc__": "%s pooling over %d-d "
                                    "windows." % (pool_type, n)})


def _global_pool(name, n, pool_type):
    def __init__(self, layout=None, **kwargs):
        _Pooling.__init__(self, n, 1, None, 0, True, True, pool_type,
                          **kwargs)
    return type(name, (_Pooling,), {"__init__": __init__,
                                    "__doc__": "Global %s pooling over %d-d "
                                    "inputs." % (pool_type, n)})


MaxPool1D = _pool("MaxPool1D", 1, "max", 2)
MaxPool2D = _pool("MaxPool2D", 2, "max", (2, 2))
MaxPool3D = _pool("MaxPool3D", 3, "max", (2, 2, 2))
AvgPool1D = _pool("AvgPool1D", 1, "avg", 2)
AvgPool2D = _pool("AvgPool2D", 2, "avg", (2, 2))
AvgPool3D = _pool("AvgPool3D", 3, "avg", (2, 2, 2))
GlobalMaxPool1D = _global_pool("GlobalMaxPool1D", 1, "max")
GlobalMaxPool2D = _global_pool("GlobalMaxPool2D", 2, "max")
GlobalMaxPool3D = _global_pool("GlobalMaxPool3D", 3, "max")
GlobalAvgPool1D = _global_pool("GlobalAvgPool1D", 1, "avg")
GlobalAvgPool2D = _global_pool("GlobalAvgPool2D", 2, "avg")
GlobalAvgPool3D = _global_pool("GlobalAvgPool3D", 3, "avg")
