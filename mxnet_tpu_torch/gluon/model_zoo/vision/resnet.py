"""ResNet v1 and v2 for the Gluon model zoo.

Counterpart of the JAX package's ``gluon/model_zoo/vision/resnet.py``
(reference: python/mxnet/gluon/model_zoo/vision/resnet.py), the same
code: depths 18/34/50/101/152 in the post-activation (v1) and
pre-activation (v2) arrangements, table-driven (``_UNIT_TABLE``: each
conv of a residual unit as (kernel, takes_stride, padding,
channel_divisor, with_bias)), with the reference's parameter names, so a
net made under the same prefix has the same parameter names in both
packages. The v1 bottleneck strides its first (1x1) conv and keeps the
biases of its 1x1 convs, as the reference does.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ..model_store import get_model_file

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


# Conv rows per residual unit: (kernel, takes_stride, padding,
# channel_divisor, with_bias). The unit's output channel count divided
# by ``channel_divisor`` gives the conv width; ``takes_stride`` marks
# where the unit's stride is applied (v1 strides its first conv, v2
# bottlenecks stride the middle 3x3 — the reference's arrangement).
_UNIT_TABLE = {
    (1, "basic"): ((3, True, 1, 1, False), (3, False, 1, 1, False)),
    (1, "bottleneck"): ((1, True, 0, 4, True), (3, False, 1, 4, False),
                        (1, False, 0, 1, True)),
    (2, "basic"): ((3, True, 1, 1, False), (3, False, 1, 1, False)),
    (2, "bottleneck"): ((1, False, 0, 4, False), (3, True, 1, 4, False),
                        (1, False, 0, 1, False)),
}


def _unit_conv(row, channels, stride, in_channels=0):
    kernel, takes_stride, pad, div, bias = row
    return nn.Conv2D(channels // div, kernel_size=kernel,
                     strides=stride if takes_stride else 1, padding=pad,
                     use_bias=bias, in_channels=in_channels)


class _Unit(HybridBlock):
    """One residual unit interpreting a ``_UNIT_TABLE`` row.

    v1 wraps conv/BN pairs in a ``body`` Sequential with the ReLU
    between pairs and adds the skip AFTER the last BN; v2 registers
    BN->ReLU->conv triples flat (pre-activation) and draws the skip
    from the first activation. Child registration order matches the
    reference blocks so auto-generated parameter names line up."""

    def __init__(self, version, kind, channels, stride, downsample=False,
                 in_channels=0, **kwargs):
        super(_Unit, self).__init__(**kwargs)
        self._version = version
        rows = _UNIT_TABLE[(version, kind)]
        if version == 1:
            self.body = nn.HybridSequential(prefix="")
            for i, row in enumerate(rows):
                ic = in_channels if i == 0 and row[0] == 3 else 0
                self.body.add(_unit_conv(row, channels, stride, ic))
                self.body.add(nn.BatchNorm())
                if i + 1 < len(rows):
                    self.body.add(nn.Activation("relu"))
            if downsample:
                self.downsample = nn.HybridSequential(prefix="")
                self.downsample.add(nn.Conv2D(
                    channels, kernel_size=1, strides=stride,
                    use_bias=False, in_channels=in_channels))
                self.downsample.add(nn.BatchNorm())
            else:
                self.downsample = None
        else:
            self._steps = []
            for i, row in enumerate(rows):
                bn = nn.BatchNorm()
                ic = in_channels if i == 0 and row[0] == 3 else 0
                conv = _unit_conv(row, channels, stride, ic)
                setattr(self, "bn%d" % (i + 1), bn)
                setattr(self, "conv%d" % (i + 1), conv)
                self._steps.append((bn, conv))
            if downsample:
                self.downsample = nn.Conv2D(
                    channels, 1, stride, use_bias=False,
                    in_channels=in_channels)
            else:
                self.downsample = None

    def hybrid_forward(self, F, x):
        if self._version == 1:
            shortcut = x if self.downsample is None else self.downsample(x)
            return F.Activation(self.body(x) + shortcut, act_type="relu")
        shortcut = x
        for i, (bn, conv) in enumerate(self._steps):
            x = F.Activation(bn(x), act_type="relu")
            if i == 0 and self.downsample is not None:
                shortcut = self.downsample(x)
            x = conv(x)
        return x + shortcut


def BasicBlockV1(channels, stride, downsample=False, in_channels=0,
                 **kwargs):
    """Reference parity: resnet.py BasicBlockV1 (resnet 18/34 v1)."""
    return _Unit(1, "basic", channels, stride, downsample, in_channels,
                 **kwargs)


def BottleneckV1(channels, stride, downsample=False, in_channels=0,
                 **kwargs):
    """Reference parity: resnet.py BottleneckV1 (resnet 50/101/152 v1)."""
    return _Unit(1, "bottleneck", channels, stride, downsample,
                 in_channels, **kwargs)


def BasicBlockV2(channels, stride, downsample=False, in_channels=0,
                 **kwargs):
    """Reference parity: resnet.py BasicBlockV2 (pre-activation)."""
    return _Unit(2, "basic", channels, stride, downsample, in_channels,
                 **kwargs)


def BottleneckV2(channels, stride, downsample=False, in_channels=0,
                 **kwargs):
    """Reference parity: resnet.py BottleneckV2."""
    return _Unit(2, "bottleneck", channels, stride, downsample,
                 in_channels, **kwargs)


class _ResNet(HybridBlock):
    """Stem + staged residual units + classifier, for either version.

    version 2 brackets the stages with the extra featureless BatchNorm
    up front and BN->ReLU after (the pre-activation arrangement needs
    its own final activation before pooling)."""

    version = None

    def __init__(self, kind, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super(_ResNet, self).__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        v = self.version
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if v == 2:
                self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(nn.Conv2D(channels[0], 3, 1, 1,
                                            use_bias=False, in_channels=0))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_ch = channels[0]
            for i, n_units in enumerate(layers):
                stage = nn.HybridSequential(prefix="stage%d_" % (i + 1))
                out_ch = channels[i + 1]
                with stage.name_scope():
                    for j in range(n_units):
                        stage.add(_Unit(
                            v, kind, out_ch,
                            stride=(2 if i > 0 and j == 0 else 1),
                            downsample=(j == 0 and out_ch != in_ch),
                            in_channels=in_ch if j == 0 else out_ch,
                            prefix=""))
                self.features.add(stage)
                in_ch = out_ch
            if v == 2:
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            if v == 2:
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_ch)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
    """Reference parity: resnet.py ResNetV1 (accepts a block factory
    like the reference's class argument; the factory selects the
    _UNIT_TABLE row)."""

    version = 1

    def __init__(self, block, layers, channels, **kwargs):
        kind = "bottleneck" if block is BottleneckV1 else "basic"
        super(ResNetV1, self).__init__(kind, layers, channels, **kwargs)


class ResNetV2(_ResNet):
    """Reference parity: resnet.py ResNetV2."""

    version = 2

    def __init__(self, block, layers, channels, **kwargs):
        kind = "bottleneck" if block is BottleneckV2 else "basic"
        super(ResNetV2, self).__init__(kind, layers, channels, **kwargs)


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None,
               root="~/.mxnet/models", **kwargs):
    """Reference: resnet.py get_resnet."""
    assert num_layers in resnet_spec, \
        "Invalid resnet depth %d; options: %s" % (
            num_layers, sorted(resnet_spec))
    assert version in (1, 2)
    block_type, layers, channels = resnet_spec[num_layers]
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    net = resnet_class(block_class, layers, channels, **kwargs)
    if pretrained:
        net.load_parameters(get_model_file(
            "resnet%d_v%d" % (num_layers, version), root=root), ctx=ctx)
    return net


def _variant(version, num_layers):
    def build(**kwargs):
        return get_resnet(version, num_layers, **kwargs)
    build.__name__ = "resnet%d_v%d" % (num_layers, version)
    build.__doc__ = "ResNet-%d v%d (reference: resnet.py %s)." % (
        num_layers, version, build.__name__)
    return build


resnet18_v1 = _variant(1, 18)
resnet34_v1 = _variant(1, 34)
resnet50_v1 = _variant(1, 50)
resnet101_v1 = _variant(1, 101)
resnet152_v1 = _variant(1, 152)
resnet18_v2 = _variant(2, 18)
resnet34_v2 = _variant(2, 34)
resnet50_v2 = _variant(2, 50)
resnet101_v2 = _variant(2, 101)
resnet152_v2 = _variant(2, 152)
