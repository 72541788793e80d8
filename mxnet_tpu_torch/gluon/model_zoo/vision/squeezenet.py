"""SqueezeNet 1.0 and 1.1 for the Gluon model zoo (the JAX package's
``gluon/model_zoo/vision/squeezenet.py``; reference:
python/mxnet/gluon/model_zoo/vision/squeezenet.py), with its parameter
names."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ..model_store import get_model_file

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    out.add(_FireExpand(expand1x1_channels, expand3x3_channels))
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class _FireExpand(HybridBlock):
    """A fire module's 1x1 and 3x3 expansions, concatenated on
    channels."""

    def __init__(self, expand1x1_channels, expand3x3_channels, **kwargs):
        super(_FireExpand, self).__init__(**kwargs)
        self.p1 = _make_fire_conv(expand1x1_channels, 1)
        self.p3 = _make_fire_conv(expand3x3_channels, 3, 1)

    def hybrid_forward(self, F, x):
        return F.Concat(self.p1(x), self.p3(x), dim=1)


# each row: ("conv", channels, kernel, stride), "pool" (3x3 stride 2,
# ceil mode) or ("fire", squeeze, expand 1x1, expand 3x3)
_SPEC = {
    "1.0": (("conv", 96, 7, 2), "pool", ("fire", 16, 64, 64),
            ("fire", 16, 64, 64), ("fire", 32, 128, 128), "pool",
            ("fire", 32, 128, 128), ("fire", 48, 192, 192),
            ("fire", 48, 192, 192), ("fire", 64, 256, 256), "pool",
            ("fire", 64, 256, 256)),
    "1.1": (("conv", 64, 3, 2), "pool", ("fire", 16, 64, 64),
            ("fire", 16, 64, 64), "pool", ("fire", 32, 128, 128),
            ("fire", 32, 128, 128), "pool", ("fire", 48, 192, 192),
            ("fire", 48, 192, 192), ("fire", 64, 256, 256),
            ("fire", 64, 256, 256)),
}


class SqueezeNet(HybridBlock):
    """Reference: squeezenet.py SqueezeNet."""

    def __init__(self, version, classes=1000, **kwargs):
        super(SqueezeNet, self).__init__(**kwargs)
        assert version in _SPEC, \
            "Unsupported SqueezeNet version %s: 1.0 or 1.1 expected" % version
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for row in _SPEC[version]:
                if row == "pool":
                    self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                elif row[0] == "conv":
                    self.features.add(nn.Conv2D(row[1], kernel_size=row[2],
                                                strides=row[3]))
                    self.features.add(nn.Activation("relu"))
                else:
                    self.features.add(_make_fire(*row[1:]))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=None,
                   root="~/.mxnet/models", **kwargs):
    """SqueezeNet ``version``; ``pretrained`` loads
    ``<root>/squeezenet<version>.params``."""
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        net.load_parameters(get_model_file("squeezenet%s" % version,
                                           root=root), ctx=ctx)
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
