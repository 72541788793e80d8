"""VGG 11/13/16/19, with and without BatchNorm, for the Gluon model zoo
(the JAX package's ``gluon/model_zoo/vision/vgg.py``; reference:
python/mxnet/gluon/model_zoo/vision/vgg.py), with its parameter names
and initializers (Xavier convolutions, normal dense layers)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ..model_store import get_model_file
from .... import initializer as init

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg"]


class VGG(HybridBlock):
    """Stages of 3x3 convolutions (``layers[i]`` of ``filters[i]``
    channels), each closed by a 2x2 max pool, then two dense layers of
    4096 with Dropout 0.5 (reference: vgg.py VGG)."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super(VGG, self).__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal"))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal"))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal")

    def _make_features(self, layers, filters, batch_norm):
        featurizer = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3,
                                         padding=1,
                                         weight_initializer=init.Xavier()))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, ctx=None, root="~/.mxnet/models",
            **kwargs):
    """VGG of ``num_layers``; ``pretrained`` loads
    ``<root>/vgg<n>[_bn].params``."""
    layers, filters = vgg_spec[num_layers]
    net = VGG(layers, filters, **kwargs)
    if pretrained:
        suffix = "_bn" if kwargs.get("batch_norm") else ""
        net.load_parameters(get_model_file(
            "vgg%d%s" % (num_layers, suffix), root=root), ctx=ctx)
    return net


def _variant(num_layers, batch_norm):
    def build(**kwargs):
        if batch_norm:
            kwargs["batch_norm"] = True
        return get_vgg(num_layers, **kwargs)
    build.__name__ = "vgg%d%s" % (num_layers, "_bn" if batch_norm else "")
    build.__doc__ = "VGG-%d%s (reference: vgg.py %s)." % (
        num_layers, " with BatchNorm" if batch_norm else "", build.__name__)
    return build


vgg11 = _variant(11, False)
vgg13 = _variant(13, False)
vgg16 = _variant(16, False)
vgg19 = _variant(19, False)
vgg11_bn = _variant(11, True)
vgg13_bn = _variant(13, True)
vgg16_bn = _variant(16, True)
vgg19_bn = _variant(19, True)
