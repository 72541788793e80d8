"""Symbolic VGG 11/13/16/19 (Simonyan & Zisserman 2014; reference:
example/image-classification/symbols/vgg.py).

The JAX package's ``models/vgg.py`` over this package's symbol API,
with the same layer names, so the same argument and auxiliary-state
names. ``dtype`` is accepted and, as there, builds the same float32
graph whatever it is.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol"]

_STAGES = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}
_FILTERS = (64, 128, 256, 512, 512)


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False,
               dtype="float32"):
    if num_layers not in _STAGES:
        raise ValueError("vgg depth must be one of %s" % (sorted(_STAGES),))
    data = sym.Variable("data")
    x = data
    for s, (reps, nf) in enumerate(zip(_STAGES[num_layers], _FILTERS)):
        for r in range(reps):
            name = "conv%d_%d" % (s + 1, r + 1)
            x = sym.Convolution(x, name=name, num_filter=nf, kernel=(3, 3),
                                pad=(1, 1))
            if batch_norm:
                x = sym.BatchNorm(x, name=name + "_bn")
            x = sym.Activation(x, name=name + "_relu", act_type="relu")
        x = sym.Pooling(x, name="pool%d" % (s + 1), kernel=(2, 2),
                        stride=(2, 2), pool_type="max")
    x = sym.Flatten(x)
    for i in (6, 7):
        x = sym.FullyConnected(x, name="fc%d" % i, num_hidden=4096)
        x = sym.Activation(x, name="relu%d" % i, act_type="relu")
        x = sym.Dropout(x, name="drop%d" % i, p=0.5)
    x = sym.FullyConnected(x, name="fc8", num_hidden=num_classes)
    return sym.SoftmaxOutput(x, name="softmax")
