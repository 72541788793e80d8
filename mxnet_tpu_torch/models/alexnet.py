"""Symbolic AlexNet (Krizhevsky et al. 2012, the single-tower variant;
reference: example/image-classification/symbols/alexnet.py).

The JAX package's ``models/alexnet.py`` over this package's symbol API,
with the same layer names, so the same argument and auxiliary-state
names. ``dtype`` is accepted and, as there, builds the same float32
graph whatever it is.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol"]


def _conv_relu(x, name, num_filter, kernel, stride=(1, 1), pad=(0, 0)):
    x = sym.Convolution(x, name=name, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad)
    return sym.Activation(x, name=name + "_relu", act_type="relu")


def get_symbol(num_classes=1000, dtype="float32"):
    data = sym.Variable("data")
    x = _conv_relu(data, "conv1", 96, (11, 11), stride=(4, 4), pad=(2, 2))
    x = sym.LRN(x, name="lrn1", nsize=5, alpha=1e-4, beta=0.75, knorm=2)
    x = sym.Pooling(x, name="pool1", kernel=(3, 3), stride=(2, 2),
                    pool_type="max")
    x = _conv_relu(x, "conv2", 256, (5, 5), pad=(2, 2))
    x = sym.LRN(x, name="lrn2", nsize=5, alpha=1e-4, beta=0.75, knorm=2)
    x = sym.Pooling(x, name="pool2", kernel=(3, 3), stride=(2, 2),
                    pool_type="max")
    x = _conv_relu(x, "conv3", 384, (3, 3), pad=(1, 1))
    x = _conv_relu(x, "conv4", 384, (3, 3), pad=(1, 1))
    x = _conv_relu(x, "conv5", 256, (3, 3), pad=(1, 1))
    x = sym.Pooling(x, name="pool3", kernel=(3, 3), stride=(2, 2),
                    pool_type="max")
    x = sym.Flatten(x)
    x = sym.FullyConnected(x, name="fc6", num_hidden=4096)
    x = sym.Activation(x, name="relu6", act_type="relu")
    x = sym.Dropout(x, name="drop6", p=0.5)
    x = sym.FullyConnected(x, name="fc7", num_hidden=4096)
    x = sym.Activation(x, name="relu7", act_type="relu")
    x = sym.Dropout(x, name="drop7", p=0.5)
    x = sym.FullyConnected(x, name="fc8", num_hidden=num_classes)
    return sym.SoftmaxOutput(x, name="softmax")
