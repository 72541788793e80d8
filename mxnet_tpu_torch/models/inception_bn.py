"""Symbolic Inception-BN (Ioffe & Szegedy 2015: GoogLeNet with BatchNorm
after every convolution and the 5x5 branches as two 3x3; reference:
example/image-classification/symbols/inception-bn.py).

The JAX package's ``models/inception_bn.py`` over this package's symbol API,
with the same layer names, so the same argument and auxiliary-state
names. ``dtype`` is accepted and, as there, builds the same float32
graph whatever it is.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol"]


def _conv_bn_relu(x, name, num_filter, kernel, stride=(1, 1), pad=(0, 0)):
    x = sym.Convolution(x, name=name + "_conv", num_filter=num_filter,
                        kernel=kernel, stride=stride, pad=pad, no_bias=True)
    x = sym.BatchNorm(x, name=name + "_bn", fix_gamma=False, eps=2e-5,
                      momentum=0.9)
    return sym.Activation(x, name=name + "_relu", act_type="relu")


def _inception_a(x, name, n1x1, n3x3r, n3x3, nd3x3r, nd3x3, pool, proj):
    """Four-branch module: 1x1 | 1x1->3x3 | 1x1->3x3->3x3 | pool->1x1."""
    b1 = _conv_bn_relu(x, name + "_1x1", n1x1, (1, 1))
    b2 = _conv_bn_relu(x, name + "_3x3r", n3x3r, (1, 1))
    b2 = _conv_bn_relu(b2, name + "_3x3", n3x3, (3, 3), pad=(1, 1))
    b3 = _conv_bn_relu(x, name + "_d3x3r", nd3x3r, (1, 1))
    b3 = _conv_bn_relu(b3, name + "_d3x3a", nd3x3, (3, 3), pad=(1, 1))
    b3 = _conv_bn_relu(b3, name + "_d3x3b", nd3x3, (3, 3), pad=(1, 1))
    b4 = sym.Pooling(x, name=name + "_pool", kernel=(3, 3), stride=(1, 1),
                     pad=(1, 1), pool_type=pool)
    b4 = _conv_bn_relu(b4, name + "_proj", proj, (1, 1))
    return sym.Concat(b1, b2, b3, b4, name=name + "_cat", dim=1)


def _inception_b(x, name, n3x3r, n3x3, nd3x3r, nd3x3):
    """Stride-2 reduction module: 1x1->3x3/2 | 1x1->3x3->3x3/2 | pool/2."""
    b1 = _conv_bn_relu(x, name + "_3x3r", n3x3r, (1, 1))
    b1 = _conv_bn_relu(b1, name + "_3x3", n3x3, (3, 3), stride=(2, 2),
                       pad=(1, 1))
    b2 = _conv_bn_relu(x, name + "_d3x3r", nd3x3r, (1, 1))
    b2 = _conv_bn_relu(b2, name + "_d3x3a", nd3x3, (3, 3), pad=(1, 1))
    b2 = _conv_bn_relu(b2, name + "_d3x3b", nd3x3, (3, 3), stride=(2, 2),
                       pad=(1, 1))
    b3 = sym.Pooling(x, name=name + "_pool", kernel=(3, 3), stride=(2, 2),
                     pad=(1, 1), pool_type="max")
    return sym.Concat(b1, b2, b3, name=name + "_cat", dim=1)


def get_symbol(num_classes=1000, dtype="float32"):
    data = sym.Variable("data")
    x = _conv_bn_relu(data, "conv1", 64, (7, 7), stride=(2, 2), pad=(3, 3))
    x = sym.Pooling(x, name="pool1", kernel=(3, 3), stride=(2, 2),
                    pad=(1, 1), pool_type="max")
    x = _conv_bn_relu(x, "conv2red", 64, (1, 1))
    x = _conv_bn_relu(x, "conv2", 192, (3, 3), pad=(1, 1))
    x = sym.Pooling(x, name="pool2", kernel=(3, 3), stride=(2, 2),
                    pad=(1, 1), pool_type="max")
    x = _inception_a(x, "in3a", 64, 64, 64, 64, 96, "avg", 32)
    x = _inception_a(x, "in3b", 64, 64, 96, 64, 96, "avg", 64)
    x = _inception_b(x, "in3c", 128, 160, 64, 96)
    x = _inception_a(x, "in4a", 224, 64, 96, 96, 128, "avg", 128)
    x = _inception_a(x, "in4b", 192, 96, 128, 96, 128, "avg", 128)
    x = _inception_a(x, "in4c", 160, 128, 160, 128, 160, "avg", 128)
    x = _inception_a(x, "in4d", 96, 128, 192, 160, 192, "avg", 128)
    x = _inception_b(x, "in4e", 128, 192, 192, 256)
    x = _inception_a(x, "in5a", 352, 192, 320, 160, 224, "avg", 128)
    x = _inception_a(x, "in5b", 352, 192, 320, 192, 224, "max", 128)
    x = sym.Pooling(x, name="global_pool", kernel=(7, 7), global_pool=True,
                    pool_type="avg")
    x = sym.Flatten(x, name="flatten")
    x = sym.FullyConnected(x, name="fc1", num_hidden=num_classes)
    return sym.SoftmaxOutput(x, name="softmax")
