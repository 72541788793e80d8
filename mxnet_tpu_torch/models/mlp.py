"""Symbolic MLP (the JAX package's ``models/mlp.py``; reference:
example/image-classification/symbols/mlp.py): FullyConnected + ReLU
layers of ``hidden`` widths, then a FullyConnected of ``num_classes``
and SoftmaxOutput. The first layer flattens its input."""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol"]


def get_symbol(num_classes=10, hidden=(128, 64)):
    data = sym.Variable("data")
    net = data
    for i, h in enumerate(hidden):
        net = sym.FullyConnected(net, name="fc%d" % (i + 1), num_hidden=h)
        net = sym.Activation(net, name="relu%d" % (i + 1), act_type="relu")
    net = sym.FullyConnected(net, name="fc%d" % (len(hidden) + 1),
                             num_hidden=num_classes)
    return sym.SoftmaxOutput(net, name="softmax")
