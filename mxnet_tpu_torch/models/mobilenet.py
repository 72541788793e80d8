"""Symbolic MobileNet v1 (Howard et al. 2017, depthwise-separable
convolutions; reference: example/image-classification/symbols/
mobilenet.py).

The JAX package's ``models/mobilenet.py`` over this package's symbol API,
with the same layer names, so the same argument and auxiliary-state
names. ``dtype`` is accepted and, as there, builds the same float32
graph whatever it is.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol"]


def _conv_block(x, name, num_filter, kernel=(3, 3), stride=(1, 1),
                pad=(1, 1), num_group=1):
    x = sym.Convolution(x, name=name, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, num_group=num_group,
                        no_bias=True)
    x = sym.BatchNorm(x, name=name + "_bn", fix_gamma=False)
    return sym.Activation(x, name=name + "_relu", act_type="relu")


def _dw_sep(x, name, in_ch, out_ch, stride=(1, 1), multiplier=1.0):
    in_ch = int(in_ch * multiplier)
    out_ch = int(out_ch * multiplier)
    x = _conv_block(x, name + "_dw", in_ch, kernel=(3, 3), stride=stride,
                    pad=(1, 1), num_group=in_ch)
    return _conv_block(x, name + "_pw", out_ch, kernel=(1, 1),
                       stride=(1, 1), pad=(0, 0))


def get_symbol(num_classes=1000, multiplier=1.0, dtype="float32"):
    data = sym.Variable("data")
    x = _conv_block(data, "conv0", int(32 * multiplier), stride=(2, 2))
    cfg = [  # (in, out, stride)
        (32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
        (256, 256, 1), (256, 512, 2),
        (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
        (512, 512, 1),
        (512, 1024, 2), (1024, 1024, 1),
    ]
    for i, (cin, cout, s) in enumerate(cfg):
        x = _dw_sep(x, "sep%d" % (i + 1), cin, cout, stride=(s, s),
                    multiplier=multiplier)
    x = sym.Pooling(x, name="pool", global_pool=True, kernel=(7, 7),
                    pool_type="avg")
    x = sym.Flatten(x)
    x = sym.FullyConnected(x, name="fc", num_hidden=num_classes)
    return sym.SoftmaxOutput(x, name="softmax")
