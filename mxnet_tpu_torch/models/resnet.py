"""Symbolic ResNet v2 (reference: example/image-classification/symbols/
resnet.py topology; He et al., "Identity Mappings" variant).

The JAX package's ``models/resnet.py``, line for line, over this
package's symbol API: the same layer names, so the same argument and
auxiliary-state names. NCHW; convolutions run on cuDNN.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol", "resnet50_symbol"]


def _residual_unit_v2(data, num_filter, stride, dim_match, name,
                      bottle_neck=True, bn_mom=0.9):
    """Pre-activation residual unit (resnet v2)."""
    bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    if bottle_neck:
        conv1 = sym.Convolution(act1, num_filter=num_filter // 4,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=num_filter // 4,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + "_conv3")
        body = conv3
    else:
        conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                                stride=stride, pad=(1, 1), no_bias=True,
                                name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                                stride=(1, 1), pad=(1, 1), no_bias=True,
                                name=name + "_conv2")
        body = conv2
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(act1, num_filter=num_filter,
                                   kernel=(1, 1), stride=stride,
                                   no_bias=True, name=name + "_sc")
    return body + shortcut


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               bottle_neck=None, bn_mom=0.9):
    """Build a ResNet symbol (reference: symbols/resnet.py get_symbol).

    Supported depths: 18, 34, 50, 101, 152 (and 20/56/110 for CIFAR
    shapes)."""
    (nchannel, height, width) = image_shape
    if height <= 32:
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            use_bottle = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            use_bottle = False
        else:
            raise ValueError("no experiments done on num_layers %d"
                             % num_layers)
        units = per_unit * num_stages
    else:
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            use_bottle = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            use_bottle = False
        num_stages = 4
        stage_units = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                       101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
                       200: [3, 24, 36, 3]}
        if num_layers not in stage_units:
            raise ValueError("no experiments done on num_layers %d"
                             % num_layers)
        units = stage_units[num_layers]
    if bottle_neck is not None:
        use_bottle = bottle_neck

    data = sym.Variable("data")
    body = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=bn_mom,
                         name="bn_data")
    if height <= 32:
        body = sym.Convolution(body, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0")
    else:
        body = sym.Convolution(body, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max", name="pool0")

    for i in range(num_stages):
        stride = (1, 1) if i == 0 and height > 32 else (2, 2) if i > 0 \
            else (1, 1)
        body = _residual_unit_v2(body, filter_list[i + 1], stride, False,
                                 name="stage%d_unit1" % (i + 1),
                                 bottle_neck=use_bottle, bn_mom=bn_mom)
        for j in range(units[i] - 1):
            body = _residual_unit_v2(body, filter_list[i + 1], (1, 1), True,
                                     name="stage%d_unit%d" % (i + 1, j + 2),
                                     bottle_neck=use_bottle, bn_mom=bn_mom)

    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")


def resnet50_symbol(num_classes=1000):
    return get_symbol(num_classes=num_classes, num_layers=50)
