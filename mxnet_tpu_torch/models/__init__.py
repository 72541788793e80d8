"""Symbolic model builders (reference: example/image-classification/
symbols/): the JAX package's ``models/`` — ResNet, the MLP, AlexNet,
VGG, MobileNet and Inception-BN, with its builders' signatures."""
from .alexnet import get_symbol as alexnet
from .inception_bn import get_symbol as inception_bn
from .mlp import get_symbol as mlp
from .mobilenet import get_symbol as mobilenet
from .resnet import get_symbol as resnet
from .vgg import get_symbol as vgg

__all__ = ["alexnet", "inception_bn", "mlp", "mobilenet", "resnet", "vgg"]
