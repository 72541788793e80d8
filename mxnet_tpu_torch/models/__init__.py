"""Symbolic model builders (reference: example/image-classification/
symbols/): ResNet and the MLP; the other topologies of the JAX package's
``models/`` come with ROADMAP A8.8."""
from .mlp import get_symbol as mlp
from .resnet import get_symbol as resnet

__all__ = ["mlp", "resnet"]
