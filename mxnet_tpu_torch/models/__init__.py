"""Symbolic model builders (reference: example/image-classification/
symbols/): ResNet; the other topologies of the JAX package's ``models/``
come with ROADMAP A15."""
from .resnet import get_symbol as resnet

__all__ = ["resnet"]
