"""NDArray package (reference: python/mxnet/ndarray/__init__.py): the
array wrapper, creation helpers and random sampling."""
from .ndarray import NDArray, array, empty, ones, zeros
from . import random

__all__ = ["NDArray", "array", "empty", "ones", "zeros", "random"]
