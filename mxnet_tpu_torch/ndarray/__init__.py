"""NDArray package (reference: python/mxnet/ndarray/__init__.py): the
array wrapper, creation helpers, random sampling and ``save`` / ``load``
(``utils``; the reference binary layout in ``mxnet_format``)."""
from .ndarray import NDArray, array, empty, ones, zeros
from . import random
from .utils import load, save

__all__ = ["NDArray", "array", "empty", "load", "ones", "random", "save",
           "zeros"]
