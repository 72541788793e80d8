"""Gluon recurrent layers and cells (the JAX package's ``gluon/rnn``;
reference: python/mxnet/gluon/rnn/)."""
from .rnn_cell import *   # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
from . import rnn_cell, rnn_layer  # noqa: F401
