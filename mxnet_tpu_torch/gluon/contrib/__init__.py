"""Gluon contrib (the JAX package's ``gluon/contrib``; reference:
python/mxnet/gluon/contrib/): ``nn``, ``rnn`` and ``data``."""
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import data  # noqa: F401
