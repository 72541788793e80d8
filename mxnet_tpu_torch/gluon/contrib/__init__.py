"""Gluon contrib (the JAX package's ``gluon/contrib``; reference:
python/mxnet/gluon/contrib/): ``nn`` and ``data``. ``contrib.rnn`` comes
with the recurrent layers (ROADMAP A12.2)."""
from . import nn  # noqa: F401
from . import data  # noqa: F401
