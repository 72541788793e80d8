"""Gluon: the imperative neural-network API (the JAX package's
``gluon``; reference: python/mxnet/gluon/). Blocks run eagerly on
``torch``; ``Trainer.step`` updates every parameter in one launch of the
fused update kernel. ``rnn`` and ``contrib.rnn`` are ROADMAP A12.2."""
from .parameter import (DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import utils  # noqa: F401
from . import data  # noqa: F401
from . import model_zoo  # noqa: F401
from . import contrib  # noqa: F401
