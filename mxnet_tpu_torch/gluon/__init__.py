"""Gluon: the imperative neural-network API (the JAX package's
``gluon``; reference: python/mxnet/gluon/). Blocks run eagerly on
``torch``; ``Trainer.step`` updates every parameter in one launch of the
fused update kernel; ``rnn`` holds the recurrent cells and the fused
RNN / LSTM / GRU layers (the ``RNN`` op, cuDNN on the card)."""
from .parameter import (DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import loss  # noqa: F401
from . import utils  # noqa: F401
from . import data  # noqa: F401
from . import model_zoo  # noqa: F401
from . import contrib  # noqa: F401
