"""The legacy symbolic RNN API (the JAX package's ``rnn``; reference:
python/mxnet/rnn/): the cells, ``BucketSentenceIter`` and the checkpoint
helpers that the ``BucketingModule`` workflow is built on.
``FusedRNNCell`` builds the same unrolled graph as the unfused cells,
as in the JAX package."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell)
from .io import BucketSentenceIter
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint,
                  do_rnn_checkpoint)
