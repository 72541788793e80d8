"""Contrib layers (the JAX package's ``gluon/contrib/nn/basic_layers.py``;
reference: gluon/contrib/nn/basic_layers.py): ``Concurrent`` and
``HybridConcurrent`` feed their input to every child and concatenate the
outputs on ``axis``; ``Identity`` passes its input through.
``SparseEmbedding`` (row-sparse gradients, ROADMAP A15) and
``SyncBatchNorm`` (cross-device statistics, ROADMAP A8.3) raise, as the
op registry does for their ops."""
from __future__ import annotations

from ....base import MXNetError
from ...block import Block, HybridBlock
from ...nn.basic_layers import HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm"]


class Concurrent(Sequential):
    """Every child on the same input, outputs concatenated on ``axis``
    (reference: contrib/nn/basic_layers.py Concurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super(Concurrent, self).__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray as F
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Concurrent as a HybridBlock (reference: contrib/nn/basic_layers.py
    HybridConcurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super(HybridConcurrent, self).__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)


class Identity(HybridBlock):
    """The input, unchanged: a skip branch inside a Concurrent
    (reference: contrib/nn/basic_layers.py Identity)."""

    def hybrid_forward(self, F, x):
        return x


def _queued(name, item, what):
    def __init__(self, *args, **kwargs):
        raise MXNetError("gluon.contrib.nn.%s is not ported to "
                         "mxnet_tpu_torch: %s is ROADMAP %s"
                         % (name, what, item))
    return type(name, (Block,), {"__init__": __init__,
                                 "__doc__": "Not ported (%s)." % item})


SparseEmbedding = _queued("SparseEmbedding", "A15", "row-sparse storage")
SyncBatchNorm = _queued("SyncBatchNorm", "A8.3",
                        "cross-device BatchNorm")
