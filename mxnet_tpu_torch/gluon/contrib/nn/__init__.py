"""Contrib layers (reference: gluon/contrib/nn/)."""
from .basic_layers import (Concurrent, HybridConcurrent,  # noqa: F401
                           Identity, SparseEmbedding, SyncBatchNorm)
