"""RNN checkpoint helpers (the JAX package's ``rnn/rnn.py``; reference:
python/mxnet/rnn/rnn.py). The reference repacks fused cuDNN weight blobs
here; these cells keep per-gate named parameters, so the helpers write
and read the standard checkpoint files, which either package loads."""
from __future__ import annotations

from ..model import save_checkpoint, load_checkpoint

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """Reference: rnn.py save_rnn_checkpoint (unpacks fused weights
    there; parameters are already unpacked here)."""
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Reference: rnn.py load_rnn_checkpoint."""
    return load_checkpoint(prefix, epoch)


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback checkpointing through the rnn save path
    (reference: rnn.py do_rnn_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
