"""Pretrained weights from a local directory (the JAX package's
``gluon/model_zoo/model_store.py``; reference:
python/mxnet/gluon/model_zoo/model_store.py). Nothing is downloaded:
``get_model_file(name, root)`` is ``<root>/<name>.params`` when that file
is there, and raises ``MXNetError`` naming the path when it is not."""
from __future__ import annotations

import os

from ...base import MXNetError

__all__ = ["get_model_file", "purge"]


def get_model_file(name, root="~/.mxnet/models"):
    root = os.path.expanduser(str(root))
    path = os.path.join(root, "%s.params" % name)
    if os.path.exists(path):
        return path
    raise MXNetError(
        "Pretrained model file %s.params is not present under %s and "
        "nothing is downloaded. Stage the weights there or construct the "
        "model with pretrained=False." % (name, root))


def purge(root="~/.mxnet/models"):
    """Remove every ``.params`` file under ``root``."""
    root = os.path.expanduser(str(root))
    if os.path.isdir(root):
        for f in os.listdir(root):
            if f.endswith(".params"):
                os.remove(os.path.join(root, f))
