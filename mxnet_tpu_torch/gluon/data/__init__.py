"""Gluon data API (the JAX package's ``gluon/data``; reference:
python/mxnet/gluon/data/): datasets, samplers and the ``DataLoader``
with ``num_workers=0``. Worker processes are ROADMAP A12.4, the vision
datasets and transforms A12.5."""
from .dataset import *     # noqa: F401,F403
from .sampler import *     # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
