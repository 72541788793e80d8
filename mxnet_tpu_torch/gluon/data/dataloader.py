"""Gluon ``DataLoader`` (the JAX package's ``gluon/data/dataloader.py``;
reference: python/mxnet/gluon/data/dataloader.py) with ``num_workers=0``:
batches made in the calling thread by ``batchify_fn`` (default: stack
into numpy) and handed out as NDArrays on the host, as the JAX loader's
land on its default context. Worker processes are ROADMAP A12.4."""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from ...ndarray.ndarray import NDArray, array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a numpy batch (reference: dataloader.py
    default_batchify_fn); tuples batch per field."""
    if isinstance(data[0], NDArray):
        return np.stack([d.asnumpy() for d in data])
    if isinstance(data[0], tuple):
        return [default_batchify_fn(list(i)) for i in zip(*data)]
    return np.asarray(data)


def _as_ndarray(batch):
    if isinstance(batch, (list, tuple)):
        return [_as_ndarray(b) for b in batch]
    if isinstance(batch, np.ndarray):
        return array(batch, ctx="cpu", dtype=batch.dtype)
    return batch


class DataLoader(object):
    """Batches of a Dataset (reference: dataloader.py DataLoader)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False):
        if num_workers:
            raise MXNetError("DataLoader(num_workers=%d): worker processes "
                             "are not ported to mxnet_tpu_torch (ROADMAP "
                             "A12.4); use num_workers=0" % num_workers)
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size/shuffle/sampler/last_batch must not be "
                "specified if batch_sampler is")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn

    def __iter__(self):
        for indices in self._batch_sampler:
            yield _as_ndarray(self._batchify_fn(
                [self._dataset[i] for i in indices]))

    def __len__(self):
        return len(self._batch_sampler)
