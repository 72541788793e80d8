"""BucketSentenceIter: variable-length integer sequences grouped into
length buckets and served as fixed-shape batches with a ``bucket_key``,
the input side of ``BucketingModule``.

Counterpart of the JAX package's ``rnn/io.py`` (reference:
python/mxnet/rnn/io.py); the batches lie on the host as the other
iterators' do, and ``reset`` shuffles from the global ``random`` and
``np.random``, so a seed gives both packages the same batches."""
from __future__ import annotations

import bisect
import random as _random

import numpy as np

from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter
from ..ndarray.ndarray import array

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    """Bucketed iterator over encoded sentences.

    sentences : list of lists of int token ids.
    buckets : ascending bucket lengths (default: lengths observed).
    Each sentence lands in the smallest bucket that fits, right-padded
    with ``invalid_label``; labels are the sequence shifted one step.
    """

    def __init__(self, sentences, batch_size, buckets=None, pad=0,
                 invalid_label=-1, data_name="data", label_name="softmax_label",
                 layout="NT"):
        super(BucketSentenceIter, self).__init__(batch_size)
        if not buckets:
            lens = sorted({len(s) for s in sentences if len(s)})
            buckets = [l for l in lens]
        self.buckets = sorted(buckets)
        self.data_name = data_name
        self.label_name = label_name
        self.invalid_label = invalid_label
        self.layout = layout

        self.data = [[] for _ in self.buckets]
        for s in sentences:
            if not len(s):
                continue
            i = bisect.bisect_left(self.buckets, len(s))
            if i == len(self.buckets):
                continue                      # longer than every bucket
            buf = np.full((self.buckets[i],), invalid_label, np.float32)
            buf[: len(s)] = s
            self.data[i].append(buf)
        self.data = [np.asarray(b, np.float32) if b else
                     np.zeros((0, self.buckets[i]), np.float32)
                     for i, b in enumerate(self.data)]

        self.default_bucket_key = max(self.buckets)
        self.idx = []
        for i, b in enumerate(self.data):
            for j in range(0, len(b) - batch_size + 1, batch_size):
                self.idx.append((i, j))
        self.curr_idx = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size, self.default_bucket_key),
                         np.float32)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self.default_bucket_key),
                         np.float32)]

    def reset(self):
        self.curr_idx = 0
        _random.shuffle(self.idx)
        for b in self.data:
            np.random.shuffle(b)

    def __iter__(self):
        return self

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.data[i][j: j + self.batch_size]
        label = np.empty_like(data)
        label[:, :-1] = data[:, 1:]
        label[:, -1] = self.invalid_label
        L = self.buckets[i]
        return DataBatch(
            [array(data, ctx=cpu())], [array(label, ctx=cpu())], pad=0,
            bucket_key=L,
            provide_data=[DataDesc(self.data_name,
                                   (self.batch_size, L), np.float32)],
            provide_label=[DataDesc(self.label_name,
                                    (self.batch_size, L), np.float32)])

    __next__ = next
