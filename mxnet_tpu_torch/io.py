"""Data iterators.

Counterpart of the JAX package's ``io.py``: ``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter`` (in-memory arrays; ``pad`` and ``discard``
for the last batch) and ``ResizeIter``. Batches are host NDArrays; the
executor copies them to its device. Shuffling, ``roll_over``,
``ImageRecordIter``, ``recordio`` and prefetching come with ROADMAP
A8.1, sharding (``num_parts``) with A13.
"""
from __future__ import annotations

from collections import OrderedDict, namedtuple

import numpy as np

from .base import MXNetError
from .ndarray.ndarray import NDArray, array

_HOST = "cpu"       # batches are staged on the host; executors copy them

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Data description: name, shape, plus dtype/layout
    (reference: python/mxnet/io.py DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)


class DataBatch(object):
    """One mini-batch (reference: python/mxnet/io.py DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise TypeError("data must be a list of NDArrays")
        if label is not None and not isinstance(label, (list, tuple)):
            raise TypeError("label must be a list of NDArrays")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter(object):
    """Base iterator (reference: python/mxnet/io.py DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Input arrays -> [(name, numpy array)] (reference: io.py _init_data)."""
    if data is None:
        if not allow_empty:
            raise MXNetError("NDArrayIter needs data")
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise MXNetError("NDArrayIter needs data")
        if len(data) == 1:
            data = OrderedDict([(default_name, data[0])])
        else:
            data = OrderedDict([("_%d_%s" % (i, default_name), d)
                                for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference: python/mxnet/io.py:182).

    ``last_batch_handle``: ``pad`` wraps the final short batch with
    leading samples and reports ``pad``; ``discard`` drops it."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None, num_parts=1,
                 part_index=0):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard"):
            raise NotImplementedError(
                "NDArrayIter(last_batch_handle=%r) is not ported yet "
                "(ROADMAP A8.1)" % (last_batch_handle,))
        if num_parts != 1:
            raise NotImplementedError("NDArrayIter sharding (num_parts) "
                                      "comes with ROADMAP A13")
        if shuffle:
            raise NotImplementedError("NDArrayIter(shuffle=True) is not "
                                      "ported yet (ROADMAP A8.1)")
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.last_batch_handle = last_batch_handle
        self.num_data = self.data[0][1].shape[0]
        if last_batch_handle == "discard":
            self.num_data -= self.num_data % batch_size
        if self.num_data < batch_size:
            raise MXNetError("batch_size needs to be smaller than data size.")
        self.cursor = -batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return DataBatch(data=self.getdata(), label=self.getlabel(),
                         pad=self.getpad(), index=None)

    def _batchify(self, source):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            return [array(v[self.cursor:end], ctx=_HOST) for _, v in source]
        # pad: wrap the short tail with the epoch's leading samples
        pad = end - self.num_data
        return [array(np.concatenate((v[self.cursor:self.num_data],
                                      v[:pad]), axis=0), ctx=_HOST)
                for _, v in source]

    def getdata(self):
        return self._batchify(self.data)

    def getlabel(self):
        return self._batchify(self.label) if self.label else []

    def getpad(self):
        if self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """Resize another iterator to ``size`` batches per epoch
    (reference: python/mxnet/io.py:578)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            try:
                self.current_batch = self.data_iter.next()
            except StopIteration:
                raise MXNetError(
                    "ResizeIter: wrapped %s yielded no batches after "
                    "reset(); cannot resize an empty iterator to %d "
                    "batches" % (type(self.data_iter).__name__, self.size))
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad
