"""Data iterators and the input pipeline.

Counterpart of the JAX package's ``io.py``: ``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter`` (in-memory arrays; ``pad``, ``discard``
and ``roll_over``; seeded per-epoch shuffles), ``ResizeIter``,
``PrefetchingIter`` (read-ahead threads that stage batches onto the card
through pinned buffers), the ``ImageRecordIter`` factory over
``image.ImageIter``, ``CSVIter`` and ``MNISTIter`` (local files), the
partition and seed helpers ``shard_bounds`` and ``mix_seed``, and
``DataPipeline``: worker processes that decode batches from a picklable
source (``ArrayBatchSource``, ``RecordBatchSource``), reassembled in
order and staged onto the card ahead of the consumer, with a seekable
cursor. Batches of the in-memory iterators are host NDArrays; the
executor binds them on its device, or ``PrefetchingIter`` /
``DataPipeline`` stage them there first. ``LibSVMIter`` yields sparse
batches and comes with sparse storage (ROADMAP A15); sharding of
``NDArrayIter`` (``num_parts``) with A13.
"""
from __future__ import annotations

import contextlib
import os
import queue as _queue
import random as _pyrandom
import threading
import time
from collections import OrderedDict, deque, namedtuple

import numpy as np
import torch

from . import fault as _fault
from . import tracing as _tr
from .base import MXNetError
from .ndarray.ndarray import NDArray, array

_HOST = "cpu"       # batches are staged on the host; executors copy them

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "ImageRecordIter", "CSVIter", "MNISTIter",
           "DataPipeline", "ArrayBatchSource", "RecordBatchSource",
           "shard_bounds", "mix_seed"]


def shard_bounds(n, num_parts, part_index):
    """The half-open slice ``[lo, hi)`` of part ``part_index`` when ``n``
    samples split into ``num_parts`` parts: disjoint, exhaustive, sizes
    within one of each other (the ``n % num_parts`` trailing parts get
    the extra sample; reference: iter_image_recordio_2.cc
    num_parts/part_index)."""
    num_parts = int(num_parts)
    part_index = int(part_index)
    if num_parts < 1:
        raise MXNetError("num_parts must be >= 1, got %d" % num_parts)
    if not 0 <= part_index < num_parts:
        raise MXNetError("part_index %d out of range for num_parts %d"
                         % (part_index, num_parts))
    return n * part_index // num_parts, n * (part_index + 1) // num_parts


_MASK64 = (1 << 64) - 1


def mix_seed(*parts):
    """Mix integers into one 63-bit seed (the splitmix64 finalizer over
    each part): the key of per-epoch shuffles, stable across processes
    and ``PYTHONHASHSEED``; the JAX package's ``io.mix_seed``."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = (h ^ (int(p) & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


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
    leading samples and reports ``pad``; ``discard`` drops it;
    ``roll_over`` carries it to the front of the next epoch. With
    ``shuffle`` each epoch's order is
    ``RandomState(mix_seed(seed, epoch) % 2**32).permutation(n)`` of the
    original arrays, never the global generator. ``seed`` is an int, or a
    ``numpy.random.RandomState`` to draw the seed from (None: a fresh
    one), as the JAX package draws it from ``np.random``. Sharding
    (``num_parts``) comes with ROADMAP A13."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None, num_parts=1,
                 part_index=0):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError("last_batch_handle %r (pad, discard, roll_over)"
                             % (last_batch_handle,))
        if num_parts != 1:
            raise NotImplementedError("NDArrayIter sharding (num_parts) "
                                      "comes with ROADMAP A13")
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        if shuffle and (seed is None
                        or isinstance(seed, np.random.RandomState)):
            # unseeded, one anchor from the global generator, so that
            # np.random.seed reproduces the order (the JAX package's rule)
            rng = seed if seed is not None else np.random
            seed = int(rng.randint(0, 2 ** 31 - 1))
        self.shuffle = shuffle
        self._seed = seed
        self._epoch = -1
        self._base_data = self.data
        self._base_label = self.label
        self.last_batch_handle = last_batch_handle
        self.num_data = self.data[0][1].shape[0]
        if last_batch_handle == "discard":
            self.num_data -= self.num_data % batch_size
        if self.num_data < batch_size:
            raise MXNetError("batch_size needs to be smaller than data size.")
        self.cursor = -batch_size
        self._cache_data = None
        self._cache_label = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        """Restart from sample 0, dropping a rolled-over tail."""
        self._epoch += 1
        if self.shuffle:
            self._shuffle_data()
        self.cursor = -self.batch_size
        self._cache_data = None
        self._cache_label = None

    def reset(self):
        self._epoch += 1
        if self.shuffle:
            self._shuffle_data()
        # roll_over: the previous epoch's tail leads the next epoch
        if (self.last_batch_handle == "roll_over"
                and 0 < self.cursor < self.num_data):
            self.cursor = -self.batch_size + (self.cursor - self.num_data)
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data = self.getdata()
        label = self.getlabel()
        # roll_over: the carried tail is spent once data and label used it
        if self.last_batch_handle == "roll_over" and self.cursor < 0:
            self._cache_data = None
            self._cache_label = None
        return DataBatch(data=data, label=label, pad=self.getpad(),
                         index=None)

    @staticmethod
    def _slice(source, start=0, end=None):
        return [array(v[start:end], ctx=_HOST) for _, v in source]

    @staticmethod
    def _concat(first, second):
        return [array(np.concatenate((f.asnumpy(), s.asnumpy()), axis=0),
                      ctx=_HOST) for f, s in zip(first, second)]

    def _batchify(self, source):
        if self.cursor >= self.num_data:
            raise MXNetError("DataIter needs reset.")
        if self.last_batch_handle == "roll_over" and self.cursor < 0:
            cache = (self._cache_data if source is self.data
                     else self._cache_label)
            if cache is None:
                raise MXNetError("next epoch should have cached data")
            return self._concat(cache, self._slice(
                source, end=self.cursor + self.batch_size))
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            return self._slice(source, self.cursor, end)
        if self.last_batch_handle == "pad":
            # wrap the short tail with the epoch's leading samples
            return self._concat(
                self._slice(source, self.cursor, self.num_data),
                self._slice(source, end=end - self.num_data))
        # roll_over: the short tail, cached by getdata()
        return self._slice(source, self.cursor, self.num_data)

    def getdata(self):
        if (self.last_batch_handle == "roll_over"
                and self.num_data - self.batch_size < self.cursor
                < self.num_data):
            # the tail waits for the next epoch: this one ends here
            self._cache_data = self._batchify(self.data)
            self._cache_label = (self._batchify(self.label) if self.label
                                 else [])
            raise StopIteration
        return self._batchify(self.data)

    def getlabel(self):
        if not self.label:
            return []
        if (self.last_batch_handle == "roll_over" and self.cursor < 0
                and self._cache_label is not None):
            return self._concat(self._cache_label, self._slice(
                self.label, end=self.cursor + self.batch_size))
        return self._batchify(self.label)

    def getpad(self):
        if (self.last_batch_handle == "pad"
                and self.cursor + self.batch_size > self.num_data):
            return self.cursor + self.batch_size - self.num_data
        if (self.last_batch_handle == "roll_over"
                and -self.batch_size < self.cursor < 0):
            return -self.cursor
        return 0

    def getindex(self):
        return None

    def _shuffle_data(self):
        perm = np.random.RandomState(
            mix_seed(self._seed, self._epoch) % (2 ** 32)).permutation(
            self._base_data[0][1].shape[0])
        self.data = [(k, v[perm]) for k, v in self._base_data]
        self.label = [(k, v[perm]) for k, v in self._base_label]


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

    def close(self):
        """Close the wrapped iterator where it can be (its read-ahead
        threads stop; a later batch restarts them)."""
        closer = getattr(self.data_iter, "close", None)
        if callable(closer):
            closer()


class _Slot(object):
    """One pinned staging buffer set of a prefetch thread: the host
    tensors of one batch and the event of their last copy to the card."""

    def __init__(self):
        self.pinned = []
        self.event = None

    def buffer(self, k, t):
        """Pinned host tensor ``k`` shaped like ``t``; reused while the
        shape and dtype hold (the caller waited for ``event``)."""
        while len(self.pinned) <= k:
            self.pinned.append(None)
        p = self.pinned[k]
        if p is None or p.shape != t.shape or p.dtype != t.dtype:
            p = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.pinned[k] = p
        return p


class PrefetchingIter(DataIter):
    """Read-ahead threads over one or more iterators, one batch ahead of
    the consumer (reference: python/mxnet/io.py:658; the JAX package's
    ``PrefetchingIter``).

    ``device_prefetch=True`` also stages every batch onto the card
    ``ctx`` (default ``cuda:0``) from the read-ahead thread, which owns a
    CUDA stream of its own: each host array is copied into one of
    ``buffers`` pinned host buffers, then to a new device tensor by a
    ``non_blocking`` copy on that stream, and an event is recorded after
    the batch. The consumer's stream waits for the event before the
    batch is used, and every staged tensor is marked used by that stream
    (``record_stream``), so the caching allocator does not hand its
    memory out while the step reads it. A pinned buffer is written again
    only after the event of its previous copy has completed. Arrays
    already on the card (the nvJPEG route) are produced on the same
    stream and covered by the same event. With a host ``ctx`` nothing is
    staged.

    An exception in a read-ahead thread is raised to the consumer.
    ``close()`` stops the threads and is not terminal: ``reset()`` or the
    next batch restarts them where they stopped."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 device_prefetch=False, ctx=None, buffers=2):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        if not iters:
            raise MXNetError("PrefetchingIter needs an iterator")
        self.n_iter = len(iters)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._device = None
        if device_prefetch:
            from .context import default_device
            dev = default_device(ctx)
            if dev.type == "cuda":
                self._device = dev
        self._slots = [[_Slot() for _ in range(max(2, int(buffers)))]
                       for _ in iters]
        self._slot_next = [0] * self.n_iter
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in iters]
        self.data_taken = [threading.Event() for _ in iters]
        for e in self.data_taken:
            e.set()
        self.started = False
        self.current_batch = None
        self.next_batch = [None] * self.n_iter
        self.next_event = [None] * self.n_iter
        self.next_error = [None] * self.n_iter
        self.prefetch_threads = []
        self._start_threads()

    @property
    def staged_device(self):
        """The card batches are staged onto, or None."""
        return self._device

    def _start_threads(self):
        if self.started:
            return
        # a close() whose join timed out can leave a thread finishing its
        # fetch: two threads on one iterator would corrupt the stream
        for t in self.prefetch_threads:
            t.join()
        # a batch parked before close() keeps data_taken clear, so the
        # new thread does not overwrite it before the consumer reads it
        for ready, taken in zip(self.data_ready, self.data_taken):
            if ready.is_set():
                taken.clear()
        self.started = True
        self.prefetch_threads = [
            threading.Thread(target=self._prefetch, args=(i,), daemon=True)
            for i in range(self.n_iter)]
        for t in self.prefetch_threads:
            t.start()

    def _prefetch(self, i):
        stream = None
        if self._device is not None:
            torch.cuda.set_device(self._device)
            stream = torch.cuda.Stream(self._device)
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                batch, event, error = None, None, None
                try:
                    batch = self.iters[i].next()
                    if stream is not None:
                        self._stage(i, batch)
                        event = torch.cuda.Event()
                        event.record(stream)
                except StopIteration:
                    batch = None
                except Exception as e:      # raised to the consumer
                    error = e
                self.next_batch[i] = batch
                self.next_event[i] = event
                self.next_error[i] = error
                self.data_taken[i].clear()
                self.data_ready[i].set()
                if not self.started:
                    # a close() that arrived mid-fetch had its wake-up
                    # erased by the clear() above
                    break

    def _stage(self, i, batch):
        """Copy the batch's host arrays to the card through a pinned slot
        (in the read-ahead thread, on its stream)."""
        slot = self._slots[i][self._slot_next[i]]
        self._slot_next[i] = (self._slot_next[i] + 1) % len(self._slots[i])
        if slot.event is not None:
            slot.event.synchronize()      # its previous copy has landed
        k = 0
        for arrs in (batch.data, batch.label or []):
            for j, a in enumerate(arrs):
                t = a._data if isinstance(a, NDArray) else torch.as_tensor(
                    np.asarray(a))
                if t.device.type == "cuda":
                    continue
                pin = slot.buffer(k, t)
                k += 1
                pin.copy_(t)
                arrs[j] = NDArray(pin.to(self._device, non_blocking=True))
        slot.event = torch.cuda.Event()
        slot.event.record(torch.cuda.current_stream(self._device))

    def close(self):
        """Stop the read-ahead threads; idempotent and restartable."""
        if not self.started:
            return
        self.started = False
        for e in self.data_taken:
            e.set()
        for t in self.prefetch_threads:
            t.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        if self.started:
            for e in self.data_ready:
                e.wait()
        for it in self.iters:
            it.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        self._start_threads()

    def iter_next(self):
        self._start_threads()       # no-op unless close()d
        for e in self.data_ready:
            e.wait()
        for i, err in enumerate(self.next_error):
            if err is not None:
                self.next_error[i] = None
                self.data_ready[i].clear()
                self.data_taken[i].set()
                raise err
        if self.next_batch[0] is None:
            if any(b is not None for b in self.next_batch):
                raise MXNetError("the prefetched iterators ended apart")
            return False
        if any(b is None for b in self.next_batch):
            raise MXNetError("the prefetched iterators ended apart")
        if self._device is not None:
            cur = torch.cuda.current_stream(self._device)
            for b, ev in zip(self.next_batch, self.next_event):
                cur.wait_event(ev)
                for a in list(b.data) + list(b.label or []):
                    if a._data.device.type == "cuda":
                        a._data.record_stream(cur)
        self.current_batch = DataBatch(
            sum([list(b.data) for b in self.next_batch], []),
            sum([list(b.label or []) for b in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def ImageRecordIter(path_imgrec=None, data_shape=None, batch_size=1,
                    shuffle=False, rand_crop=False, rand_mirror=False,
                    mean_r=0, mean_g=0, mean_b=0, std_r=1, std_g=1, std_b=1,
                    ctx=None, **kwargs):
    """RecordIO image batches (reference: the C++ ImageRecordIter,
    src/io/iter_image_recordio_2.cc:735): a factory over
    ``image.ImageIter`` with the flat arguments of the CLI.
    ``prefetch_buffer=k`` wraps it in a :class:`PrefetchingIter` that
    stages onto the card ``ctx`` (default ``cuda:0``) through ``k`` (at
    least 2) pinned buffers; a host ``ctx`` prefetches without staging.
    ``ctx`` is also the card the nvJPEG decoder backend decodes on."""
    from .image import ImageIter
    mean = None
    std = None
    if mean_r or mean_g or mean_b:
        mean = np.array([mean_r, mean_g, mean_b])
    if (std_r, std_g, std_b) != (1, 1, 1):
        std = np.array([std_r, std_g, std_b])
    prefetch = kwargs.pop("prefetch_buffer", None)
    it = ImageIter(batch_size=batch_size, data_shape=data_shape,
                   path_imgrec=path_imgrec, shuffle=shuffle,
                   rand_crop=rand_crop, rand_mirror=rand_mirror,
                   mean=mean, std=std, ctx=ctx, **kwargs)
    if prefetch:
        it = PrefetchingIter(it, device_prefetch=True, ctx=ctx,
                             buffers=prefetch)
    return it


class CSVIter(DataIter):
    """Iterate over CSV files (reference: src/io/iter_csv.cc; the JAX
    package's ``CSVIter``): the rows read once with numpy, then
    :class:`NDArrayIter` batches (``round_batch`` pads the last batch,
    else drops it; ``shuffle`` / ``seed`` as there; the label named
    ``label``). Sharding (``num_parts``) comes with NDArrayIter's, ROADMAP
    A13."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32",
                 shuffle=False, seed=None, num_parts=1, part_index=0, **_kw):
        data = np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=dtype, ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            label_name="label", shuffle=shuffle, seed=seed,
            num_parts=num_parts, part_index=part_index)
        super().__init__(batch_size)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class MNISTIter(DataIter):
    """Iterate over MNIST idx files, raw or ``.gz`` (reference:
    src/io/iter_mnist.cc; the JAX package's ``MNISTIter``): images scaled
    to [0, 1], (N, 1, 28, 28) or ``flat`` (N, 784); with ``shuffle`` one
    permutation from ``RandomState(seed)``; the last short batch
    dropped."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 seed=0, **_kw):
        import gzip
        import struct

        def _open(p):
            return gzip.open(p, "rb") if str(p).endswith(".gz") \
                else open(p, "rb")

        with _open(image) as f:
            magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise MXNetError("bad MNIST image magic %d" % magic)
            img = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                num, rows, cols)
        with _open(label) as f:
            magic, _num = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise MXNetError("bad MNIST label magic %d" % magic)
            lab = np.frombuffer(f.read(), dtype=np.uint8)
        img = img.astype(np.float32) / 255.0
        img = img.reshape((num, rows * cols) if flat else (num, 1, rows, cols))
        if shuffle:
            perm = np.random.RandomState(seed).permutation(num)
            img, lab = img[perm], lab[perm]
        self._inner = NDArrayIter(img, lab.astype(np.float32),
                                  batch_size=batch_size,
                                  last_batch_handle="discard")
        super().__init__(batch_size)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


# ---------------------------------------------------------------------------
# the multi-worker input pipeline (reference: the C++ prefetcher and
# decode pool of src/io/iter_image_recordio_2.cc, as a process pool
# feeding a k-deep staging buffer on the card)
# ---------------------------------------------------------------------------

def _pipeline_mp_context():
    """The multiprocessing context of pipeline workers
    (``MXNET_DATALOADER_START_METHOD``; an unset knob falls back to the
    platform's first method where fork is missing)."""
    import multiprocessing
    from . import config as _config
    method = _config.get("MXNET_DATALOADER_START_METHOD")
    valid = multiprocessing.get_all_start_methods()
    if method not in valid:
        if "MXNET_DATALOADER_START_METHOD" in os.environ:
            raise MXNetError(
                "MXNET_DATALOADER_START_METHOD=%r is not a start method "
                "on this platform (valid: %s)" % (method, ", ".join(valid)))
        method = valid[0]
    return multiprocessing.get_context(method)


def _pipeline_worker_loop(source, in_q, out_q, shm_prefix):
    """A pipeline worker: take ``(epoch, index)`` tasks, make the batch
    with ``source.get_batch`` (a pure function of them, so any worker
    makes the same bytes) and hand its arrays over in POSIX shared
    memory, one segment an array, named ``prefix-epoch-index-leaf`` so
    that the parent can reclaim what a crashed worker wrote and never
    reported. Host code only: it never touches CUDA (a forked child of a
    process with a CUDA context must not)."""
    from multiprocessing import resource_tracker, shared_memory
    try:
        # one decode lane a worker: the processes are the parallelism
        import cv2
        cv2.setNumThreads(0)
    except ImportError:
        pass
    while True:
        task = in_q.get()
        if task is None:
            break
        epoch, index = task
        metas = []
        try:
            _fault.inject("io.worker")
            t0 = time.monotonic()
            data, label, pad = source.get_batch(epoch, index)
            dt = time.monotonic() - t0
            n_data = len(data)
            for li, arr in enumerate(list(data) + list(label)):
                arr = np.ascontiguousarray(arr)
                name = "%s-%d-%d-%d" % (shm_prefix, epoch, index, li)
                try:
                    shm = shared_memory.SharedMemory(
                        name=name, create=True, size=max(1, arr.nbytes))
                except FileExistsError:
                    # left by a crashed attempt at this batch (no task is
                    # decoded twice at once): reclaim it
                    try:
                        old = shared_memory.SharedMemory(name=name)
                        old.close()
                        old.unlink()
                    except FileNotFoundError:
                        pass
                    shm = shared_memory.SharedMemory(
                        name=name, create=True, size=max(1, arr.nbytes))
                np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)[...] = arr
                metas.append((shm.name, arr.shape, str(arr.dtype)))
                # the consumer unlinks: this process's resource tracker
                # must not free the segment at exit
                try:
                    resource_tracker.unregister(shm._name, "shared_memory")
                except Exception:
                    pass
                shm.close()
            out_q.put((epoch, index, (metas, n_data, pad, dt), None))
        except Exception as e:
            for name, _shape, _dtype in metas:
                _unlink_segment(name)
            out_q.put((epoch, index, None, repr(e)))


def _unlink_segment(name):
    from multiprocessing import shared_memory
    try:
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    seg.close()
    try:
        seg.unlink()
    except FileNotFoundError:
        pass


def _shm_load(payload):
    """A worker's segments as numpy arrays (copied, then unlinked: the
    consumer frees the transport memory)."""
    from multiprocessing import shared_memory
    metas, n_data, pad, dt = payload
    arrs = []
    for name, shape, dtype in metas:
        shm = shared_memory.SharedMemory(name=name)
        arrs.append(np.ndarray(shape, np.dtype(dtype),
                               buffer=shm.buf).copy())
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
    return arrs[:n_data], arrs[n_data:], pad, dt


def _shm_unlink(payload):
    """Release the segments of a batch that will never be consumed."""
    if payload:
        for name, _shape, _dtype in payload[0]:
            _unlink_segment(name)


class _BatchSourceBase(object):
    """What every pipeline source shares: the shard, the seeded per-epoch
    permutations and the cursor fingerprint. Subclasses call
    :meth:`_init_source` and take their shard's ``(lo, hi)`` slice."""

    def _init_source(self, total, batch_size, shuffle, seed,
                     last_batch_handle, num_parts, part_index):
        self.batch_size = int(batch_size)
        lo, hi = shard_bounds(total, num_parts, part_index)
        self.num_data = int(hi - lo)
        if last_batch_handle not in ("pad", "discard"):
            raise MXNetError(
                "%s supports last_batch_handle 'pad' or 'discard', got %r"
                % (type(self).__name__, last_batch_handle))
        if self.num_data < self.batch_size:
            raise MXNetError(
                "batch_size %d exceeds shard size %d (part %d/%d)"
                % (self.batch_size, self.num_data, part_index, num_parts))
        self.last_batch_handle = last_batch_handle
        self.shuffle = bool(shuffle)
        self.seed = 0 if seed is None else int(seed)
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        self._perm_cache = (None, None)
        return lo, hi

    def set_seed(self, seed):
        self.seed = int(seed)
        self._perm_cache = (None, None)

    def num_batches(self, epoch=0):
        if self.last_batch_handle == "discard":
            return self.num_data // self.batch_size
        return -(-self.num_data // self.batch_size)

    def _check_index(self, epoch, index):
        n = self.num_batches(epoch)
        if not 0 <= index < n:
            raise MXNetError("batch index %d out of range [0, %d)"
                             % (index, n))

    def _perm(self, epoch):
        if self._perm_cache[0] != epoch:
            perm = np.random.RandomState(
                mix_seed(self.seed, epoch) % (2 ** 32)).permutation(
                self.num_data)
            self._perm_cache = (epoch, perm)
        return self._perm_cache[1]

    def cursor_fingerprint(self):
        """The identity of this stream: a cursor restores only into the
        same one."""
        return {"source": type(self).__name__, "seed": self.seed,
                "shuffle": self.shuffle, "num_data": self.num_data,
                "batch_size": self.batch_size,
                "num_parts": self.num_parts,
                "part_index": self.part_index}


class ArrayBatchSource(_BatchSourceBase):
    """Picklable source over in-memory arrays for :class:`DataPipeline`.

    ``get_batch(epoch, index)`` is a pure function of its arguments and
    the constructor's: what makes a worker pool's stream the inline one,
    bit for bit, and the cursor seekable. Epoch shuffles come from
    ``mix_seed(seed, epoch)``; ``num_parts`` / ``part_index`` shard by
    :func:`shard_bounds`; ``augment_fn(data_list, rng) -> data_list`` (a
    picklable module-level function) gets a ``RandomState`` keyed by
    ``(seed, epoch, index)``. A short last batch is wrapped with leading
    samples (``pad``) or dropped (``discard``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 seed=0, last_batch_handle="pad", num_parts=1, part_index=0,
                 data_name="data", label_name="softmax_label",
                 augment_fn=None):
        data = _init_data(data, allow_empty=False, default_name=data_name)
        label = _init_data(label, allow_empty=True, default_name=label_name)
        lo, hi = self._init_source(data[0][1].shape[0], batch_size,
                                   shuffle, seed, last_batch_handle,
                                   num_parts, part_index)
        self._data = [(k, v[lo:hi]) for k, v in data]
        self._label = [(k, v[lo:hi]) for k, v in label]
        self.augment_fn = augment_fn

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self._data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self._label]

    def get_batch(self, epoch, index):
        self._check_index(epoch, index)
        lo = index * self.batch_size
        hi = min(lo + self.batch_size, self.num_data)
        pad = self.batch_size - (hi - lo)
        idx = np.arange(lo, hi)
        if pad:
            idx = np.concatenate([idx, np.arange(pad)])
        if self.shuffle:
            idx = self._perm(epoch)[idx]
        data = [v[idx] for _k, v in self._data]
        label = [v[idx] for _k, v in self._label]
        if self.augment_fn is not None:
            rng = np.random.RandomState(
                mix_seed(self.seed, epoch, index, 0xA4) % (2 ** 32))
            data = self.augment_fn(data, rng)
        return data, label, pad


class RecordBatchSource(_BatchSourceBase):
    """Picklable sharded source of an indexed RecordIO file of images for
    :class:`DataPipeline`: each batch's records are decoded and augmented
    on the host by whichever worker takes it, on the python route
    (``image.imdecode`` and ``CreateAugmenter(data_shape,
    **aug_kwargs)``, the JAX package's source's route).

    Only paths cross the pickle boundary; the reader and the augmenters
    open lazily in each process. The augmenters draw from the global
    ``random`` / ``np.random``, seeded for each batch by ``mix_seed(seed,
    epoch, index, ...)`` and restored afterwards, so crops and flips are
    the same for any worker count and the caller's generators do not
    move."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, label_width=1, shuffle=False, seed=0,
                 num_parts=1, part_index=0, last_batch_handle="pad",
                 aug_kwargs=None):
        self.path_imgrec = path_imgrec
        self.path_imgidx = path_imgidx or \
            os.path.splitext(path_imgrec)[0] + ".idx"
        if not os.path.exists(self.path_imgidx):
            raise MXNetError(
                "RecordBatchSource needs an indexed .rec: no %r "
                "(tools/rec2idx.py builds one)" % self.path_imgidx)
        keys = []
        with open(self.path_imgidx) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) == 2:
                    keys.append(int(parts[0]))
        lo, hi = self._init_source(len(keys), batch_size, shuffle, seed,
                                   last_batch_handle, num_parts, part_index)
        self.keys = keys[lo:hi]
        self.data_shape = tuple(data_shape)
        self.label_width = int(label_width)
        self.aug_kwargs = dict(aug_kwargs or {})
        self._rec = None
        self._augs = None

    def __getstate__(self):
        st = dict(self.__dict__)
        st["_rec"] = None           # readers do not cross processes
        st["_augs"] = None
        st["_perm_cache"] = (None, None)
        return st

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape,
                         np.float32)]

    @property
    def provide_label(self):
        shape = (self.batch_size, self.label_width) \
            if self.label_width > 1 else (self.batch_size,)
        return [DataDesc("softmax_label", shape, np.float32)]

    def get_batch(self, epoch, index):
        from . import image as _img
        from . import recordio
        self._check_index(epoch, index)
        if self._rec is None:
            self._rec = recordio.MXIndexedRecordIO(
                self.path_imgidx, self.path_imgrec, "r")
        if self._augs is None:
            self._augs = _img.CreateAugmenter(self.data_shape,
                                              **self.aug_kwargs)
        lo = index * self.batch_size
        hi = min(lo + self.batch_size, len(self.keys))
        pad = self.batch_size - (hi - lo)
        rows = list(range(lo, hi)) + list(range(pad))
        if self.shuffle:
            perm = self._perm(epoch)
            rows = [int(perm[r]) for r in rows]
        c, h, w = self.data_shape
        data = np.zeros((self.batch_size, c, h, w), np.float32)
        label = np.zeros((self.batch_size, self.label_width), np.float32)
        py_state = _pyrandom.getstate()
        np_state = np.random.get_state()
        _pyrandom.seed(mix_seed(self.seed, epoch, index, 0x5EC))
        np.random.seed(mix_seed(self.seed, epoch, index, 0x5ED) % (2 ** 32))
        try:
            for j, r in enumerate(rows):
                header, s = recordio.unpack(self._rec.read_idx(self.keys[r]))
                img = _img.imdecode(s, 1 if c == 3 else 0, to_ndarray=False)
                for aug in self._augs:
                    img = aug(img)
                arr = np.asarray(img)
                if arr.ndim == 3:
                    arr = arr.transpose(2, 0, 1)
                data[j] = arr
                lab = np.asarray(header.label, np.float32).ravel()
                label[j, :min(lab.size, self.label_width)] = \
                    lab[:self.label_width]
        finally:
            _pyrandom.setstate(py_state)
            np.random.set_state(np_state)
        lbl = label[:, 0] if self.label_width == 1 else label
        return [data], [lbl], pad


_END = object()     # the end of an epoch (or an error) in the staged queue


class DataPipeline(DataIter):
    """Multi-worker input pipeline with staging onto the card overlapped
    (the JAX package's ``DataPipeline``).

    1. **Decode**: ``num_workers`` processes (default ``MXNET_IO_WORKERS``;
       -1: the host's cores less one; 0: decode inline on the stager
       thread) make batches with a picklable source's ``get_batch(epoch,
       index)`` (:class:`ArrayBatchSource`, :class:`RecordBatchSource`, or
       anything with ``provide_data`` / ``provide_label`` /
       ``num_batches`` / ``get_batch``) and hand them over in shared
       memory; results are put back in order, so the stream is the same,
       bit for bit, for any worker count. The workers run host code only.
    2. **Stage**: a thread copies each batch onto the card ``ctx``
       (default ``cuda:0``; a host ``ctx`` keeps host NDArrays) through
       pinned buffers on a stream of its
       own and records an event after it, ``prefetch`` batches (default
       ``MXNET_IO_PREFETCH``) ahead of the consumer, the H2D copy beside
       the previous step's compute.
    3. **Consume**: ``next()`` takes the oldest staged batch; the
       consumer's stream waits for its event, and its tensors are marked
       used by that stream.

    At most ``num_workers + prefetch`` batches are in flight and
    ``prefetch`` staged (the backpressure). A worker that crashes is
    restarted, with the pool, within ``MXNET_IO_WORKER_RESTARTS``
    (``restart_budget``); its batches are decoded again, and none is
    lost or delivered twice. ``checkpoint_state`` / ``restore_state`` are
    the resumable cursor (epoch, batch, seed, the shard): restoring
    seeks, decoding nothing on the way. ``close()`` (also by ``with``)
    stops the thread and the workers; it is idempotent and not terminal.
    Under a sampled trace the consumer's wait is an ``io.batch_wait``
    span, and the staging thread records ``io.decode`` (inline decode)
    and ``io.h2d`` spans into the trace of the step that last drew a
    batch; every decode task passes the ``io.worker`` fault point (in the
    worker process, or on the staging thread when ``num_workers`` is 0).
    The JAX package's ``io/*`` telemetry comes with ROADMAP A16."""

    def __init__(self, source, num_workers=None, prefetch=None, ctx=None,
                 restart_budget=None):
        super().__init__(int(source.batch_size))
        from . import config as _config
        from .context import default_device
        self._source = source
        nw = int(_config.get("MXNET_IO_WORKERS") if num_workers is None
                 else num_workers)
        if nw < 0:
            nw = max(1, (os.cpu_count() or 1) - 1)
        self._num_workers = nw
        self._depth = max(1, int(_config.get("MXNET_IO_PREFETCH")
                                 if prefetch is None else prefetch))
        self._restart_budget = int(
            _config.get("MXNET_IO_WORKER_RESTARTS")
            if restart_budget is None else restart_budget)
        dev = default_device(ctx)
        self._device = dev if dev.type == "cuda" else None
        # a pinned buffer set a staged batch, and one being filled
        self._slots = [_Slot() for _ in range(self._depth + 2)]
        self._slot_next = 0
        self._epoch = 0
        self._next_index = 0      # the next batch index the consumer gets
        self._end_seen = False
        self._cond = threading.Condition()
        self._staged = deque()
        self._trace_ctx = None   # the trace of the last consumer draw
        self._stop = False
        self._error = None
        self._stager = None
        self._workers = []
        self._mp_ctx = None
        self._in_q = None
        self._out_q = None
        self._current_batch = None
        # a namespace of this pipeline's segments: the parent reclaims
        # what a crashed worker wrote by name
        self._shm_prefix = "mxio-%d-%x" % (os.getpid(), id(self) & 0xFFFFFF)

    @property
    def provide_data(self):
        return self._source.provide_data

    @property
    def provide_label(self):
        return self._source.provide_label

    @property
    def staged_device(self):
        """The card batches are staged onto, or None."""
        return self._device

    # -- lifecycle ---------------------------------------------------------
    def _ensure_running(self):
        if self._end_seen or self._error is not None:
            return          # an error is delivered before a restart
        if self._stager is not None and self._stager.is_alive():
            return
        self._stop = False
        if self._num_workers > 0 and not self._workers:
            self._mp_ctx = _pipeline_mp_context()
            self._in_q = self._mp_ctx.Queue()
            self._out_q = self._mp_ctx.Queue()
            self._workers = [self._spawn_worker()
                             for _ in range(self._num_workers)]
        self._stager = threading.Thread(target=self._stager_main,
                                        name="mxnet-io-stager", daemon=True)
        self._stager.start()

    def _spawn_worker(self):
        w = self._mp_ctx.Process(
            target=_pipeline_worker_loop,
            args=(self._source, self._in_q, self._out_q, self._shm_prefix),
            daemon=True)
        w.start()
        return w

    def _halt_segment(self):
        """Stop the stager thread; recycle the pool if it stopped within
        an epoch (its tasks in flight would leak into the next)."""
        st = self._stager
        self._stager = None
        if st is not None and st.is_alive():
            with self._cond:
                self._stop = True
                self._cond.notify_all()
            st.join(timeout=10.0)
        if st is not None and not self._end_seen:
            self._teardown_pool()
        with self._cond:
            self._staged.clear()
            self._stop = False

    def _teardown_pool(self):
        workers, self._workers = self._workers, []
        in_q, out_q = self._in_q, self._out_q
        self._in_q = self._out_q = None
        if not workers:
            return
        for _ in workers:
            in_q.put_nowait(None)
        # drain while the workers wind down and after: a result that
        # lands now still holds segments only the consumer frees
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and \
                any(w.is_alive() for w in workers):
            try:
                _shm_unlink(out_q.get(timeout=0.2)[2])
            except _queue.Empty:
                pass
        for w in workers:
            w.join(timeout=1.0)
            if w.is_alive():
                w.terminate()
        while True:
            try:
                _shm_unlink(out_q.get(timeout=0.1)[2])
            except _queue.Empty:
                break

    def _kill_pool(self):
        """Stop the pool hard after a crash: terminate every worker and
        drop the queues (a worker that died writing one leaves its lock
        held)."""
        workers, self._workers = self._workers, []
        for w in workers:
            if w.is_alive():
                w.terminate()
        for w in workers:
            w.join(timeout=2.0)
            if w.is_alive():
                w.kill()
        for q in (self._in_q, self._out_q):
            if q is not None:
                q.cancel_join_thread()
                q.close()
        self._in_q = self._out_q = None

    def _reclaim_segments(self, epoch, seqs):
        """Unlink the segments of batches that died with their worker."""
        n_leaves = len(self._source.provide_data) + \
            len(self._source.provide_label)
        for seq in seqs:
            for li in range(n_leaves):
                _unlink_segment("%s-%d-%d-%d" % (self._shm_prefix, epoch,
                                                 seq, li))

    def close(self):
        """Stop the stager thread and the workers. Idempotent and not
        terminal: the position is kept, and the next use restarts."""
        self._halt_segment()
        self._teardown_pool()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- producer side (the stager thread) ---------------------------------
    def _stager_main(self):
        try:
            stream = None
            if self._device is not None:
                torch.cuda.set_device(self._device)
                stream = torch.cuda.Stream(self._device)
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                if self._num_workers == 0:
                    self._run_inline()
                else:
                    self._run_pool()
        except BaseException as e:      # handed to the consumer
            with self._cond:
                if self._error is None:
                    self._error = e
                self._staged.append(_END)
                self._cond.notify_all()

    def _push(self, item):
        """Append to the staging buffer, waiting while ``prefetch``
        batches are staged; False when the pipeline is stopping."""
        with self._cond:
            while len(self._staged) >= self._depth and not self._stop \
                    and item is not _END:
                self._cond.wait(0.1)
            if self._stop:
                return False
            self._staged.append(item)
            self._cond.notify_all()
            return True

    def _stage(self, data, label, pad):
        """A numpy batch -> (DataBatch, event): on the card through the
        next pinned slot (on the stager's stream; its previous copy has
        landed before the slot is written again), or host NDArrays."""
        t0 = time.perf_counter()
        arrays = [a.astype(np.float32) if a.dtype == np.float64 else a
                  for a in list(data) + list(label)]
        event = None
        if self._device is None:
            staged = [array(a, ctx=_HOST) for a in arrays]
        else:
            slot = self._slots[self._slot_next]
            self._slot_next = (self._slot_next + 1) % len(self._slots)
            if slot.event is not None:
                slot.event.synchronize()
            staged = []
            for k, a in enumerate(arrays):
                t = torch.from_numpy(np.ascontiguousarray(a))
                pin = slot.buffer(k, t)
                pin.copy_(t)
                staged.append(NDArray(pin.to(self._device,
                                             non_blocking=True)))
            event = slot.event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
        tctx = self._trace_ctx
        if tctx is not None:
            # the host side of the copy: the pinned write and the launch
            _tr.record_span("io.h2d", tctx, t0, time.perf_counter())
        n = len(data)
        return (DataBatch(staged[:n], staged[n:], pad=pad,
                          provide_data=self.provide_data,
                          provide_label=self.provide_label), event)

    def _run_inline(self):
        """num_workers 0: decode on this thread, the same get_batch
        stream as the pool's."""
        epoch = self._epoch
        for index in range(self._next_index, self._source.num_batches(epoch)):
            if self._stop:
                return
            _fault.inject("io.worker")
            t0 = time.perf_counter()
            data, label, pad = self._source.get_batch(epoch, index)
            tctx = self._trace_ctx
            if tctx is not None:
                _tr.record_span("io.decode", tctx, t0, time.perf_counter())
            if not self._push(self._stage(data, label, pad)):
                return
        self._push(_END)

    def _salvage(self):
        """The results already in the output queue."""
        got = []
        while True:
            try:
                got.append(self._out_q.get(timeout=0.1))
            except _queue.Empty:
                return got

    def _run_pool(self):
        epoch = self._epoch
        n = self._source.num_batches(epoch)
        next_sched = next_recv = self._next_index
        window = self._num_workers + self._depth
        pending = set()          # scheduled, not yet received
        buffered = {}            # received ahead of their turn
        restarts_left = self._restart_budget
        try:
            while next_recv < n and not self._stop:
                while next_sched < n and len(pending) < window:
                    self._in_q.put((epoch, next_sched))
                    pending.add(next_sched)
                    next_sched += 1
                if next_recv in buffered:
                    data, label, pad, _dt = _shm_load(buffered.pop(next_recv))
                    if not self._push(self._stage(data, label, pad)):
                        return
                    next_recv += 1
                    continue
                try:
                    r_epoch, index, payload, err = \
                        self._out_q.get(timeout=0.5)
                except _queue.Empty:
                    dead = [w for w in self._workers if not w.is_alive()]
                    if not dead:
                        continue
                    salvaged = self._salvage()
                    self._kill_pool()
                    if restarts_left < len(dead):
                        for item in salvaged:
                            _shm_unlink(item[2])
                        # a dead worker's unreported segments are freed
                        # by nobody else
                        self._reclaim_segments(epoch, pending)
                        raise MXNetError(
                            "io pipeline worker crashed and the restart "
                            "budget (MXNET_IO_WORKER_RESTARTS=%d) is "
                            "exhausted" % self._restart_budget)
                    restarts_left -= len(dead)
                    # a fresh pool and queues; the landed results are put
                    # back, everything else scheduled is decoded again (a
                    # task that thereby runs twice is dropped on receipt)
                    salvaged_seqs = {s[1] for s in salvaged if s[0] == epoch}
                    self._reclaim_segments(epoch, pending - salvaged_seqs)
                    self._in_q = self._mp_ctx.Queue()
                    self._out_q = self._mp_ctx.Queue()
                    for item in salvaged:
                        self._out_q.put(item)
                    self._workers = [self._spawn_worker()
                                     for _ in range(self._num_workers)]
                    for seq in sorted(pending - salvaged_seqs):
                        self._in_q.put((epoch, seq))
                    continue
                pending.discard(index)
                if r_epoch != epoch or index < next_recv \
                        or index in buffered:
                    _shm_unlink(payload)   # a duplicate after a restart
                    continue
                if err is not None:
                    raise MXNetError("io pipeline worker failed on batch "
                                     "%d: %s" % (index, err))
                buffered[index] = payload
            if not self._stop:
                self._push(_END)
        finally:
            for payload in buffered.values():
                _shm_unlink(payload)

    # -- consumer side -----------------------------------------------------
    def iter_next(self):
        self._trace_ctx = tctx = _tr.active()
        self._ensure_running()
        t0 = time.perf_counter() if tctx is not None else None
        with self._cond:
            while not self._staged:
                if self._error is not None:
                    break
                if self._end_seen:
                    return False
                self._cond.wait(0.5)
                if self._stager is not None \
                        and not self._stager.is_alive() \
                        and not self._staged:
                    raise MXNetError("io pipeline stager thread died "
                                     "without delivering the epoch end")
            item = self._staged.popleft() if self._staged else _END
            self._cond.notify_all()
        if t0 is not None:
            _tr.record_span("io.batch_wait", tctx, t0, time.perf_counter())
        if item is _END:
            self._current_batch = None
            if self._error is not None:
                # the position is intact: the next call retries the batch
                err, self._error = self._error, None
                self._stager = None
                if isinstance(err, MXNetError):
                    raise err
                raise MXNetError("io pipeline failed: %r" % (err,))
            self._end_seen = True
            return False
        batch, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(event)
            for a in list(batch.data) + list(batch.label):
                a._data.record_stream(cur)
        self._next_index += 1
        self._current_batch = batch
        return True

    def next(self):
        if self.iter_next():
            return self._current_batch
        raise StopIteration

    def getdata(self):
        return self._current_batch.data

    def getlabel(self):
        return self._current_batch.label

    def getpad(self):
        return self._current_batch.pad

    def getindex(self):
        return self._current_batch.index

    def reset(self):
        """The next epoch (a fresh pass under its shuffle). A reset within
        an epoch recycles the pool; the one at its end keeps it."""
        self._halt_segment()
        self._epoch += 1
        self._next_index = 0
        self._end_seen = False
        self._error = None

    # -- the resumable cursor ----------------------------------------------
    def checkpoint_state(self, epoch=None, nbatch=None):
        """The cursor for a checkpoint's manifest: epoch, batch and the
        source's identity (its seed and shard)."""
        st = {"kind": "DataPipeline",
              "epoch": int(self._epoch if epoch is None else epoch),
              "batch": int(self._next_index if nbatch is None else nbatch)}
        fp = getattr(self._source, "cursor_fingerprint", None)
        if fp is not None:
            st["source"] = fp()
        return st

    def restore_state(self, cursor):
        """Seek to a :meth:`checkpoint_state` position: the next batch is
        (epoch, batch) and the stream from there is the uninterrupted
        one's. The seed is adopted; a cursor of another stream (another
        size, batch, shuffle or shard) raises."""
        if cursor.get("kind") not in (None, "DataPipeline"):
            raise MXNetError("io cursor kind %r is not a DataPipeline "
                             "cursor" % cursor.get("kind"))
        saved = dict(cursor.get("source") or {})
        fp = getattr(self._source, "cursor_fingerprint", None)
        mine = fp() if fp is not None else {}
        seed = saved.pop("seed", None)
        mine.pop("seed", None)
        for key, val in saved.items():
            if key in mine and mine[key] != val:
                raise MXNetError(
                    "io cursor was taken over a stream with %s=%r but "
                    "this pipeline has %r: not the same stream"
                    % (key, val, mine[key]))
        self._halt_segment()
        self._teardown_pool()
        if seed is not None and hasattr(self._source, "set_seed"):
            self._source.set_seed(seed)
        self._epoch = int(cursor["epoch"])
        self._next_index = int(cursor.get("batch", 0))
        self._end_seen = False
        self._error = None
