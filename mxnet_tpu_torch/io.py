"""Data iterators.

Counterpart of the JAX package's ``io.py``: ``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter`` (in-memory arrays; ``pad``, ``discard``
and ``roll_over``; seeded per-epoch shuffles), ``ResizeIter``,
``PrefetchingIter`` (read-ahead threads that stage batches onto the card
through pinned buffers), the ``ImageRecordIter`` factory over
``image.ImageIter``, and the partition and seed helpers ``shard_bounds``
and ``mix_seed``. Batches of the in-memory iterators are host NDArrays;
the executor binds them on its device, or ``PrefetchingIter`` stages
them there first. ``DataPipeline`` and its sources, ``CSVIter``,
``LibSVMIter`` and ``MNISTIter`` come with ROADMAP A8.1b; sharding of
``NDArrayIter`` (``num_parts``) with A13.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict, namedtuple

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray, array

_HOST = "cpu"       # batches are staged on the host; executors copy them

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "ImageRecordIter", "shard_bounds", "mix_seed"]


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
