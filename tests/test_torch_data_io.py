"""The port's data iterators (``mxnet_tpu_torch.io``) against the JAX
package's.

* ``shard_bounds`` and ``mix_seed`` give the JAX package's values.
* ``NDArrayIter`` gives the JAX package's batches bitwise (data, label,
  ``pad``) over 3 epochs, for ``pad``, ``discard`` and ``roll_over``,
  with and without ``shuffle`` (an int seed, or a ``RandomState`` where
  the JAX package draws its seed from ``np.random``).
* ``ImageRecordIter`` gives the JAX package's batches, labels and
  ``pad`` bitwise on both routes (native: the OpenCV pool; python: the
  Augmenter list, the JAX package's global generators seeded as the
  port's), shuffled, over 2 epochs, for every part of ``num_parts=3``.
* ``PrefetchingIter`` keeps the order of its iterators, ends them
  together, survives ``close()`` and restarts where it stopped, and
  raises a read-ahead thread's exception to the consumer; with a host
  ``ctx`` it stages nothing, and with no ``ctx`` it wants the card.

The staging onto the card (pinned buffers, a side stream, events) is
held in ``tests/test_torch_cuda.py``.
"""
import random

import numpy as np
import pytest

pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.io as jio  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import io as tio  # noqa: E402
from mxnet_tpu_torch import recordio  # noqa: E402

X = np.random.RandomState(0).uniform(-1, 1, (23, 3, 4)).astype(np.float32)
Y = np.arange(23, dtype=np.float32)


def _batches(it, epochs):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [l.asnumpy() for l in b.label], b.pad))
        it.reset()
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_shard_bounds_and_mix_seed_match_jax():
    for n in (0, 1, 7, 23, 100):
        for parts in (1, 2, 3, 8):
            got = [tio.shard_bounds(n, parts, i) for i in range(parts)]
            assert got == [jio.shard_bounds(n, parts, i)
                           for i in range(parts)]
    for parts in ((0,), (5, 0), (2 ** 63, 7), (-1, 3, 9)):
        assert tio.mix_seed(*parts) == jio.mix_seed(*parts)
    with pytest.raises(tmx.MXNetError):
        tio.shard_bounds(10, 3, 3)
    with pytest.raises(tmx.MXNetError):
        tio.shard_bounds(10, 0, 0)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_jax(handle, shuffle):
    kw = dict(batch_size=5, shuffle=shuffle, last_batch_handle=handle)
    if shuffle:
        kw["seed"] = 11
    want = _batches(jio.NDArrayIter(X, Y, **kw), 3)
    got = _batches(tio.NDArrayIter(X, Y, **kw), 3)
    _same(got, want)
    assert got[0][0][0].shape == (5, 3, 4)


def test_ndarray_iter_seed_from_generator_matches_jax():
    np.random.seed(4)
    want = _batches(jio.NDArrayIter(X, Y, batch_size=4, shuffle=True), 2)
    got = _batches(tio.NDArrayIter(X, Y, batch_size=4, shuffle=True,
                                   seed=np.random.RandomState(4)), 2)
    _same(got, want)
    with pytest.raises(NotImplementedError, match="A13"):
        tio.NDArrayIter(X, Y, batch_size=4, num_parts=2)
    with pytest.raises(tmx.MXNetError, match="last_batch_handle"):
        tio.NDArrayIter(X, Y, batch_size=4, last_batch_handle="wrap")


@pytest.fixture(scope="module")
def rec_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec")
    rng = np.random.RandomState(3)
    path = str(d / "t.rec")
    w = recordio.MXIndexedRecordIO(str(d / "t.idx"), path, "w")
    for i in range(22):
        im = rng.randint(0, 255, (44 + i % 5, 48 - i % 3, 3), dtype=np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(
            0, float(i % 7), i, 0), im))
    w.close()
    return path


ROUTES = {
    "native": dict(preprocess_threads=2, rand_crop=True, rand_mirror=True,
                   mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.4,
                   std_g=57.1, std_b=57.4),
    "python": dict(rand_crop=True, rand_mirror=True, mean_r=123.68,
                   mean_g=116.28, mean_b=103.53),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("part", [0, 1, 2])
def test_image_record_iter_matches_jax(rec_file, route, part):
    kw = dict(path_imgrec=rec_file, data_shape=(3, 40, 40), batch_size=3,
              shuffle=True, num_parts=3, part_index=part, seed=2,
              **ROUTES[route])
    random.seed(2)          # the JAX python route draws from `random`
    jit = jio.ImageRecordIter(**kw)
    want = _batches(jit, 2)
    tit = tio.ImageRecordIter(ctx=tmx.cpu(), **kw)
    assert tit.route == route
    got = _batches(tit, 2)
    _same(got, want)
    lo, hi = tio.shard_bounds(22, 3, part)            # 7 or 8 records
    assert [b[2] for b in got][:3] == [0, 0, 9 - (hi - lo)]


def test_image_record_iter_prefetched_on_host(rec_file):
    kw = dict(path_imgrec=rec_file, data_shape=(3, 40, 40), batch_size=4,
              shuffle=True, **ROUTES["native"])
    want = _batches(tio.ImageRecordIter(ctx=tmx.cpu(), **kw), 2)
    it = tio.ImageRecordIter(ctx=tmx.cpu(), prefetch_buffer=2, **kw)
    assert isinstance(it, tio.PrefetchingIter) and it.staged_device is None
    _same(_batches(it, 2), want)
    it.close()
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        tio.ImageRecordIter(prefetch_buffer=2, **kw)    # stages onto cuda:0


def test_prefetching_iter_order_and_restart():
    a = tio.NDArrayIter(X, Y, batch_size=4)
    b = tio.NDArrayIter(X * 2, Y + 100, batch_size=4)
    want = [(x.data + y.data, x.label + y.label, x.pad)
            for x, y in zip(tio.NDArrayIter(X, Y, batch_size=4),
                            tio.NDArrayIter(X * 2, Y + 100, batch_size=4))]
    it = tio.PrefetchingIter([a, b], rename_data=[{"data": "a"},
                                                  {"data": "b"}])
    assert [d.name for d in it.provide_data] == ["a", "b"]
    got = []
    for k, batch in enumerate(it):
        got.append(batch)
        if k == 2:
            it.close()          # mid-epoch: the next batch restarts it
            it.close()
    assert len(got) == len(want) == 6
    for g, (d, l, p) in zip(got, want):
        assert g.pad == p
        for x, y in zip(g.data + g.label, d + l):
            np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())
    it.reset()
    assert len(list(it)) == 6
    it.close()
    with tio.PrefetchingIter(tio.NDArrayIter(X, Y, batch_size=4),
                             device_prefetch=True, ctx=tmx.cpu()) as it2:
        assert it2.staged_device is None and len(list(it2)) == 6
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        tio.PrefetchingIter(tio.NDArrayIter(X, Y, batch_size=4),
                            device_prefetch=True)


def test_prefetching_iter_raises_the_threads_error():
    class Broken(tio.NDArrayIter):
        def next(self):
            batch = super().next()
            if self.cursor >= 8:
                raise ValueError("decode failed")
            return batch

    it = tio.PrefetchingIter(Broken(X, Y, batch_size=4))
    assert it.next().pad == 0 and it.next().pad == 0
    with pytest.raises(ValueError, match="decode failed"):
        it.next()
    it.close()


def test_prefetching_iters_that_end_apart_raise():
    it = tio.PrefetchingIter([tio.NDArrayIter(X, Y, batch_size=4),
                              tio.NDArrayIter(X[:8], Y[:8], batch_size=4)])
    with pytest.raises(tmx.MXNetError, match="ended apart"):
        list(it)
    it.close()
