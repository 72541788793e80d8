"""The port's input pipeline (``io.DataPipeline`` and its sources) and
``CSVIter`` / ``MNISTIter`` against the JAX package's, on the CPU.

* ``DataPipeline(ArrayBatchSource)`` (seeded shuffles, a per-batch
  augmentation) and ``DataPipeline(RecordBatchSource)`` over a 32-record
  ``.rec`` (random crop and mirror after a resize, decoded on the python
  route as the JAX source decodes) give the JAX package's inline stream
  bitwise, data, label and ``pad``, over 2 epochs, with 0 and with 2
  worker processes;
* the parts of a sharded source are disjoint and cover the stream;
* a cursor taken mid-epoch and restored into a new pipeline (another
  seed, 2 workers) continues the uninterrupted stream bitwise, across
  the epoch's end; a cursor of another stream raises;
* a worker killed with SIGKILL is restarted and the stream has no lost,
  duplicated or reordered batch; past the restart budget the pipeline
  raises and leaves no shared-memory segment of its own behind;
* ``close()`` is idempotent, leaves no segment, and the next use goes on
  where the pipeline stopped;
* ``CSVIter`` and ``MNISTIter`` (idx files written here, raw and
  ``.gz``) give the JAX iterators' batches bitwise;
* ``Module.fit(resume=True)`` over a pipeline seeks to the checkpoint's
  cursor: it draws no batch before the resumed one, and ends with the
  uninterrupted fit's parameters bitwise.

Staging onto the card is held in ``tests/test_torch_cuda.py``.
"""
import gzip
import os
import signal
import struct

import numpy as np
import pytest

pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

import mxnet_tpu.io as jio  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import io as tio  # noqa: E402
from mxnet_tpu_torch import recordio  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

DATA = np.arange(200, dtype=np.float32).reshape(50, 4)
LABEL = np.arange(50, dtype=np.float32)
REC_SHAPE = (3, 24, 24)
REC_AUG = dict(resize=28, rand_crop=True, rand_mirror=True)


def _double_augment(data_list, rng):
    """Module level, so that a worker can run it: a seeded jitter."""
    noise = rng.normal(size=data_list[0].shape).astype(np.float32)
    return [data_list[0] * 2.0 + noise] + list(data_list[1:])


def _stream(io, src, workers, epochs=2, **kw):
    if io is tio:
        kw.setdefault("ctx", tmx.cpu())
    out = []
    with io.DataPipeline(src, num_workers=workers, prefetch=2, **kw) as p:
        for _ in range(epochs):
            for b in p:
                out.append(([d.asnumpy().copy() for d in b.data],
                            [l.asnumpy().copy() for l in b.label], b.pad))
            p.reset()
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _array_source(io, **kw):
    kw.setdefault("shuffle", True)
    kw.setdefault("seed", 7)
    return io.ArrayBatchSource(DATA, LABEL, batch_size=8, **kw)


def _leaked(prefix):
    return [f for f in os.listdir("/dev/shm") if f.startswith(prefix)] \
        if os.path.isdir("/dev/shm") else []


@pytest.fixture(scope="module")
def rec_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec")
    rng = np.random.RandomState(4)
    path = str(d / "p.rec")
    w = recordio.MXIndexedRecordIO(str(d / "p.idx"), path, "w")
    for i in range(32):
        im = rng.randint(0, 255, (30 + i % 4, 34 - i % 3, 3), dtype=np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(
            0, float(i % 10), i, 0), im))
    w.close()
    return path


@pytest.fixture(scope="module")
def jax_array_stream():
    return _stream(jio, _array_source(jio, augment_fn=_double_augment), 0)


@pytest.mark.parametrize("workers", [0, 2])
def test_array_pipeline_matches_jax(jax_array_stream, workers):
    got = _stream(tio, _array_source(tio, augment_fn=_double_augment),
                  workers)
    assert len(got) == 14
    _same(got, jax_array_stream)


@pytest.mark.parametrize("workers", [0, 2])
def test_record_pipeline_matches_jax(rec_file, workers):
    def src(io):
        return io.RecordBatchSource(rec_file, REC_SHAPE, 8, shuffle=True,
                                    seed=5, aug_kwargs=REC_AUG)
    want = _stream(jio, src(jio), 0)
    got = _stream(tio, src(tio), workers)
    assert len(got) == 8
    _same(got, want)


def test_sharded_sources_cover_stream():
    parts = [_stream(tio, _array_source(
        tio, shuffle=False, num_parts=3, part_index=p,
        last_batch_handle="discard"), 0, epochs=1) for p in range(3)]
    seen = [x for part in parts for (_d, l, _p) in part for x in l[0]]
    assert len(seen) == len(set(seen))              # disjoint
    assert len(seen) == 3 * 16                      # each part's 2 batches
    lo, hi = tio.shard_bounds(50, 3, 1)
    assert sorted(parts[1][0][1][0]) == list(range(lo, lo + 8))


def test_cursor_resume_continues_bitwise():
    full = _stream(tio, _array_source(tio), 0)
    p1 = tio.DataPipeline(_array_source(tio), num_workers=0, ctx=tmx.cpu())
    for _ in range(3):
        p1.next()
    cur = p1.checkpoint_state()
    assert (cur["epoch"], cur["batch"]) == (0, 3)
    p1.close()
    p2 = tio.DataPipeline(_array_source(tio, seed=31337), num_workers=2,
                          ctx=tmx.cpu())
    p2.restore_state(cur)
    rest = []
    for _ in range(2):
        for b in p2:
            rest.append(([b.data[0].asnumpy().copy()],
                         [b.label[0].asnumpy().copy()], b.pad))
        p2.reset()
    p2.close()
    _same(rest, full[3:])
    p3 = tio.DataPipeline(tio.ArrayBatchSource(DATA[:40], LABEL[:40],
                                               batch_size=8),
                          num_workers=0, ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="not the same stream"):
        p3.restore_state(cur)
    p3.close()


class _Killed(tio.ArrayBatchSource):
    """A source whose worker dies by SIGKILL on batch ``index``: once
    (while ``marker`` does not exist), or every time."""

    def __init__(self, *args, index=2, marker=None, **kw):
        super().__init__(*args, **kw)
        self.index, self.marker = index, marker

    def get_batch(self, epoch, index):
        if index == self.index and (self.marker is None
                                    or not os.path.exists(self.marker)):
            if self.marker is not None:
                open(self.marker, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
        return super().get_batch(epoch, index)


def test_killed_worker_restarts_without_loss(tmp_path):
    want = _stream(tio, _array_source(tio, seed=3), 0, epochs=1)
    src = _Killed(DATA, LABEL, batch_size=8, shuffle=True, seed=3,
                  marker=str(tmp_path / "killed"))
    got = _stream(tio, src, 2, epochs=1)
    assert os.path.exists(tmp_path / "killed")
    _same(got, want)


def test_restart_budget_raises_and_leaves_no_segment():
    src = _Killed(DATA, LABEL, batch_size=8, index=1)
    p = tio.DataPipeline(src, num_workers=1, restart_budget=1,
                         ctx=tmx.cpu())
    try:
        with pytest.raises(MXNetError, match="restart budget"):
            list(p)
        assert _leaked(p._shm_prefix) == []
    finally:
        p.close()


def test_close_is_idempotent_and_not_terminal():
    full = _stream(tio, _array_source(tio), 0, epochs=1)
    p = tio.DataPipeline(_array_source(tio), num_workers=2, ctx=tmx.cpu())
    first = [p.next() for _ in range(2)]
    p.close()
    p.close()
    assert not any(w.is_alive() for w in p._workers)
    assert _leaked(p._shm_prefix) == []
    rest = list(p)          # restarts where it stopped
    p.close()
    assert _leaked(p._shm_prefix) == []
    got = [([b.data[0].asnumpy()], [b.label[0].asnumpy()], b.pad)
           for b in first + rest]
    _same(got, full)


def test_pipeline_stages_on_the_card_by_default():
    if tmx.num_gpus():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(MXNetError, match="no CUDA device"):
        tio.DataPipeline(_array_source(tio), num_workers=0)


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_jax(tmp_path, round_batch):
    rng = np.random.RandomState(5)
    data, label = rng.randn(11, 6).astype(np.float32), rng.randint(
        0, 3, (11, 1)).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")

    def run(io):
        it = io.CSVIter(str(tmp_path / "d.csv"), (2, 3),
                        label_csv=str(tmp_path / "l.csv"), batch_size=4,
                        round_batch=round_batch, shuffle=True, seed=9)
        out = []
        for _ in range(2):
            for b in it:
                out.append(([b.data[0].asnumpy()], [b.label[0].asnumpy()],
                            b.pad))
            it.reset()
        return out, [d.name for d in it.provide_label]

    got, names = run(tio)
    want, jnames = run(jio)
    assert names == jnames == ["label"]
    assert len(got) == (6 if round_batch else 4)
    _same(got, want)


def _idx_files(d, n, gz):
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (n, 28, 28), dtype=np.uint8)
    lab = rng.randint(0, 10, n).astype(np.uint8)
    op = gzip.open if gz else open
    ext = ".gz" if gz else ""
    with op(str(d / ("img" + ext)), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
    with op(str(d / ("lab" + ext)), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lab.tobytes())
    return str(d / ("img" + ext)), str(d / ("lab" + ext))


@pytest.mark.parametrize("gz,flat,shuffle", [(False, False, True),
                                             (True, True, False)])
def test_mnist_iter_matches_jax(tmp_path, gz, flat, shuffle):
    img, lab = _idx_files(tmp_path, 21, gz)

    def run(io):
        it = io.MNISTIter(img, lab, batch_size=5, shuffle=shuffle,
                          flat=flat, seed=3)
        return [([b.data[0].asnumpy()], [b.label[0].asnumpy()], b.pad)
                for b in it]

    got = run(tio)
    assert len(got) == 4 and got[0][0][0].shape == (
        (5, 784) if flat else (5, 1, 28, 28))
    _same(got, run(jio))
    with open(tmp_path / "bad", "wb") as f:
        f.write(struct.pack(">IIII", 7, 1, 28, 28))
    with pytest.raises(MXNetError, match="magic"):
        tio.MNISTIter(str(tmp_path / "bad"), lab)


class _Counted(tio.ArrayBatchSource):
    """Records every (epoch, index) it makes (inline pipelines only)."""

    drawn = []

    def get_batch(self, epoch, index):
        _Counted.drawn.append((epoch, index))
        return super().get_batch(epoch, index)


def _fit(prefix, num_epoch, resume=False, stop_at=None):
    """An MLP fitted over a pipeline; ``stop_at=(epoch, nbatch)`` saves a
    checkpoint with the cursor after that batch and stops there."""
    rng = np.random.RandomState(0)
    x = rng.randn(48, 20).astype(np.float32)
    y = rng.randint(0, 10, 48).astype(np.float32)
    src = _Counted(x, y, batch_size=8, shuffle=True, seed=4)
    pipe = tio.DataPipeline(src, num_workers=0, ctx=tmx.cpu())
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=10, name="fc"), name="softmax")
    mod = tmx.mod.Module(net, context=tmx.cpu())

    class Stop(Exception):
        pass

    def at_batch(param):
        if stop_at == (param.epoch, param.nbatch + 1):
            mod.save_checkpoint(prefix, param.epoch, True,
                                nbatch=param.nbatch + 1,
                                io_cursor=pipe.checkpoint_state(
                                    param.epoch, param.nbatch + 1))
            raise Stop()

    tmx.random.seed(0)
    try:
        mod.fit(pipe, num_epoch=num_epoch, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=tmx.init.Uniform(0.1), checkpoint_prefix=prefix,
                resume=resume, batch_end_callback=at_batch)
    except Stop:
        return None
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_fit_resume_seeks_the_cursor(tmp_path):
    want = _fit(str(tmp_path / "full"), 2)
    prefix = str(tmp_path / "cut")
    assert _fit(prefix, 2, stop_at=(1, 2)) is None
    _Counted.drawn = []
    got = _fit(prefix, 2, resume=True)
    assert _Counted.drawn[0] == (1, 2)
    assert (0, 0) not in _Counted.drawn and (1, 0) not in _Counted.drawn
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
