"""The port's RecordIO (``mxnet_tpu_torch.recordio``) against the JAX
package's.

The same records written by either package give byte-identical ``.rec``
and ``.idx`` files, and each package reads the other's. Multi-chunk
records (cflag 1, 2, 3), written here by hand since neither writer
splits a record, read back joined in both. ``pack`` / ``unpack`` with
numeric and array labels, ``pack_img`` (bytes equal to the JAX
package's), ``unpack_img``, the indexed reader's keys and shards,
pickling, and ``gluon.data.RecordFileDataset`` are held too. A corrupt
file raises in both.
"""
import os
import pickle
import struct

import numpy as np
import pytest

pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

import mxnet_tpu.recordio as jrio  # noqa: E402
from mxnet_tpu.gluon.data import RecordFileDataset as JRecordFileDataset  # noqa: E402,E501

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import recordio as trio  # noqa: E402
from mxnet_tpu_torch.gluon.data import RecordFileDataset  # noqa: E402

MAGIC = 0xced7230a


def _payloads(n=12, seed=0):
    """Record payloads of every length mod 4, one holding the magic."""
    rng = np.random.RandomState(seed)
    out = [rng.bytes(rng.randint(0, 200)) for _ in range(n)]
    out[3] = b""
    out[5] = struct.pack("<I", MAGIC) * 3 + b"xy"
    return out


def _write(pkg, d, tag, payloads, indexed=True):
    rec, idx = os.path.join(d, tag + ".rec"), os.path.join(d, tag + ".idx")
    if indexed:
        w = pkg.MXIndexedRecordIO(idx, rec, "w")
        for i, p in enumerate(payloads):
            w.write_idx(i, p)
    else:
        w = pkg.MXRecordIO(rec, "w")
        for p in payloads:
            w.write(p)
    w.close()
    return rec, idx


@pytest.mark.parametrize("indexed", [True, False])
def test_files_byte_identical_and_cross_readable(tmp_path, indexed):
    payloads = _payloads()
    t = _write(trio, str(tmp_path), "t", payloads, indexed)
    j = _write(jrio, str(tmp_path), "j", payloads, indexed)
    files = (0, 1) if indexed else (0,)
    for k in files:
        with open(t[k], "rb") as a, open(j[k], "rb") as b:
            assert a.read() == b.read()
    for reader, (rec, idx) in ((trio, j), (jrio, t)):
        if indexed:
            r = reader.MXIndexedRecordIO(idx, rec, "r")
            assert r.keys == list(range(len(payloads)))
            for i in (7, 0, 5, 11, 3):
                assert r.read_idx(i) == payloads[i]
        else:
            r = reader.MXRecordIO(rec, "r")
            got = []
            while True:
                x = r.read()
                if x is None:
                    break
                got.append(x)
            assert got == payloads
        r.close()


def _chunked_file(path, records):
    """Write ``records`` (each a list of chunks) with the multi-chunk
    framing: cflag 0 for one chunk, else 1, 2..., 3."""
    with open(path, "wb") as f:
        for chunks in records:
            for k, c in enumerate(chunks):
                if len(chunks) == 1:
                    flag = 0
                elif k == 0:
                    flag = 1
                elif k == len(chunks) - 1:
                    flag = 3
                else:
                    flag = 2
                f.write(struct.pack("<II", MAGIC, (flag << 29) | len(c)))
                f.write(c + b"\0" * ((4 - len(c) % 4) % 4))


def test_multi_chunk_records_read_joined(tmp_path):
    records = [[b"single"], [b"ab", b"cde", b"f"], [b"", b"xyz"],
               [b"1234", b"5678", b"9", b"0"]]
    path = str(tmp_path / "c.rec")
    _chunked_file(path, records)
    for pkg in (trio, jrio):
        r = pkg.MXRecordIO(path, "r")
        got = [r.read() for _ in records]
        assert got == [b"".join(c) for c in records]
        assert r.read() is None
        r.close()


def test_corrupt_file_raises(tmp_path):
    path = str(tmp_path / "bad.rec")
    with open(path, "wb") as f:
        f.write(struct.pack("<II", 0x12345678, 4) + b"abcd")
    for pkg in (trio, jrio):
        r = pkg.MXRecordIO(path, "r")
        with pytest.raises(IOError):
            r.read()
        r.close()
    # a record cut short
    with open(path, "wb") as f:
        f.write(struct.pack("<II", MAGIC, 100) + b"abc")
    r = trio.MXRecordIO(path, "r")
    with pytest.raises(IOError):
        r.read()
    r.close()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0]])
def test_pack_unpack_match_jax(label):
    h = (0, label, 17, 4)
    t = trio.pack(trio.IRHeader(*h), b"payload")
    assert t == jrio.pack(jrio.IRHeader(*h), b"payload")
    th, ts = trio.unpack(t)
    jh, js = jrio.unpack(t)
    assert ts == js == b"payload"
    assert th.flag == jh.flag and th.id == jh.id == 17 and th.id2 == 4
    np.testing.assert_array_equal(np.asarray(th.label),
                                  np.asarray(jh.label))


def test_pack_img_matches_jax_and_unpacks():
    img = np.random.RandomState(1).randint(0, 255, (37, 53, 3),
                                           dtype=np.uint8)
    for fmt, q in ((".jpg", 95), (".png", 3)):
        h = trio.IRHeader(0, 2.0, 9, 0)
        t = trio.pack_img(h, img, quality=q, img_fmt=fmt)
        assert t == jrio.pack_img(jrio.IRHeader(*h), img, quality=q,
                                  img_fmt=fmt)
        header, dec = trio.unpack_img(t)
        jheader, jdec = jrio.unpack_img(t)
        assert header.label == 2.0
        assert dec.context.type == "cpu"
        np.testing.assert_array_equal(dec.asnumpy(), jdec.asnumpy())
        if fmt == ".png":
            np.testing.assert_array_equal(dec.asnumpy(), img)


def test_indexed_shard_keys_and_pickle(tmp_path):
    payloads = _payloads(10)
    rec, idx = _write(trio, str(tmp_path), "s", payloads)
    r = trio.MXIndexedRecordIO(idx, rec, "r")
    j = jrio.MXIndexedRecordIO(idx, rec, "r")
    parts = [r.shard_keys(3, p) for p in range(3)]
    assert parts == [j.shard_keys(3, p) for p in range(3)]
    assert sorted(sum(parts, [])) == list(range(10))
    r2 = pickle.loads(pickle.dumps(r))     # closes r, as the reference
    assert r2.read_idx(4) == payloads[4]
    with pytest.raises(tmx.MXNetError, match="closed"):
        r.read_idx(8)
    r.open()
    assert r.read_idx(8) == payloads[8]
    r.close()
    r2.close()
    j.close()
    with pytest.raises(tmx.MXNetError):
        trio.MXRecordIO(rec, "r").write(b"x")
    with pytest.raises(ValueError):
        trio.MXRecordIO(rec, "a")


def test_record_file_dataset(tmp_path):
    payloads = [b"item%d" % i for i in range(5)]
    rec, _ = _write(jrio, str(tmp_path), "ds", payloads)
    ds, jds = RecordFileDataset(rec), JRecordFileDataset(rec)
    assert len(ds) == len(jds) == 5
    assert [ds[i] for i in range(5)] == [jds[i] for i in range(5)] \
        == payloads
