"""Checkpoint files between the port and the JAX package.

``nd.save`` / ``nd.load`` go both ways between the packages, in both
layouts (the zip of NPY members with its ``__meta__`` and ``__dtypes__``
members, and the reference's binary ``.params``), with int8, bfloat16
(zip layout only: the reference format has no bfloat16 type) and float32
arrays, bitwise. ``model.save_checkpoint`` writes what the JAX package's
``load_checkpoint`` reads and the reverse, each package verifying the
other's manifests; the symbol files (int8 variables included) load both
ways. A torn or corrupt params file is detected, and
``load_latest_valid`` falls back to the newest checkpoint that verifies.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.models  # noqa: E402,F401

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import checkpoint as tck  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

FORMATS = ["mxtpu", "mxnet"]


def _arrays():
    rng = np.random.RandomState(4)
    return {"w8": rng.randint(-127, 128, (5, 7)).astype(np.int8),
            "f32": rng.randn(3, 4, 2).astype(np.float32),
            "i32": rng.randint(-9, 9, (6,)).astype(np.int32),
            "bf16": rng.randn(4, 3).astype(np.float32)}


def _bf16_bits(t):
    return t.reshape(-1).view(torch.int16).numpy()


def _port_dict(arrs, with_bf16):
    out = {k: tmx.nd.array(v, dtype=v.dtype, ctx=tmx.cpu())
           for k, v in arrs.items()
           if k != "bf16"}
    if with_bf16:
        out["bf16"] = tmx.nd.NDArray(torch.from_numpy(arrs["bf16"]).to(
            torch.bfloat16))
    return out


def _jax_dict(arrs, with_bf16):
    import jax.numpy as jnp
    out = {k: jmx.nd.array(v, dtype=v.dtype) for k, v in arrs.items()
           if k != "bf16"}
    if with_bf16:
        out["bf16"] = jmx.nd.array(np.asarray(
            jnp.asarray(arrs["bf16"]).astype(jnp.bfloat16)),
            dtype=jnp.bfloat16)
    return out


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_writes_what_jax_loads(tmp_path, fmt):
    arrs = _arrays()
    bf = fmt == "mxtpu"
    path = str(tmp_path / "a.params")
    tmx.nd.save(path, _port_dict(arrs, bf), format=fmt)
    back = jmx.nd.load(path)
    assert sorted(back) == sorted(_port_dict(arrs, bf))
    for k in ("w8", "f32", "i32"):
        got = back[k].asnumpy()
        assert got.dtype == arrs[k].dtype
        assert got.tobytes() == arrs[k].tobytes()
    if bf:
        want = _bf16_bits(torch.from_numpy(arrs["bf16"]).to(torch.bfloat16))
        got = np.asarray(back["bf16"].asnumpy()).view(np.int16).reshape(-1)
        assert str(back["bf16"].dtype) == "bfloat16"
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("fmt", FORMATS)
def test_jax_writes_what_port_loads(tmp_path, fmt):
    arrs = _arrays()
    bf = fmt == "mxtpu"
    path = str(tmp_path / "a.params")
    jmx.nd.save(path, _jax_dict(arrs, bf), format=fmt)
    back = tmx.nd.load(path)
    for k in ("w8", "f32", "i32"):
        got = back[k].asnumpy()
        assert got.dtype == arrs[k].dtype
        assert got.tobytes() == arrs[k].tobytes()
    if bf:
        assert back["bf16"]._data.dtype == torch.bfloat16
        want = _bf16_bits(torch.from_numpy(arrs["bf16"]).to(torch.bfloat16))
        assert _bf16_bits(back["bf16"]._data).tobytes() == want.tobytes()


@pytest.mark.parametrize("fmt", FORMATS)
def test_lists_round_trip_in_the_port(tmp_path, fmt):
    path = str(tmp_path / "l.params")
    arrs = [tmx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3),
                         ctx=tmx.cpu()),
            tmx.nd.array(np.ones(4, np.int8), dtype=np.int8, ctx=tmx.cpu())]
    tmx.nd.save(path, arrs, format=fmt)
    back = tmx.nd.load(path)
    assert isinstance(back, list) and len(back) == 2
    assert back[1].dtype == np.int8
    np.testing.assert_array_equal(back[0].asnumpy(), arrs[0].asnumpy())


def test_mxnet_format_refuses_bfloat16_and_scalars(tmp_path):
    bf = tmx.nd.NDArray(torch.zeros(3, dtype=torch.bfloat16))
    with pytest.raises(MXNetError):
        tmx.nd.save(str(tmp_path / "b"), {"x": bf}, format="mxnet")
    with pytest.raises(MXNetError):
        tmx.nd.save(str(tmp_path / "c"), {"x": tmx.nd.NDArray(
            torch.tensor(1.0))}, format="mxnet")


@pytest.mark.parametrize("fmt", FORMATS)
def test_torn_params_file_is_reported(tmp_path, fmt):
    path = str(tmp_path / "t.params")
    tmx.nd.save(path, {"x": tmx.nd.array(np.ones((64, 64), np.float32),
                                         ctx=tmx.cpu())},
                format=fmt)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    with pytest.raises(MXNetError, match="corrupt or truncated"):
        tmx.nd.load(path)


def test_save_is_atomic_when_the_write_fails(tmp_path):
    path = str(tmp_path / "keep.params")
    tmx.nd.save(path, {"x": tmx.nd.array(np.ones(3, np.float32),
                                         ctx=tmx.cpu())})
    before = open(path, "rb").read()

    class Boom(object):
        _data = None     # not an NDArray: save refuses before writing

    with pytest.raises(MXNetError):
        tmx.nd.save(path, {"x": Boom()})
    with pytest.raises(RuntimeError):
        with tck.atomic_writer(path) as f:
            f.write(b"partial")
            raise RuntimeError("crash mid-write")
    assert open(path, "rb").read() == before
    assert os.listdir(str(tmp_path)) == ["keep.params"]


# ---------------------------------------------------------------------------
# checkpoints: params + symbol + manifest
# ---------------------------------------------------------------------------

def _mlp(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = mx.sym.FullyConnected(act, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(8, 5).astype(np.float32),
            "fc1_bias": rng.randn(8).astype(np.float32),
            "fc2_weight": rng.randn(3, 8).astype(np.float32),
            "fc2_bias": rng.randn(3).astype(np.float32)}


def test_port_checkpoint_loads_and_verifies_in_jax(tmp_path):
    prefix = str(tmp_path / "p")
    params = _params()
    tmx.model.save_checkpoint(prefix, 3, _mlp(tmx),
                              {k: tmx.nd.array(v, ctx=tmx.cpu())
                               for k, v in params.items()},
                              {})
    man = jmx.checkpoint.verify_checkpoint(prefix, 3)
    assert man["epoch"] == 3 and set(man["files"]) == {"params", "symbol"}
    sym, arg, aux = jmx.model.load_checkpoint(prefix, 3)
    assert sym.list_arguments() == _mlp(jmx).list_arguments()
    for k, v in params.items():
        assert arg[k].asnumpy().tobytes() == v.tobytes()
    assert aux == {}
    # the manifest's rng is the port's generator state, as JSON
    assert set(json.load(open(tck.manifest_path(prefix, 3)))["rng"]) == {
        "seed", "generators"}


def test_jax_checkpoint_loads_and_verifies_in_port(tmp_path):
    prefix = str(tmp_path / "j")
    params = _params(1)
    jmx.model.save_checkpoint(prefix, 0, _mlp(jmx),
                              {k: jmx.nd.array(v) for k, v in params.items()},
                              {})
    tck.verify_checkpoint(prefix, 0)
    sym, arg, aux = tmx.model.load_checkpoint(prefix, 0)
    assert sym.list_arguments() == _mlp(tmx).list_arguments()
    for k, v in params.items():
        assert arg[k].asnumpy().tobytes() == v.tobytes()
    got = tmx.model.load_latest_valid(prefix)
    assert got[3] == 0 and sorted(got[1]) == sorted(params)


@pytest.mark.parametrize("damage", ["truncate", "flip", "manifest"])
def test_load_latest_valid_falls_back_past_a_damaged_checkpoint(tmp_path,
                                                               damage):
    prefix = str(tmp_path / "run")
    sym = _mlp(tmx)
    for epoch in (1, 2):
        tmx.model.save_checkpoint(
            prefix, epoch, sym,
            {k: tmx.nd.array(v, ctx=tmx.cpu())
             for k, v in _params(epoch).items()}, {})
    path = "%s-0002.params" % prefix
    blob = open(path, "rb").read()
    if damage == "truncate":
        open(path, "wb").write(blob[:len(blob) - 9])
    elif damage == "flip":
        mid = len(blob) // 2
        open(path, "wb").write(blob[:mid] + bytes([blob[mid] ^ 0xFF])
                               + blob[mid + 1:])
    else:
        open(tck.manifest_path(prefix, 2), "w").write('{"torn": ')
    with pytest.raises(tck.CheckpointCorruptError):
        tck.verify_checkpoint(prefix, 2)
    n0 = tmx.telemetry.counter("checkpoint/corrupt_total").labels().value
    state = tck.load_latest_valid(prefix)
    assert state.epoch == 1
    assert state.arg_params["fc1_weight"].asnumpy().tobytes() == \
        _params(1)["fc1_weight"].tobytes()
    assert tmx.telemetry.counter(
        "checkpoint/corrupt_total").labels().value == n0 + 1
    # the JAX package falls back alike over the port's files
    assert jmx.checkpoint.load_latest_valid(prefix).epoch == 1


def test_every_checkpoint_damaged_raises(tmp_path):
    prefix = str(tmp_path / "bad")
    tmx.model.save_checkpoint(prefix, 0, None, {"w": tmx.nd.array(
        np.ones(3, np.float32), ctx=tmx.cpu())}, {})
    open("%s-0000.params" % prefix, "wb").write(b"junk")
    with pytest.raises(tck.CheckpointCorruptError, match="every checkpoint"):
        tck.load_latest_valid(prefix)
    assert tck.load_latest_valid(str(tmp_path / "none")) is None


def test_list_checkpoints_takes_the_prefix_literally(tmp_path):
    prefix = str(tmp_path / "run[1]")
    for e in (0, 12):
        tmx.model.save_checkpoint(prefix, e, None, {"w": tmx.nd.array(
            np.ones(2, np.float32), ctx=tmx.cpu())}, {})
    assert tck.list_checkpoints(prefix) == [0, 12]


def test_symbol_files_with_int8_variables_load_both_ways(tmp_path):
    def graph(mx):
        data = mx.sym.Variable("data")
        w = mx.sym.Variable("fc_weight_q", shape=(4, 6), dtype="int8")
        s = mx.sym.Variable("fc_w_scale", shape=(4,))
        return mx.sym._contrib_quantized_fc_int8(
            data, w, s, num_hidden=4, no_bias=True, act_scale=12.5,
            name="fc_int8")

    for save_mx, load_mx in ((tmx, jmx), (jmx, tmx)):
        path = str(tmp_path / ("%s.json" % save_mx.__name__))
        graph(save_mx).save(path)
        sym = load_mx.sym.load(path)
        assert sym.list_arguments() == ["data", "fc_weight_q", "fc_w_scale"]
        nodes = json.loads(sym.tojson())["nodes"]
        assert nodes[1]["attrs"]["__dtype__"] == "int8"
        assert list(nodes[1]["attrs"]["__shape__"]) == [4, 6]
    # a port-bound int8 graph runs, its weight bound as int8
    sym = tmx.sym.load(str(tmp_path / "mxnet_tpu.json"))
    exe = sym.simple_bind(ctx=tmx.cpu(), grad_req="null",
                          type_dict={"fc_weight_q": np.int8}, data=(2, 6))
    assert exe.arg_dict["fc_weight_q"]._data.dtype == torch.int8
    assert sym.infer_shape(data=(2, 6))[1] == [(2, 4)]
    exe.arg_dict["fc_weight_q"][:] = np.ones((4, 6), np.int8)
    exe.arg_dict["fc_w_scale"][:] = np.full(4, 0.5, np.float32)
    out = exe.forward(is_train=False, data=np.full((2, 6), 0.08,
                                                   np.float32))[0]
    # q = round(0.08 * 12.5) = 1; 6 * 1 * 1 * (0.5 / 12.5)
    np.testing.assert_allclose(out.asnumpy(), np.full((2, 4), 0.24),
                               rtol=1e-6)


def test_get_internals_matches_jax_order(tmp_path):
    internals = {}

    def build(mx):
        sym = mx.models.resnet(num_classes=10, num_layers=8,
                               image_shape=(3, 16, 16), bottle_neck=True)
        internals[mx] = sym.get_internals().list_outputs()

    # each package's auto-namer counts per thread: a fresh thread gives
    # both the same counters, whatever symbols earlier tests made
    for mx in (tmx, jmx):
        th = threading.Thread(target=build, args=(mx,))
        th.start()
        th.join()
    assert internals[tmx] == internals[jmx]
    assert internals[tmx][0] == "data"
    sym = _mlp(tmx)
    assert sym.get_internals()["fc1_output"].list_outputs() == [
        "fc1_output"]
    assert sym.get_internals()[0].name == "data"


# ---------------------------------------------------------------------------
# quantized artifacts are checkpoints with a "quantized" manifest entry
# ---------------------------------------------------------------------------

def _artifact(tmp_path):
    prefix = str(tmp_path / "mlp")
    tmx.model.save_checkpoint(
        prefix, 0, _mlp(tmx),
        {k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in _params(2).items()}, {})
    x = np.random.RandomState(3).randn(6, 5).astype(np.float32)
    return prefix, tmx.quantize.quantize_checkpoint(
        prefix, [x], calib_mode="naive", ctx=tmx.cpu())


def test_a_plain_checkpoint_is_refused_as_an_artifact(tmp_path):
    prefix, qp = _artifact(tmp_path)
    with pytest.raises(MXNetError, match="plain checkpoint"):
        tmx.quantize.QuantizedParams.load(prefix)
    with pytest.raises(MXNetError, match="no quantized artifact"):
        tmx.quantize.QuantizedParams.load(str(tmp_path / "nothing"))
    back = tmx.quantize.QuantizedParams.load(qp.prefix)
    assert back.meta == json.loads(json.dumps(qp.meta))
    assert back.arg_params["fc1_weight_q"]._data.dtype == torch.int8
    assert back.param_bytes() == qp.param_bytes()


def test_a_corrupt_artifact_is_detected(tmp_path):
    _, qp = _artifact(tmp_path)
    path = "%s-0000.params" % qp.prefix
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-1] + bytes([blob[-1] ^ 1]))
    with pytest.raises(tck.CheckpointCorruptError, match="checksum"):
        tmx.quantize.QuantizedParams.load(qp.prefix)

