"""The port's post-training quantization against the JAX package's.

Observers: the port's ``MinMaxObserver`` (reducing a tensor where it
lies) and ``PercentileObserver`` give the JAX observers' ranges on the
same batches, exactly. On a small bottleneck ResNet (depth 8, 3x16x16,
10 classes) with the JAX package's Xavier initialization, written by the
JAX package's ``model.save_checkpoint``: the port's
``quantize_checkpoint`` quantizes the same layers to the same int8
weights and per-channel scales, bitwise, and calibrates activation
scales within 1e-6 relative of the JAX package's (the fp32 forwards
differ in the last bits).

On the JAX artifact, given the JAX graph's input to each quantized layer,
the port's layer gives the JAX layer's int8 activations and output
bitwise (the FC layer within the rounding of its product: XLA fuses its
rescale and bias add into one multiply-add). Served whole, by the port's ``Predictor`` and by the JAX
``Predictor``, the outputs agree within relative RMS 1e-4 on every image
none of whose int8 activations flipped. A flip is an activation whose
scaled value lies within an ulp of a rounding boundary, where the
packages' fp32 layers (BatchNorm: XLA's ``rsqrt`` is not correctly
rounded, PyTorch's is) differ by an ulp; it moves that activation one
int8 step, which a network this small carries to its output (one flip in
8 images reads 2.0e-3 over the whole output). Flips are counted: at most
1e-4 of the activations, and most images have none. The port's artifact
loaded and served by the JAX package is held alike.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.models  # noqa: E402,F401
from mxnet_tpu.quantize import calibrate as jcal  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.quantize import calibrate as tcal  # noqa: E402

SHAPE = (3, 16, 16)
X = np.random.RandomState(5).uniform(-1, 1, (16,) + SHAPE).astype(
    np.float32)
ACT_TOL = 1e-6
OUT_TOL = 1e-4


def rel_rms(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


# ---------------------------------------------------------------------------
# observers
# ---------------------------------------------------------------------------

def _batches():
    rng = np.random.RandomState(2)
    return [rng.randn(50, 7).astype(np.float32) * s
            for s in (1.0, 3.0, 0.5, 900.0)] + [
        np.zeros((0, 7), np.float32), np.full((4, 7), -2.0, np.float32)]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_minmax_observer_equals_jax(as_tensor):
    ours, theirs = tcal.MinMaxObserver(), jcal.MinMaxObserver()
    assert ours.ranges() == theirs.ranges() == (0.0, 0.0)
    for b in _batches():
        ours.observe(torch.from_numpy(b) if as_tensor else b)
        theirs.observe(b)
        assert ours.ranges() == theirs.ranges()


@pytest.mark.parametrize("percentile", [99.99, 90.0, 100.0])
def test_percentile_observer_equals_jax(percentile):
    ours = tcal.PercentileObserver(percentile, bins=64)
    theirs = jcal.PercentileObserver(percentile, bins=64)
    for b in _batches():        # the x900 batch folds every old bin
        ours.observe(torch.from_numpy(b))
        theirs.observe(b)
        assert ours.ranges() == theirs.ranges()


def test_percentile_observer_keeps_a_zero_floor_and_reads_its_knob(
        monkeypatch):
    obs = tcal.PercentileObserver()
    obs.observe(np.abs(np.random.RandomState(0).randn(1000)))
    assert obs.ranges()[0] == 0.0
    monkeypatch.setenv("MXNET_QUANT_PERCENTILE", "50")
    assert tcal.PercentileObserver()._p == 50.0
    with pytest.raises(MXNetError):
        tcal.PercentileObserver(0.0)
    with pytest.raises(MXNetError):
        tcal.make_observer("kl")


# ---------------------------------------------------------------------------
# quantize_checkpoint of a JAX-written checkpoint, both packages
# ---------------------------------------------------------------------------

def _symbol(mx):
    return mx.models.resnet(num_classes=10, num_layers=8, image_shape=SHAPE,
                            bottle_neck=True)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX-written checkpoint of the small ResNet (JAX's Xavier init,
    one SGD step so that BatchNorm's moving statistics are not the
    init's), and both packages' artifacts of it."""
    tmp = tmp_path_factory.mktemp("q")
    prefix = str(tmp / "resnet8")
    mod = jmx.mod.Module(_symbol(jmx), context=jmx.cpu())
    jmx.random.seed(0)
    mod.fit(jmx.io.NDArrayIter(X[:4], np.arange(4, dtype=np.float32),
                               batch_size=4), num_epoch=1,
            initializer=jmx.init.Xavier(rnd_type="gaussian",
                                        factor_type="in", magnitude=2),
            optimizer_params={"learning_rate": 0.1})
    arg, aux = mod.get_params()
    jmx.model.save_checkpoint(prefix, 0, _symbol(jmx), arg, aux)
    jqp = jmx.quantize.quantize_checkpoint(
        prefix, jmx.io.NDArrayIter(X, np.zeros(16, np.float32),
                                   batch_size=8),
        calib_mode="naive", out_prefix=prefix + "-jax-int8")
    tqp = tmx.quantize.quantize_checkpoint(
        prefix, tmx.io.NDArrayIter(X, np.zeros(16, np.float32),
                                   batch_size=8),
        calib_mode="naive", out_prefix=prefix + "-port-int8",
        ctx=tmx.cpu())
    return prefix, jqp, tqp


def test_same_layers_weights_and_scales(ckpt):
    _, jqp, tqp = ckpt
    assert sorted(tqp.meta) == sorted(jqp.meta)
    assert len(tqp.meta) == 14       # 10 convs, 3 shortcuts, the FC
    assert sorted(tqp.arg_params) == sorted(jqp.arg_params)
    for k, v in jqp.arg_params.items():
        got = tqp.arg_params[k].asnumpy()
        want = v.asnumpy()
        assert got.dtype == want.dtype, k
        if k.endswith(("_weight_q", "_w_scale")):
            assert got.tobytes() == want.tobytes(), k
    assert tqp.symbol.list_arguments() == jqp.symbol.list_arguments()
    assert tqp.symbol.list_auxiliary_states() == \
        jqp.symbol.list_auxiliary_states()


def test_activation_scales_agree(ckpt):
    _, jqp, tqp = ckpt
    for name, m in jqp.meta.items():
        ours = tqp.meta[name]
        assert ours["op"] == m["op"] and ours["channels"] == m["channels"]
        assert abs(ours["act_scale"] - m["act_scale"]) \
            <= ACT_TOL * m["act_scale"], name


def _serve_port(qp_or_json, blob, rows):
    pred = tmx.serving.Predictor(qp_or_json, blob, dev_type=1,
                                 input_shapes={"data": (rows,) + SHAPE})
    pred.set_input("data", X[:rows].tobytes())
    pred.forward()
    return np.frombuffer(pred.get_output(0), np.float32).reshape(
        pred.get_output_shape(0))


def _serve_jax(qp_or_json, blob, rows):
    pred = jmx.serving.Predictor(qp_or_json, blob, dev_type=1,
                                 input_shapes={"data": (rows,) + SHAPE})
    pred.set_input("data", X[:rows].tobytes())
    pred.forward()
    return np.frombuffer(pred.get_output(0), np.float32).reshape(
        pred.get_output_shape(0))


def _internals(mx, qp, rows):
    """Every internal output of ``qp``'s graph on X[:rows], by name."""
    sym = qp.symbol.get_internals()
    exe = sym.simple_bind(ctx=mx.cpu(), grad_req="null",
                          type_dict={k: v.dtype
                                     for k, v in qp.arg_params.items()},
                          data=(rows,) + SHAPE)
    for k, v in qp.arg_params.items():
        if k in exe.arg_dict:
            exe.arg_dict[k][:] = v
    for k, v in qp.aux_params.items():
        exe.aux_dict[k][:] = v
    outs = exe.forward(is_train=False,
                       data=mx.nd.array(X[:rows], ctx=mx.cpu()))
    return dict(zip(sym.list_outputs(), (o.asnumpy() for o in outs)))


def _quantized_layers(qp):
    """(node, input name, output name) of each int8 layer of ``qp``."""
    from mxnet_tpu_torch.symbol.symbol import _topo
    out = []
    for node in _topo(qp.symbol._entries):
        if node.op in ("_contrib_quantized_fc_int8",
                       "_contrib_quantized_conv_int8"):
            src = node.inputs[0][0]
            out.append((node, src.name if src.is_var
                        else src.name + "_output", node.name + "_output"))
    return out


def _flips(qp, a, b):
    """Per image, how many int8 activations differ between two forwards'
    internals ``a`` and ``b`` of ``qp``, and the activations counted."""
    from mxnet_tpu_torch.ops.quantization_ops import _quantize_act
    flips, total = 0, 0
    for node, src, _ in _quantized_layers(qp):
        s = node.attrs["act_scale"]
        qa = _quantize_act(torch.from_numpy(a[src]), s).numpy()
        qb = _quantize_act(torch.from_numpy(b[src]), s).numpy()
        flips = flips + (qa != qb).reshape(qa.shape[0], -1).sum(1)
        total += qa.size
    return flips, total


def _hold_whole(qp, want, got, a, b):
    """Images none of whose activations flipped agree within OUT_TOL;
    flips are rare and leave most images untouched."""
    flips, total = _flips(qp, a, b)
    clean = flips == 0
    assert clean.mean() >= 0.5, flips
    assert flips.sum() <= 1e-4 * total, (flips.sum(), total)
    assert rel_rms(got[clean], want[clean]) <= OUT_TOL


def test_jax_artifact_layers_match_given_identical_inputs(ckpt):
    """Each int8 layer of the port, fed the JAX graph's input to it,
    gives the JAX layer's output bitwise (and so its int8 activations)."""
    from mxnet_tpu_torch.ops import registry as treg
    prefix, _, _ = ckpt
    jqp = jmx.quantize.QuantizedParams.load(prefix + "-jax-int8")
    tqp = tmx.quantize.QuantizedParams.load(prefix + "-jax-int8")
    ref = _internals(jmx, jqp, 8)
    layers = _quantized_layers(tqp)
    assert len(layers) == 14
    for node, src, dst in layers:
        args = [torch.from_numpy(ref[src])] + [
            tqp.arg_params[n.name]._data for n, _ in node.inputs[1:]]
        attrs = {k: v for k, v in node.attrs.items()
                 if not k.startswith("__")}
        got = treg.get_op(node.op).fn(*args, **attrs).numpy()
        if len(node.inputs) == 3:
            assert got.tobytes() == ref[dst].tobytes(), node.name
        else:
            # XLA fuses the rescale and the bias add into one multiply-
            # add; the port rounds the product first (as the op reads)
            prod = treg.get_op(node.op).fn(
                *args[:3], **dict(attrs, no_bias=True)).numpy()
            assert (np.abs(got - ref[dst]) <= np.spacing(np.abs(prod))
                    + np.spacing(np.abs(ref[dst]))).all(), node.name


def test_jax_artifact_served_by_port_matches_jax_predictor(ckpt):
    prefix, _, _ = ckpt
    jqp = jmx.quantize.QuantizedParams.load(prefix + "-jax-int8")
    tqp = tmx.quantize.QuantizedParams.load(prefix + "-jax-int8")
    want = _serve_jax(jqp.symbol_json, jqp.param_bytes(), 8)
    got = _serve_port(tqp.symbol_json, tqp.param_bytes(), 8)
    assert got.shape == (8, 10)
    _hold_whole(tqp, want, got, _internals(jmx, jqp, 8),
                _internals(tmx, tqp, 8))
    # the JAX package's blob bytes serve alike
    got2 = _serve_port(jqp.symbol_json, jqp.param_bytes(), 8)
    assert got2.tobytes() == got.tobytes()


def test_port_artifact_served_by_jax_matches_port(ckpt):
    prefix, _, tqp = ckpt
    jqp = jmx.quantize.QuantizedParams.load(prefix + "-port-int8")
    assert sorted(jqp.meta) == sorted(tqp.meta)
    want = _serve_port(tqp.symbol_json, tqp.param_bytes(), 8)
    got = _serve_jax(jqp.symbol_json, jqp.param_bytes(), 8)
    _hold_whole(tqp, want, got, _internals(tmx, tqp, 8),
                _internals(jmx, jqp, 8))


def test_int8_forward_tracks_fp32(ckpt):
    prefix, _, tqp = ckpt
    with open(prefix + "-0000.params", "rb") as f:
        blob = f.read()
    fp32 = _serve_port(_symbol(tmx).tojson(), blob, 8)
    int8 = _serve_port(tqp.symbol_json, tqp.param_bytes(), 8)
    assert np.abs(int8 - fp32).max() < 0.05
    assert (int8.argmax(1) == fp32.argmax(1)).mean() >= 0.75


def test_calibration_binds_once_per_batch_shape(ckpt):
    prefix, _, _ = ckpt
    c = tmx.telemetry.counter("quantize/calib_binds_total").labels()
    sym, arg, aux = tmx.model.load_checkpoint(prefix, 0)
    n0 = c.value
    tcal.collect_activation_ranges(
        sym, arg, aux, tmx.io.NDArrayIter(X, np.zeros(16, np.float32),
                                          batch_size=4), ctx=tmx.cpu())
    assert c.value == n0 + 1
    batches = [X[:4], X[4:8], X[8:10]]          # bare arrays, 2 shapes
    ranges = tcal.collect_activation_ranges(sym, arg, aux, batches,
                                            ctx=tmx.cpu())
    assert c.value == n0 + 3
    assert ranges[("data", 0)] == (float(X[:10].min()), float(X[:10].max()))
    with pytest.raises(MXNetError, match="no batches"):
        tcal.collect_activation_ranges(sym, arg, aux, [], ctx=tmx.cpu())


def test_excluded_layers(ckpt, tmp_path):
    prefix, _, _ = ckpt
    it = tmx.io.NDArrayIter(X[:8], np.zeros(8, np.float32), batch_size=8)
    with pytest.raises(MXNetError, match="name no op node"):
        tmx.quantize.quantize_checkpoint(prefix, it, ctx=tmx.cpu(),
                                         excluded_sym_names=["fc9"],
                                         out_prefix=str(tmp_path / "x"))
    qp = tmx.quantize.quantize_checkpoint(
        prefix, it, ctx=tmx.cpu(), excluded_sym_names=["fc1"],
        out_prefix=str(tmp_path / "y"))
    assert "fc1" not in qp.meta and len(qp.meta) == 13
    assert "fc1_weight" in qp.arg_params
    ops = {n["op"] for n in __import__("json").loads(qp.symbol_json)[
        "nodes"]}
    assert "FullyConnected" in ops and "_contrib_quantized_fc_int8" not in ops


def test_quantize_checkpoint_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(MXNetError, match="no checkpoint"):
        tmx.quantize.quantize_checkpoint(str(tmp_path / "none"), [X[:2]],
                                         ctx=tmx.cpu())
