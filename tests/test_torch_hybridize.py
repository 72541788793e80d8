"""The port's hybridize, Symbol trace, export and SymbolBlock against the
JAX package's.

On CPU tensors a hybridized block runs its traced Symbol through the
CachedOp's direct evaluation, a different code path from the eager
``hybrid_forward``; these tests hold that path. Nets are made by both
packages under one prefix, initialized by the JAX package and carried
across with ``convert.gluon_params_from_jax``; inputs are numpy-seeded.
Held:

* every layer of the port's ``nn`` hybridized, in training and predict
  mode under ``autograd.record()``: outputs, the input's gradient,
  every parameter's gradient and value (running statistics) against the
  JAX package's hybridized net within 1e-5 of each set's largest
  magnitude (float32 sums in another order), and the Dense pair of
  ``tests/test_gluon.py:79`` against its own eager self and JAX within
  1e-6;
* BatchNorm's running statistics after 3 hybridized recorded steps
  within 1e-6 of JAX's and of a host-side replay of 3 momentum updates
  (not 2, not 4: the trace adds none);
* ``export`` of the nested net of ``tests/test_gluon.py:282``: the same
  arguments, auxiliary states (two) and outputs as JAX's export, and
  each package's ``SymbolBlock.imports`` of the other's files within
  1e-5 of the exporting net; the same files through
  ``model.load_checkpoint`` and ``serving.Predictor`` give
  ``imports``' outputs;
* ``resnet18_v1`` (10 classes, 2x3x64x64): its trace, made before the
  deferred shapes are known and bound by ``simple_bind``, reproduces the
  Gluon forward within 1e-5, and hybridized it equals its eager self;
* Symbol arithmetic, op by op, against the JAX package's symbols (the
  same graph, the same values within 1e-6, and each package loading the
  other's JSON);
* ``summary`` prints JAX's text;
* the CachedOp follows ``set_data``, ``load_parameters``,
  ``initialize(force_reinit=True)`` and ``cast`` (new values or new
  storage) and goes with ``hybridize(False)``; a second backward without
  ``retain_graph`` raises through a hybridized block.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.gluon.block import SymbolBlock as JSymbolBlock  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.convert import (gluon_params_from_jax,  # noqa: E402
                                     gluon_params_to_numpy)

TOL = 1e-5
RNG = np.random.RandomState(10)
X2 = RNG.uniform(-1, 1, (4, 5)).astype(np.float32)
X4 = RNG.uniform(-1, 1, (2, 3, 8, 8)).astype(np.float32)
X3 = RNG.uniform(-1, 1, (2, 3, 11)).astype(np.float32)
X5 = RNG.uniform(-1, 1, (2, 2, 5, 6, 7)).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _arr(mx, a):
    return mx.nd.array(a, ctx=mx.cpu())


def _fresh_names():
    """Both packages' auto-naming counters from 0, so that two traces
    name their nodes alike."""
    jmx.symbol.symbol._name_mgr._counter = {}
    tmx.symbol.symbol._name_mgr._counter = {}


def _pair(build, x):
    jnet = build(jmx)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    with jmx.autograd.predict_mode():
        jnet(_arr(jmx, x))
    tnet = build(tmx)
    gluon_params_from_jax(jnet.collect_params(), tnet, ctx=tmx.cpu())
    return jnet, tnet


def _run(mx, net, x, train):
    """Outputs, the input's gradient, the parameters' gradients and the
    parameters after one recorded call, the loss the outputs weighted by
    a fixed pattern."""
    a = _arr(mx, x)
    a.attach_grad()
    with mx.autograd.record(train_mode=train):
        out = net(a)
        w = _arr(mx, np.linspace(-1, 1, out.size, dtype=np.float32)
                 .reshape(out.shape))
        loss = (out * w).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    params = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    return [out.asnumpy(), a.grad.asnumpy()], grads, params


def _dense(mx):
    net = mx.gluon.nn.HybridSequential(prefix="hd_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, activation="tanh"),
                mx.gluon.nn.Dense(3))
    return net


def _activations(mx):
    net = mx.gluon.nn.HybridSequential(prefix="ha_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(6, use_bias=False, flatten=False),
                mx.gluon.nn.HybridLambda(lambda F, x: F.relu(x)),
                mx.gluon.nn.HybridLambda("tanh"),
                mx.gluon.nn.Swish(beta=1.5),
                mx.gluon.nn.Activation("softrelu"),
                mx.gluon.nn.Activation("sigmoid"), mx.gluon.nn.Flatten())
    return net


def _batchnorm(mx):
    net = mx.gluon.nn.HybridSequential(prefix="hb_")
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, 3, padding=1),
                mx.gluon.nn.BatchNorm(momentum=0.8),
                mx.gluon.nn.Activation("relu"),
                mx.gluon.nn.BatchNorm(scale=False, center=False,
                                      epsilon=1e-3))
    return net


def _conv2d(mx):
    net = mx.gluon.nn.HybridSequential(prefix="hc_")
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(6, (3, 2), strides=(2, 1), padding=(1, 0),
                                   dilation=(1, 2), activation="relu"),
                mx.gluon.nn.Conv2D(4, 1, groups=2, use_bias=False),
                mx.gluon.nn.MaxPool2D(3, 2, 1),
                mx.gluon.nn.AvgPool2D(2, ceil_mode=True),
                mx.gluon.nn.GlobalMaxPool2D(), mx.gluon.nn.Flatten())
    return net


def _conv1d3d(mx, n):
    net = mx.gluon.nn.HybridSequential(prefix="h%d_" % n)
    nn = mx.gluon.nn
    conv, mp, ap, gp = ((nn.Conv1D, nn.MaxPool1D, nn.AvgPool1D,
                         nn.GlobalAvgPool1D) if n == 1 else
                        (nn.Conv3D, nn.MaxPool3D, nn.AvgPool3D,
                         nn.GlobalAvgPool3D))
    with net.name_scope():
        net.add(conv(4, 3, padding=1), mp(2), ap(1, count_include_pad=False),
                gp())
    return net


LAYERS = [(_dense, X2), (_activations, X4[:, 0]), (_batchnorm, X4),
          (_conv2d, X4), (lambda mx: _conv1d3d(mx, 1), X3),
          (lambda mx: _conv1d3d(mx, 3), X5)]


@pytest.mark.parametrize("train", [True, False], ids=["train", "predict"])
@pytest.mark.parametrize("case", range(len(LAYERS)),
                         ids=["dense", "activations", "batchnorm", "conv2d",
                              "conv1d", "conv3d"])
def test_hybridized_layers_match_jax(case, train):
    build, x = LAYERS[case]
    jnet, tnet = _pair(build, x)
    jnet.hybridize()
    tnet.hybridize()
    want = _run(jmx, jnet, x, train)
    got = _run(tmx, tnet, x, train)
    assert tnet._cached_op is not None and tnet._cached_op.traces == 1
    for w, g in zip(want[0], got[0]):
        assert w.shape == g.shape and _rel(g, w) <= TOL
    for d in (1, 2):
        assert sorted(got[d]) == sorted(want[d])
        scale = max([np.abs(v).max() for v in want[d].values()] + [1e-30])
        for k in want[d]:
            assert np.abs(got[d][k] - want[d][k]).max() <= TOL * scale, k


def test_hybridize_matches_eager_and_jax():
    """``tests/test_gluon.py:79``: the Dense pair hybridized equals its
    eager self and the JAX package's hybridized net (1e-6)."""
    jnet, tnet = _pair(_dense, X2)
    eager = tnet(_arr(tmx, X2)).asnumpy()
    tnet.hybridize()
    jnet.hybridize()
    hybrid = tnet(_arr(tmx, X2)).asnumpy()
    np.testing.assert_allclose(hybrid, eager, rtol=0, atol=1e-6)
    np.testing.assert_allclose(hybrid, jnet(_arr(jmx, X2)).asnumpy(),
                               rtol=0, atol=1e-6)
    assert tnet._cached_op.traces == 1


def test_batchnorm_statistics_after_three_hybridized_steps():
    def build(mx):
        return mx.gluon.nn.BatchNorm(in_channels=3, momentum=0.8,
                                     prefix="b3_")

    x = X4 * 5 + 7
    jnet, tnet = _pair(build, x)
    for net, mx in ((jnet, jmx), (tnet, tmx)):
        net.hybridize()
        for _ in range(3):
            with mx.autograd.record():
                net(_arr(mx, x))
    got = gluon_params_to_numpy(tnet)
    mean, var = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))

    def replay(n):          # n momentum updates from (0, 1), on the host
        m, v = np.zeros(3, np.float32), np.ones(3, np.float32)
        for _ in range(n):
            m = m * np.float32(0.8) + mean * np.float32(0.2)
            v = v * np.float32(0.8) + var * np.float32(0.2)
        return m, v

    for k in ("running_mean", "running_var"):
        want = jnet.collect_params()["b3_" + k].data().asnumpy()
        np.testing.assert_allclose(got["b3_" + k], want, rtol=0, atol=1e-6)
    for n in (2, 3, 4):
        m, v = replay(n)
        close = (np.abs(got["b3_running_mean"] - m).max() <= 1e-5 and
                 np.abs(got["b3_running_var"] - v).max() <= 1e-5)
        assert close == (n == 3), n


def _nested(mx):
    net = mx.gluon.nn.HybridSequential(prefix="ex_")
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, kernel_size=3, padding=1),
                mx.gluon.nn.BatchNorm(), mx.gluon.nn.Activation("relu"),
                mx.gluon.nn.MaxPool2D(pool_size=2), mx.gluon.nn.Flatten(),
                mx.gluon.nn.Dense(3))
    return net


def test_export_round_trips_between_the_packages(tmp_path):
    jnet, tnet = _pair(_nested, X4)
    with tmx.autograd.record():      # move the port's statistics
        tnet(_arr(tmx, X4))
    jnet.collect_params()["ex_batchnorm0_running_mean"].set_data(
        _arr(jmx, gluon_params_to_numpy(tnet)["ex_batchnorm0_running_mean"]))
    jnet.collect_params()["ex_batchnorm0_running_var"].set_data(
        _arr(jmx, gluon_params_to_numpy(tnet)["ex_batchnorm0_running_var"]))
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    _fresh_names()
    jsym = jnet.export(jp, epoch=3)
    tsym = tnet.export(tp, epoch=3)
    for what in ("list_arguments", "list_auxiliary_states", "list_outputs"):
        assert getattr(tsym, what)() == getattr(jsym, what)(), what
    assert len(tsym.list_auxiliary_states()) == 2
    ref = jnet(_arr(jmx, X4)).asnumpy()
    np.testing.assert_allclose(tnet(_arr(tmx, X4)).asnumpy(), ref,
                               rtol=0, atol=TOL * np.abs(ref).max())
    port_of_jax = tmx.gluon.SymbolBlock.imports(
        jp + "-symbol.json", ["data"], jp + "-0003.params", ctx=tmx.cpu())
    jax_of_port = JSymbolBlock.imports(tp + "-symbol.json", ["data"],
                                       tp + "-0003.params")
    for out in (port_of_jax(_arr(tmx, X4)).asnumpy(),
                jax_of_port(_arr(jmx, X4)).asnumpy()):
        assert out.shape == (2, 3) and _rel(out, ref) <= TOL
    # the same files serve through the checkpoint loader and Predictor
    sym, arg, aux = tmx.model.load_checkpoint(tp, 3)
    assert sorted(arg) == sorted(tsym.list_arguments()[1:])
    assert sorted(aux) == sorted(tsym.list_auxiliary_states())
    with open(tp + "-symbol.json") as f, open(tp + "-0003.params", "rb") as g:
        pred = tmx.serving.Predictor(f.read(), g.read(), dev_type=1,
                                     input_shapes={"data": X4.shape})
    pred.set_input("data", X4.astype("<f4").tobytes())
    pred.forward()
    out = np.frombuffer(pred.get_output(0), "<f4").reshape(
        pred.get_output_shape(0))
    imported = tmx.gluon.SymbolBlock.imports(
        tp + "-symbol.json", ["data"], tp + "-0003.params", ctx=tmx.cpu())
    np.testing.assert_array_equal(out, imported(_arr(tmx, X4)).asnumpy())


def test_symbol_block_composes_into_a_traced_net(tmp_path):
    """A SymbolBlock inside a HybridSequential: the outer trace
    substitutes its input, and the composed net hybridized equals the
    parts run one after the other."""
    _, tnet = _pair(_nested, X4)
    tnet.export(str(tmp_path / "n"), 0)
    inner = tmx.gluon.SymbolBlock.imports(
        str(tmp_path / "n-symbol.json"), ["data"],
        str(tmp_path / "n-0000.params"), ctx=tmx.cpu())
    outer = tmx.gluon.nn.HybridSequential(prefix="")
    outer.add(inner, tmx.gluon.nn.Dense(2, in_units=3, prefix="top_"))
    outer.collect_params()["top_weight"].initialize(ctx=tmx.cpu())
    outer.collect_params()["top_bias"].initialize(ctx=tmx.cpu())
    x = _arr(tmx, X4)
    want = outer[1](inner(x)).asnumpy()
    sym = outer._trace_symbol()
    assert sym.list_arguments()[0] == "data"
    outer.hybridize()
    np.testing.assert_allclose(outer(x).asnumpy(), want, rtol=0, atol=1e-6)


def test_resnet18_trace_binds_to_the_gluon_forward():
    """Traced before its first forward (the stem's parameters still of
    unknown shape), bound by ``simple_bind``: the Gluon forward's
    logits."""
    net = tmx.gluon.model_zoo.vision.get_model("resnet18_v1", classes=10,
                                               prefix="r18_")
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    x = RNG.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    sym = net._trace_symbol()
    exe = sym.simple_bind(ctx=tmx.cpu(), grad_req="null", data=x.shape)
    assert exe.arg_dict["r18_conv2d0_weight"].shape == (64, 3, 7, 7)
    ref = net(_arr(tmx, x)).asnumpy()
    for n, p in net.collect_params().items():
        (exe.arg_dict if n in exe.arg_dict else exe.aux_dict)[n][:] = p.data()
    exe.arg_dict["data"][:] = _arr(tmx, x)
    out = exe.forward(is_train=False)[0].asnumpy()
    assert out.shape == (2, 10) and _rel(out, ref) <= TOL
    assert len(sym.list_auxiliary_states()) == 2 * 20
    net.hybridize()
    assert _rel(net(_arr(tmx, x)).asnumpy(), ref) <= TOL


ARITH = [
    ("add", lambda a, b: a + b), ("sub", lambda a, b: a - b),
    ("mul", lambda a, b: a * b), ("div", lambda a, b: a / b),
    ("pow", lambda a, b: a ** b), ("add_scalar", lambda a, b: a + 2),
    ("radd_scalar", lambda a, b: 2 + a), ("sub_scalar", lambda a, b: a - 2),
    ("rsub_scalar", lambda a, b: 2 - a), ("mul_scalar", lambda a, b: a * 3),
    ("rmul_scalar", lambda a, b: 3 * a), ("div_scalar", lambda a, b: a / 4),
    ("rdiv_scalar", lambda a, b: 4 / a), ("pow_scalar", lambda a, b: a ** 2),
    ("neg", lambda a, b: -a), ("gt", lambda a, b: a > b),
    ("ge", lambda a, b: a >= b), ("lt", lambda a, b: a < b),
    ("le", lambda a, b: a <= b), ("gt_scalar", lambda a, b: a > 1.0),
    ("le_scalar", lambda a, b: a <= 1.0),
    ("reshape", lambda a, b: a.reshape((3, 2)) * 2),
    ("chain", lambda a, b: (2 - a) * b / 3 + a ** 2 - (a > b)),
]


def _evaluate(mx, sym, feed):
    exe = sym.simple_bind(ctx=mx.cpu(), grad_req="null",
                          **{k: v.shape for k, v in feed.items()})
    for k, v in feed.items():
        exe.arg_dict[k][:] = _arr(mx, v)
    return exe.forward(is_train=False)[0].asnumpy()


@pytest.mark.parametrize("name,fn", ARITH, ids=[a[0] for a in ARITH])
def test_symbol_arithmetic_matches_jax(name, fn):
    feed = {"a": RNG.uniform(0.5, 1.5, (2, 3)).astype(np.float32),
            "b": RNG.uniform(0.5, 1.5, (2, 3)).astype(np.float32)}
    _fresh_names()
    jsym = fn(jmx.sym.var("a"), jmx.sym.var("b"))
    tsym = fn(tmx.sym.var("a"), tmx.sym.var("b"))
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    jops = [(n["op"], n["name"]) for n in
            __import__("json").loads(jsym.tojson())["nodes"]]
    tops = [(n["op"], n["name"]) for n in
            __import__("json").loads(tsym.tojson())["nodes"]]
    assert tops == jops
    feed = {k: v for k, v in feed.items() if k in tsym.list_arguments()}
    want = _evaluate(jmx, jsym, feed)
    for sym in (tsym, tmx.sym.load_json(jsym.tojson())):
        got = _evaluate(tmx, sym, feed)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        _evaluate(jmx, jmx.sym.load_json(tsym.tojson()), feed), want,
        rtol=1e-6, atol=0)


def test_symbol_compose_group_and_copy():
    _fresh_names()
    x = tmx.sym.var("x")
    fc = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=3,
                                name="fc")
    act = tmx.sym.Activation(fc, act_type="relu", name="act")
    composed = act(data=x * 2)
    assert composed.list_arguments() == ["x", "fc_weight", "fc_bias"]
    assert act.list_arguments() == ["data", "fc_weight", "fc_bias"]
    assert act(tmx.sym.var("y")).list_arguments()[0] == "y"
    g = tmx.sym.Group([act, fc])
    assert g.list_outputs() == ["act_output", "fc_output"]
    assert g.list_inputs() == ["data", "fc_weight", "fc_bias"]
    assert act.get_children().list_outputs() == ["fc_output"]
    assert x.get_children() is None
    c = act.copy()
    assert c.tojson() == act.tojson() and c._entries[0][0] is not \
        act._entries[0][0]
    with pytest.raises(MXNetError, match="no variable"):
        act(nothing=x)


def test_summary_prints_the_jax_text(capsys):
    jnet, tnet = _pair(_nested, X4)
    jnet.summary(_arr(jmx, X4))
    want = capsys.readouterr().out
    tnet.summary(_arr(tmx, X4))
    got = capsys.readouterr().out
    assert got == want and "Total params" in got


def test_cached_op_follows_parameter_changes(tmp_path):
    """After ``set_data``, ``load_parameters``, ``initialize(
    force_reinit=True)`` and ``cast`` the hybridized net gives what an
    eager twin with the same values gives; ``hybridize(False)`` drops
    the CachedOp."""
    jnet, net = _pair(_nested, X4)
    twin = _nested(tmx)
    gluon_params_from_jax(jnet.collect_params(), twin, ctx=tmx.cpu())
    net.hybridize()
    x = _arr(tmx, X4)

    def same(dtype=np.float32):
        got, want = net(x).asnumpy(), twin(x).asnumpy()
        assert got.dtype == dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    same()
    op = net._cached_op
    w = RNG.uniform(-1, 1, (3, 64)).astype(np.float32)
    for n in (net, twin):
        n.collect_params()["ex_dense0_weight"].set_data(_arr(tmx, w))
    same()
    twin.save_parameters(str(tmp_path / "t.params"))
    for n in (net, twin):
        n.collect_params()["ex_conv2d0_weight"].set_data(
            _arr(tmx, np.zeros((4, 3, 3, 3), np.float32)))
    net.load_parameters(str(tmp_path / "t.params"), ctx=tmx.cpu())
    twin.load_parameters(str(tmp_path / "t.params"), ctx=tmx.cpu())
    same()
    assert net._cached_op is op            # in place: the same trace
    for n in (net, twin):
        tmx.random.seed(4)
        n.initialize(tmx.init.Xavier(), ctx=tmx.cpu(), force_reinit=True)
    same()
    for n in (net, twin):
        n.cast("float64")
    x = tmx.nd.array(X4, ctx=tmx.cpu(), dtype="float64")
    same(np.float64)
    assert net._cached_op is not op
    net.hybridize(False)
    assert net._cached_op is None
    same(np.float64)
    assert net._cached_op is None


def test_second_backward_raises_through_a_hybridized_block():
    _, net = _pair(_nested, X4)
    net.hybridize()
    with tmx.autograd.record():
        loss = net(_arr(tmx, X4)).sum()
    loss.backward(retain_graph=True)
    loss.backward()
    with pytest.raises(MXNetError, match="retain_graph"):
        loss.backward()
