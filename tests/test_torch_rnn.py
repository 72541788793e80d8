"""The port's recurrent stack against the JAX package's: the ``RNN`` op,
``gluon.rnn`` / ``gluon.contrib.rnn`` cells and layers, and the legacy
``mx.rnn`` cells unrolled into Symbols.

Inputs and weights are drawn with numpy from fixed seeds, uniform in
(-0.5, 0.5) (``rnn_relu``'s pre-activations stay off the kink at 0 but
for a set of measure zero). Held, each within ``TOL`` = 1e-5 of the
largest magnitude of the JAX tensor it is compared with (float32 sums in
other orders over at most 7 steps):

* the op in its four modes, uni- and bidirectional, and LSTMP, at three
  shapes: the output, the final states, and the gradients of a weighted
  sum of all three to the data, the flat weights and the initial states;
  a planted swap of the LSTM's i and f gates in the port must miss by
  more than 100 x ``TOL``;
* inter-layer dropout by definition: the op at ``p`` equals two one-layer
  ops with the mask drawn from the same generator state applied between
  them, predict mode ignores ``p``, and the executor's backward replays
  its forward's mask;
* each ``gluon.rnn`` layer (parameter names equal) eagerly and
  hybridized, with and without states, in both layouts; each cell of
  ``gluon.rnn`` and ``gluon.contrib.rnn`` unrolled inside a block, eager
  and hybridized (the port's traced Symbol), outputs, states and
  gradients; the dropout-based cells in predict mode, where they are the
  identity, and by definition in training;
* the legacy cells, ``FusedRNNCell`` included, unrolled into a Symbol
  with the same argument names, bound and run forward and backward.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.gluon.contrib.rnn  # noqa: E402,F401
import mxnet_tpu.rnn  # noqa: E402,F401

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.convert import gluon_params_from_jax  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402

TOL = 1e-5


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


def _u(seed, shape, scale=0.5):
    return np.random.RandomState(seed).uniform(
        -scale, scale, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the RNN op
# ---------------------------------------------------------------------------

# (T, N, I, H, layers)
SHAPES = [(5, 3, 4, 6, 1), (7, 2, 3, 5, 2), (4, 1, 6, 3, 3)]
MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]


def _op_inputs(mode, shape, bidirectional, proj, seed):
    T, N, I, H, L = shape
    dirs = 2 if bidirectional else 1
    hout = proj or H
    n = tnn.rnn_param_size(L, I, H, bidirectional, mode, proj)
    ins = [_u(seed, (T, N, I)), _u(seed + 1, (n,)),
           _u(seed + 2, (L * dirs, N, hout))]
    if mode == "lstm":
        ins.append(_u(seed + 3, (L * dirs, N, H)))
    return ins


def _run_op(mx, ins, attrs):
    arrs = [_arr(mx, a) for a in ins]
    for a in arrs:
        a.attach_grad()
    with mx.autograd.record():
        outs = mx.nd.RNN(*arrs, state_outputs=True, **attrs)
        loss = None
        for i, o in enumerate(outs):
            w = _arr(mx, np.linspace(-1, 1, o.size, dtype=np.float32)
                     .reshape(o.shape) * (i + 1))
            term = (o * w).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in arrs]


def _op_attrs(mode, shape, bidirectional, proj):
    attrs = dict(state_size=shape[3], num_layers=shape[4],
                 bidirectional=bidirectional, mode=mode)
    if proj:
        attrs["projection_size"] = proj
    return attrs


def _op_errors(mode, shape_i, bidirectional, proj):
    shape = SHAPES[shape_i]
    ins = _op_inputs(mode, shape, bidirectional, proj, 10 * shape_i + 1)
    attrs = _op_attrs(mode, shape, bidirectional, proj)
    want = _run_op(jmx, ins, attrs)
    got = _run_op(tmx, ins, attrs)
    assert [o.shape for o in got[0]] == [o.shape for o in want[0]]
    return [_rel(g, w) for g, w in zip(got[0] + got[1], want[0] + want[1])]


OP_CASES = [(m, i, b, None) for m in MODES for i in range(3)
            for b in (False, True)] + \
    [("lstm", i, b, 2) for i in range(3) for b in (False, True)]


@pytest.mark.parametrize("mode,shape_i,bidirectional,proj", OP_CASES, ids=[
    "%s%s-%d-%s" % (m, "p" if p else "", i, "bi" if b else "uni")
    for m, i, b, p in OP_CASES])
def test_rnn_op_matches_jax(mode, shape_i, bidirectional, proj):
    errs = _op_errors(mode, shape_i, bidirectional, proj)
    assert max(errs) <= TOL, errs


def test_planted_gate_swap_fails(monkeypatch):
    """Swapping the LSTM's i and f gate rows in the port's unpacking
    must move the comparison far past TOL."""
    real = tnn._unpack_rnn_params

    def swapped(params, num_layers, input_size, state_size, *args, **kw):
        layers = real(params, num_layers, input_size, state_size, *args,
                      **kw)
        H = state_size

        def sw(t):
            return torch.cat([t[H:2 * H], t[:H], t[2 * H:]], 0)
        return [[(sw(W), sw(R), sw(bW), sw(bR), P)
                 for W, R, bW, bR, P in per_dir] for per_dir in layers]

    assert max(_op_errors("lstm", 1, True, None)) <= TOL
    monkeypatch.setattr(tnn, "_unpack_rnn_params", swapped)
    assert max(_op_errors("lstm", 1, True, None)) > 100 * TOL


def test_rnn_op_shapes_and_symbol():
    """``sym.RNN`` without its weights creates ``<name>_params`` and
    ``<name>_state`` as in the JAX package; the port infers their shapes
    (the JAX package cannot: the reference's FInferShape), the flat
    vector ``rnn_param_size`` long; ``state_outputs`` gives 2 outputs (3
    for an LSTM)."""
    for mx in (jmx, tmx):
        s = mx.sym.RNN(mx.sym.var("data"), state_size=6, num_layers=2,
                       bidirectional=True, mode="gru", name="r")
        assert s.list_arguments() == ["data", "r_params", "r_state"]
    args, outs, _ = s.infer_shape(data=(5, 3, 4))
    assert args == [(5, 3, 4), (tnn.rnn_param_size(2, 4, 6, True, "gru"),),
                    (4, 3, 6)]
    assert outs == [(5, 3, 12)]
    assert tnn.rnn_param_size(2, 4, 6, True, "gru") == \
        jmx.ops.nn.rnn_param_size(2, 4, 6, True, "gru")
    assert tnn.rnn_param_size(3, 5, 6, True, "lstm", 2) == \
        jmx.ops.nn.rnn_param_size(3, 5, 6, True, "lstm", 2)
    assert len(tmx.sym.RNN(tmx.sym.var("d"), state_size=2, mode="lstm",
                           state_outputs=True).list_outputs()) == 3
    with pytest.raises(tmx.MXNetError, match="projection_size"):
        tmx.nd.RNN(*[_arr(tmx, a) for a in _op_inputs(
            "gru", SHAPES[0], False, None, 0)], state_size=6, mode="gru",
            projection_size=2)


def _dropout_case(p=0.3, train=True, seed=5):
    shape = (6, 4, 3, 5, 2)
    ins = [torch.from_numpy(a) for a in
           _op_inputs("lstm", shape, True, None, seed)]
    attrs = _op_attrs("lstm", shape, True, None)
    return shape, ins, attrs


def test_interlayer_dropout_by_definition():
    """Layer 1 sees layer 0's output times a mask of ``1 / (1 - p)`` and
    zeros drawn from the generator (``rand < 1 - p``), in training only."""
    p = 0.3
    shape, (x, w, h, c), attrs = _dropout_case(p)
    T, N, I, H, L = shape
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    out = tnn._rnn(gen, x, w, h, c, p=p, train_mode=True, **attrs)
    n0 = tnn.rnn_param_size(1, I, H, True, "lstm")
    one = dict(attrs, num_layers=1)
    y0 = tnn._rnn(None, x, w[:n0], h[:2], c[:2], **one)
    gen.set_state(state)
    draw = torch.rand(y0.shape, generator=gen)
    mask = (draw < 1 - p).float() / (1 - p)
    want = tnn._rnn(None, y0 * mask, w[n0:], h[2:], c[2:], **one)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert 0 < (mask == 0).float().mean() < 1
    predict = tnn._rnn(gen, x, w, h, c, p=p, train_mode=False, **attrs)
    np.testing.assert_array_equal(
        predict.numpy(), tnn._rnn(gen, x, w, h, c, **attrs).numpy())


def test_interlayer_dropout_mask_replay():
    """The executor's ``backward`` after a training ``forward`` uses that
    forward's mask: its gradients equal those of a fused ``train_step``
    style recomputation from the saved generator state, and differ from
    a fresh draw's."""
    p = 0.5
    shape, ins, attrs = _dropout_case(p)
    data = tmx.sym.var("data")
    s = tmx.sym.RNN(data, tmx.sym.var("w"), tmx.sym.var("h"),
                    tmx.sym.var("c"), p=p, name="r", **attrs)
    exe = s.bind(tmx.cpu(), args={n: tmx.nd.array(a.numpy(), ctx=tmx.cpu())
                                  for n, a in zip(["data", "w", "h", "c"],
                                                  ins)},
                 grad_req={"data": "null", "w": "write", "h": "null",
                           "c": "null"})
    grads = []
    for _ in range(2):
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(tmx.nd.ones(out.shape, ctx=tmx.cpu()))
        g1 = exe.grad_dict["w"].asnumpy().copy()
        exe._graph = None           # force the recomputation path
        exe.backward(tmx.nd.ones(out.shape, ctx=tmx.cpu()))
        np.testing.assert_allclose(exe.grad_dict["w"].asnumpy(), g1,
                                   rtol=0, atol=1e-6)
        grads.append(g1)
    assert np.abs(grads[0] - grads[1]).max() > 1e-3


# ---------------------------------------------------------------------------
# gluon.rnn layers
# ---------------------------------------------------------------------------

LAYERS = {
    "RNN-relu": lambda mx: mx.gluon.rnn.RNN(5, 2, activation="relu",
                                           prefix="l_"),
    "RNN-tanh-bi": lambda mx: mx.gluon.rnn.RNN(4, 1, activation="tanh",
                                              bidirectional=True, prefix="l_"),
    "LSTM": lambda mx: mx.gluon.rnn.LSTM(6, 2, prefix="l_"),
    "LSTM-bi": lambda mx: mx.gluon.rnn.LSTM(3, 2, bidirectional=True,
                                           prefix="l_"),
    "LSTMP": lambda mx: mx.gluon.rnn.LSTM(6, 2, projection_size=3,
                                         prefix="l_"),
    "GRU-ntc": lambda mx: mx.gluon.rnn.GRU(5, 1, layout="NTC", prefix="l_"),
    "GRU-bi": lambda mx: mx.gluon.rnn.GRU(4, 2, bidirectional=True,
                                         prefix="l_"),
}
LAYER_SHAPES = [(5, 3, 4), (3, 2, 6), (7, 1, 2)]


def _run_gluon(mx, net, x, states, extra_grads=True):
    xa = _arr(mx, x)
    xa.attach_grad()
    sts = None
    if states is not None:
        sts = [_arr(mx, s) for s in states]
        for s in sts:
            s.attach_grad()
    with mx.autograd.record(train_mode=False):
        res = net(xa) if sts is None else net(xa, sts)
        outs = [res] if sts is None else [res[0]] + list(res[1])
        loss = None
        for i, o in enumerate(outs):
            w = _arr(mx, np.linspace(-1, 1, o.size, dtype=np.float32)
                     .reshape(o.shape) * (i + 1))
            term = (o * w).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    ins = [xa.grad.asnumpy()] + ([s.grad.asnumpy() for s in sts]
                                 if sts else [])
    return [o.asnumpy() for o in outs], ins, grads


# the JAX package's side of a case, shared by its eager and hybridized
# port runs: key -> (inputs, states, parameter values, results)
_JAX = {}


def _values(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _hold(got, want):
    assert [o.shape for o in got[0]] == [o.shape for o in want[0]]
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert _rel(g, w) <= TOL
    assert sorted(got[2]) == sorted(want[2])
    scale = max([np.abs(v).max() for v in want[2].values()] + [1e-30])
    for k in want[2]:
        assert np.abs(got[2][k] - want[2][k]).max() <= TOL * scale, k


LAYER_CASES = [(n, i, h, s) for n in sorted(LAYERS) for i in range(3)
               for h in (False, True) for s in (False, True)]


@pytest.mark.parametrize("name,shape_i,hybrid,with_states", LAYER_CASES,
                         ids=["%s-%d-%s-%s" % (n, i, "hybrid" if h else
                                               "eager",
                                               "states" if s else "nostate")
                              for n, i, h, s in LAYER_CASES])
def test_layer_matches_jax(name, shape_i, hybrid, with_states):
    T, N, C = LAYER_SHAPES[shape_i]
    key = ("layer", name, shape_i, with_states)
    if key not in _JAX:
        jnet = LAYERS[name](jmx)
        x = _u(shape_i, (T, N, C) if jnet._layout == "TNC" else (N, T, C))
        jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
        jnet(_arr(jmx, x))
        states = None
        if with_states:
            states = [_u(40 + i, info["shape"])
                      for i, info in enumerate(jnet.state_info(N))]
        _JAX[key] = (x, states, _values(jnet),
                     _run_gluon(jmx, jnet, x, states))
    x, states, values, want = _JAX[key]
    tnet = LAYERS[name](tmx)
    assert list(tnet.collect_params()) == list(values)
    gluon_params_from_jax(values, tnet, ctx=tmx.cpu())
    if hybrid:
        tnet.hybridize()
    got = _run_gluon(tmx, tnet, x, states)
    _hold(got, want)
    if hybrid:
        assert tnet._cached_op.traces == 1


def test_layer_deferred_init_and_begin_state():
    """``input_size=0`` completes from the first batch; ``begin_state``
    gives zeros of the JAX package's shapes on the given device."""
    for mx in (jmx, tmx):
        net = mx.gluon.rnn.LSTM(4, 2, bidirectional=True, projection_size=2)
        net.initialize(ctx=mx.cpu())
        out = net(_arr(mx, _u(0, (3, 2, 5))))
        assert out.shape == (3, 2, 4)
        assert net.l0_i2h_weight.shape == (16, 5)
        assert net.l1_i2h_weight.shape == (16, 4)
        assert [s.shape for s in net.begin_state(2, ctx=mx.cpu())] == \
            [(4, 2, 2), (4, 2, 4)]


# ---------------------------------------------------------------------------
# gluon.rnn and gluon.contrib.rnn cells, unrolled
# ---------------------------------------------------------------------------

def _grnn(mx):
    return mx.gluon.rnn


def _crnn(mx):
    return mx.gluon.contrib.rnn


def _seq(mx):
    cell = _grnn(mx).SequentialRNNCell(prefix="s_")
    with cell.name_scope():
        cell.add(_grnn(mx).LSTMCell(5, prefix="a_"))
        cell.add(_grnn(mx).DropoutCell(0.5, prefix="d_"))
        cell.add(_grnn(mx).GRUCell(4, prefix="b_"))
    return cell


def _bi(mx):
    return _grnn(mx).BidirectionalCell(_grnn(mx).LSTMCell(3, prefix="l_"),
                                       _grnn(mx).GRUCell(4, prefix="r_"))


# name -> (build(mx), step input shape (N, *C), layout)
CELLS = {
    "RNNCell": (lambda mx: _grnn(mx).RNNCell(5, prefix="c_"), (3, 4), "NTC"),
    "RNNCell-relu": (lambda mx: _grnn(mx).RNNCell(5, activation="relu",
                                                  prefix="c_"), (2, 3), "TNC"),
    "LSTMCell": (lambda mx: _grnn(mx).LSTMCell(6, prefix="c_"), (3, 4),
                 "NTC"),
    "GRUCell": (lambda mx: _grnn(mx).GRUCell(4, prefix="c_"), (2, 5), "TNC"),
    "SequentialRNNCell": (_seq, (3, 4), "NTC"),
    "ResidualCell": (lambda mx: _grnn(mx).ResidualCell(
        _grnn(mx).GRUCell(4, prefix="c_")), (2, 4), "NTC"),
    "ZoneoutCell": (lambda mx: _grnn(mx).ZoneoutCell(
        _grnn(mx).LSTMCell(4, prefix="c_"), 0.3, 0.2), (2, 3), "NTC"),
    "BidirectionalCell": (_bi, (3, 4), "NTC"),
    "LSTMPCell": (lambda mx: _crnn(mx).LSTMPCell(6, 3, prefix="c_"), (2, 4),
                  "TNC"),
    "VariationalDropoutCell": (lambda mx: _crnn(mx).VariationalDropoutCell(
        _grnn(mx).GRUCell(4, prefix="c_"), 0.3, 0.2, 0.1), (3, 4), "NTC"),
    "Conv1DRNNCell": (lambda mx: _crnn(mx).Conv1DRNNCell(
        (2, 6), 3, 3, 3, i2h_pad=1, prefix="c_"), (2, 2, 6), "NTC"),
    "Conv2DLSTMCell": (lambda mx: _crnn(mx).Conv2DLSTMCell(
        (2, 4, 5), 3, (3, 3), (3, 1), prefix="c_"), (2, 2, 4, 5), "NTC"),
    "Conv2DGRUCell": (lambda mx: _crnn(mx).Conv2DGRUCell(
        (1, 3, 3), 2, 3, 3, i2h_pad=1, prefix="c_"), (1, 1, 3, 3), "TNC"),
    "Conv3DLSTMCell": (lambda mx: _crnn(mx).Conv3DLSTMCell(
        (1, 3, 3, 4), 2, 1, 3, prefix="c_"), (2, 1, 3, 3, 4), "NTC"),
}


def _unroll_net(mx, name, T, with_states):
    build, _, layout = CELLS[name]

    class Net(mx.gluon.HybridBlock):
        def __init__(self):
            super(Net, self).__init__(prefix="n_")
            with self.name_scope():
                self.cell = build(mx)

        def hybrid_forward(self, F, x, *states):
            out, st = self.cell.unroll(
                T, x, begin_state=list(states) if states else None,
                layout=layout, merge_outputs=True)
            return [out] + list(st)

    return Net()


def _run_unrolled(mx, net, x, states):
    xa = _arr(mx, x)
    xa.attach_grad()
    sts = [_arr(mx, s) for s in states or ()]
    for s in sts:
        s.attach_grad()
    with mx.autograd.record(train_mode=False):
        outs = net(xa, *sts)
        loss = None
        for i, o in enumerate(outs):
            w = _arr(mx, np.linspace(-1, 1, o.size, dtype=np.float32)
                     .reshape(o.shape) * (i + 1))
            term = (o * w).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    return [o.asnumpy() for o in outs], \
        [xa.grad.asnumpy()] + [s.grad.asnumpy() for s in sts], grads


CELL_CASES = [(n, h, s) for n in sorted(CELLS) for h in (False, True)
              for s in (False, True)]


@pytest.mark.parametrize("name,hybrid,with_states", CELL_CASES, ids=[
    "%s-%s-%s" % (n, "hybrid" if h else "eager", "states" if s else "zeros")
    for n, h, s in CELL_CASES])
def test_cell_matches_jax(name, hybrid, with_states):
    T = 4
    _, step, layout = CELLS[name]
    key = ("cell", name, with_states)
    if key not in _JAX:
        shape = (step[0], T) + step[1:] if layout == "NTC" \
            else (T,) + step
        x = _u(7, shape)
        jnet = _unroll_net(jmx, name, T, with_states)
        jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
        states = None
        if with_states:
            states = [_u(50 + i, info["shape"]) for i, info in
                      enumerate(jnet.cell.state_info(step[0]))]
        with jmx.autograd.predict_mode():
            jnet(_arr(jmx, x), *[_arr(jmx, s) for s in states or ()])
        _JAX[key] = (x, states, _values(jnet),
                     _run_unrolled(jmx, jnet, x, states))
    x, states, values, want = _JAX[key]
    tnet = _unroll_net(tmx, name, T, with_states)
    assert list(tnet.collect_params()) == list(values)
    gluon_params_from_jax(values, tnet, ctx=tmx.cpu())
    if hybrid:
        tnet.hybridize()
    got = _run_unrolled(tmx, tnet, x, states)
    _hold(got, want)


def test_cell_state_info_and_begin_state_match_jax():
    for name, (build, step, _) in sorted(CELLS.items()):
        infos = [[(tuple(i["shape"]), i.get("__layout__"))
                  for i in build(mx).state_info(step[0])]
                 for mx in (jmx, tmx)]
        assert infos[0] == infos[1], name
    cell = tmx.gluon.rnn.LSTMCell(3)
    assert [s.shape for s in cell.begin_state(2, ctx=tmx.cpu())] == \
        [(2, 3), (2, 3)]


def test_dropout_cells_in_training_by_definition():
    """In training DropoutCell keeps each value as ``x / (1 - p)`` or
    zero; VariationalDropoutCell draws one input mask for the whole
    unroll (the same positions zero at every step); ZoneoutCell's outputs
    are the base cell's or the previous output."""
    rnn, crnn = tmx.gluon.rnn, tmx.gluon.contrib.rnn
    x = np.ones((64, 5, 32), np.float32)
    drop = rnn.DropoutCell(0.25)
    with tmx.autograd.record():
        outs, _ = drop.unroll(5, _arr(tmx, x), merge_outputs=True)
    y = outs.asnumpy()
    assert set(np.unique(y)) <= {0.0, np.float32(1 / 0.75)}
    assert 0.15 < (y == 0).mean() < 0.35
    seen = []
    base = rnn.RNNCell(8, prefix="v_")
    var = crnn.VariationalDropoutCell(base, drop_inputs=0.5)
    var.initialize(ctx=tmx.cpu())
    base.register_forward_pre_hook(lambda blk, args: seen.append(
        args[0].asnumpy() == 0))
    with tmx.autograd.record():
        var.unroll(5, _arr(tmx, x), merge_outputs=True)
    assert len(seen) == 5 and seen[0].any()
    for s in seen[1:]:
        np.testing.assert_array_equal(s, seen[0])
    zone = rnn.ZoneoutCell(rnn.GRUCell(6, prefix="z_"), zoneout_outputs=0.5)
    zone.initialize(ctx=tmx.cpu())
    ref = zone.base_cell
    xs = _arr(tmx, np.random.RandomState(2).uniform(-1, 1, (4, 3, 5))
              .astype(np.float32))
    with tmx.autograd.record():
        zo, _ = zone.unroll(3, xs, merge_outputs=False)
    base_states = [tmx.nd.zeros((4, 6), ctx=tmx.cpu())]
    prev = np.zeros((4, 6), np.float32)
    for t in range(3):
        out, base_states = ref(xs[:, t, :], base_states)
        z = zo[t].asnumpy()
        assert np.all((z == out.asnumpy()) | (z == prev))
        prev = z


# ---------------------------------------------------------------------------
# the legacy mx.rnn cells
# ---------------------------------------------------------------------------

def _legacy(mx, name):
    r = mx.rnn
    if name == "RNNCell":
        return r.RNNCell(5, prefix="c_")
    if name == "LSTMCell":
        return r.LSTMCell(6, prefix="c_", forget_bias=0.5)
    if name == "GRUCell":
        return r.GRUCell(4, prefix="c_")
    if name == "SequentialRNNCell":
        cell = r.SequentialRNNCell()
        cell.add(r.LSTMCell(4, prefix="a_"))
        cell.add(r.DropoutCell(0.0, prefix="d_"))
        cell.add(r.GRUCell(3, prefix="b_"))
        return cell
    if name == "BidirectionalCell":
        return r.BidirectionalCell(r.LSTMCell(3, prefix="l_"),
                                   r.GRUCell(2, prefix="r_"))
    if name == "FusedRNNCell-lstm":
        return r.FusedRNNCell(4, num_layers=2, mode="lstm",
                              bidirectional=True, prefix="f_")
    if name == "FusedRNNCell-gru":
        return r.FusedRNNCell(5, num_layers=3, mode="gru", prefix="f_")
    return r.FusedRNNCell(3, num_layers=2, mode="rnn_relu", prefix="f_")


LEGACY = ["RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
          "BidirectionalCell", "FusedRNNCell-lstm", "FusedRNNCell-gru",
          "FusedRNNCell-relu"]


def _legacy_run(mx, name, layout, N, T, C):
    cell = _legacy(mx, name)
    data = mx.sym.var("data")
    outputs, states = cell.unroll(T, data, layout=layout, merge_outputs=True,
                                  batch_size=N)
    net = mx.sym.Group([outputs] + list(states))
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    exe = net.simple_bind(mx.cpu(), data=shape)
    for i, name_ in enumerate(net.list_arguments()):
        a = exe.arg_dict[name_]
        a[:] = _arr(mx, _u(100 + i, a.shape))
    outs = exe.forward(is_train=True)
    exe.backward([_arr(mx, np.linspace(-1, 1, o.size, dtype=np.float32)
                       .reshape(o.shape) * (i + 1))
                  for i, o in enumerate(outs)])
    grads = {k: v.asnumpy() for k, v in exe.grad_dict.items()
             if v is not None}
    return net.list_arguments(), [o.asnumpy() for o in outs], grads


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("name", LEGACY)
def test_legacy_cell_unroll_matches_jax(name, layout):
    jargs, jouts, jgrads = _legacy_run(jmx, name, layout, 3, 5, 4)
    targs, touts, tgrads = _legacy_run(tmx, name, layout, 3, 5, 4)
    assert targs == jargs
    assert len(touts) == len(jouts)
    for g, w in zip(touts, jouts):
        assert g.shape == w.shape and _rel(g, w) <= TOL
    assert sorted(tgrads) == sorted(jgrads)
    for k in jgrads:
        assert _rel(tgrads[k], jgrads[k]) <= TOL, k


def test_legacy_state_info_and_params_match_jax():
    for name in LEGACY:
        cells = [_legacy(mx, name) for mx in (jmx, tmx)]
        assert cells[0].state_info == cells[1].state_info, name
    for mx in (jmx, tmx):
        with pytest.raises(mx.MXNetError):
            mx.rnn.BidirectionalCell(mx.rnn.RNNCell(2), mx.rnn.RNNCell(2))(
                mx.sym.var("x"), [])
