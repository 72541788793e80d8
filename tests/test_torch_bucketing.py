"""The port's bucketing stack against the JAX package's:
``rnn.BucketSentenceIter``, ``mod.BucketingModule`` (with
``Module.borrow_optimizer``), the ``rnn`` checkpoint helpers, and the
metrics the port gained with them.

Held:

* the iterator's batches, labels, bucket keys and descriptors bitwise,
  over two epochs from the same ``random`` / ``np.random`` seeds;
* a two-layer LSTM language model (legacy ``rnn.LSTMCell``s unrolled per
  bucket, ``SoftmaxOutput`` ignoring -1) trained step by step over
  batches that alternate between buckets, from the same weights: every
  parameter after every step within ``PARAM_TOL`` = 1e-4 of the largest
  magnitude of its JAX value (SGD, lr 0.5, momentum 0.9, six steps), and
  the outputs of each step within the same bound;
* one set of weights, auxiliary arrays and optimizer state across the
  buckets (the bucket executors alias the default bucket's NDArrays);
* ``save_rnn_checkpoint`` / ``load_rnn_checkpoint`` files read by the
  other package with the same arrays;
* every metric the port gained against the JAX package's on the same
  seeded labels and predictions (the same numpy code: equal values).
"""
import random
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.rnn  # noqa: E402,F401

import mxnet_tpu_torch as tmx  # noqa: E402

PARAM_TOL = 1e-4
VOCAB, EMBED, HIDDEN, BATCH = 12, 6, 8, 4
BUCKETS = [4, 7, 10]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _sentences(n=60, seed=0):
    rng = np.random.RandomState(seed)
    out = [list(rng.randint(1, VOCAB, rng.randint(2, 12)))
           for _ in range(n)]
    out.append([])                        # skipped
    out.append(list(range(1, 13)))        # longer than every bucket
    return out


def _iter(mx, seed, **kw):
    random.seed(seed)
    np.random.seed(seed)
    return mx.rnn.BucketSentenceIter(_sentences(), BATCH, buckets=BUCKETS,
                                     invalid_label=-1, **kw)


def _batches(mx, seed, epochs=2):
    """Every batch of ``epochs`` epochs, copied: the JAX package's
    ``asnumpy`` of a host array may share the iterator's buffer, which the
    next ``reset`` shuffles in place."""
    it = _iter(mx, seed)
    out = []
    for _ in range(epochs):
        for b in it:
            out.append((b.bucket_key, b.data[0].asnumpy().copy(),
                        b.label[0].asnumpy().copy(),
                        [(d.name, tuple(d.shape)) for d in b.provide_data],
                        [(d.name, tuple(d.shape)) for d in b.provide_label]))
        it.reset()
    return it, out


def test_bucket_sentence_iter_matches_jax():
    jit, jb = _batches(jmx, 3)
    tit, tb = _batches(tmx, 3)
    assert tit.default_bucket_key == jit.default_bucket_key == max(BUCKETS)
    assert [(d.name, tuple(d.shape)) for d in tit.provide_data] == \
        [(d.name, tuple(d.shape)) for d in jit.provide_data]
    assert len(tb) == len(jb) > 6
    assert len({b[0] for b in tb}) == len(BUCKETS)
    for t, j in zip(tb, jb):
        assert t[0] == j[0] and t[3] == j[3] and t[4] == j[4]
        np.testing.assert_array_equal(t[1], j[1])
        np.testing.assert_array_equal(t[2], j[2])
    # labels are the data shifted one step, padded with -1
    key, data, label = tb[0][:3]
    np.testing.assert_array_equal(label[:, :-1], data[:, 1:])
    assert (label[:, -1] == -1).all() and data.shape == (BATCH, key)


def _sym_gen(mx):
    stack = mx.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(mx.rnn.LSTMCell(num_hidden=HIDDEN, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                                 name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, embed, merge_outputs=True,
                                  batch_size=BATCH)
        pred = mx.sym.Reshape(outputs, shape=(-1, HIDDEN))
        pred = mx.sym.FullyConnected(pred, num_hidden=VOCAB, name="pred")
        label_f = mx.sym.Reshape(label, shape=(-1,))
        net = mx.sym.SoftmaxOutput(pred, label_f, name="softmax",
                                   use_ignore=True, ignore_label=-1)
        return net, ("data",), ("softmax_label",)
    return sym_gen


def _weights(names_shapes):
    out = {}
    for name, shape in names_shapes:
        rng = np.random.RandomState(zlib.crc32(name.encode()))
        out[name] = rng.uniform(-0.3, 0.3, shape).astype(np.float32)
    return out


def _alternating(mx, seed):
    """Six batches whose buckets alternate: the first of each bucket
    twice over, in the order 10, 4, 7, 10, 4, 7."""
    it = _iter(mx, seed)
    first = {}
    for b in it:
        first.setdefault(b.bucket_key, b)
    return [first[k] for k in (10, 4, 7, 10, 4, 7)]


def _train(mx, seed):
    mod = mx.mod.BucketingModule(_sym_gen(mx), default_bucket_key=10,
                                 context=mx.cpu())
    it = _iter(mx, seed)
    mod.bind(it.provide_data, it.provide_label)
    net = mod._buckets[10]
    shapes = [(n, net._exec.arg_dict[n].shape) for n in net._param_names]
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu()) for k, v in
                                _weights(shapes).items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.5, "momentum": 0.9})
    steps = []
    for batch in _alternating(mx, seed):
        mod.forward_backward(batch)
        mod.update()
        out = mod.get_outputs()[0].asnumpy()
        arg, _ = mod.get_params()
        steps.append((out, {k: v.asnumpy() for k, v in arg.items()}))
    return mod, steps


@pytest.fixture(scope="module")
def trained():
    return _train(jmx, 5), _train(tmx, 5)


def test_bucketing_module_alternating_buckets_matches_jax(trained):
    (_, jsteps), (_, tsteps) = trained
    assert len(tsteps) == len(jsteps) == 6
    for i, ((jo, jp), (to, tp)) in enumerate(zip(jsteps, tsteps)):
        assert to.shape == jo.shape
        assert _rel(to, jo) <= PARAM_TOL, i
        assert sorted(tp) == sorted(jp)
        worst = max(_rel(tp[k], jp[k]) for k in jp)
        assert worst <= PARAM_TOL, (i, worst)
    # the weights moved: the steps trained
    assert _rel(tsteps[-1][1]["pred_weight"], tsteps[0][1]["pred_weight"]) \
        > 1e-3


def test_buckets_share_weights_and_optimizer(trained):
    _, (mod, _) = trained
    assert sorted(mod._buckets) == [4, 7, 10]
    default = mod._buckets[10]
    for key in (4, 7):
        other = mod._buckets[key]
        assert other._exec is not default._exec
        for n in default._param_names:
            assert other._exec.arg_dict[n] is default._exec.arg_dict[n]
        assert other._updater is default._updater
        assert other._optimizer is default._optimizer
        assert other.optimizer_initialized
    assert mod.symbol is mod._curr_module.symbol
    with pytest.raises(NotImplementedError, match="shared_module"):
        tmx.mod.Module(_sym_gen(tmx)(4)[0], context=tmx.cpu()).bind(
            [("data", (BATCH, 4))], [("softmax_label", (BATCH, 4))],
            shared_module=default)


def test_borrow_optimizer():
    sym = _sym_gen(tmx)(4)[0]
    a = tmx.mod.Module(sym, context=tmx.cpu())
    b = tmx.mod.Module(sym, context=tmx.cpu())
    for m in (a, b):
        m.bind([("data", (BATCH, 4))], [("softmax_label", (BATCH, 4))])
        m.init_params()
    a.init_optimizer(optimizer="sgd")
    b.borrow_optimizer(a)
    assert b.optimizer_initialized and b._updater is a._updater \
        and b._optimizer is a._optimizer


def test_rnn_checkpoints_load_across_packages(trained, tmp_path):
    (jmod, _), (tmod, _) = trained
    for side, (mx, mod) in {"jax": (jmx, jmod), "port": (tmx, tmod)}.items():
        arg, aux = mod.get_params()
        prefix = str(tmp_path / side)
        mx.rnn.save_rnn_checkpoint([], prefix, 3, mod.symbol, arg, aux)
        for reader in (jmx, tmx):
            sym, rarg, raux = reader.rnn.load_rnn_checkpoint([], prefix, 3)
            assert sym.list_arguments() == mod.symbol.list_arguments()
            assert sorted(rarg) == sorted(arg)
            for k in arg:
                np.testing.assert_array_equal(rarg[k].asnumpy(),
                                              arg[k].asnumpy())
    cb = tmx.rnn.do_rnn_checkpoint([], str(tmp_path / "cb"), period=2)
    arg, aux = tmod.get_params()
    cb(0, tmod.symbol, arg, aux)
    cb(1, tmod.symbol, arg, aux)
    assert (tmp_path / "cb-0002.params").exists()
    assert not (tmp_path / "cb-0001.params").exists()


def _metric_inputs(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "binary":
        labels = [rng.randint(0, 2, 12).astype(np.float32) for _ in range(2)]
        preds = [rng.dirichlet([1, 1], 12).astype(np.float32)
                 for _ in range(2)]
    elif kind == "classes":
        labels = [rng.randint(0, 5, 10).astype(np.float32) for _ in range(2)]
        labels[0][:3] = -1
        labels[0][3] = 4
        preds = [rng.dirichlet(np.ones(5), 10).astype(np.float32)
                 for _ in range(2)]
    else:
        labels = [rng.randn(9).astype(np.float32) for _ in range(2)]
        preds = [labels[i] + rng.randn(9).astype(np.float32) * 0.3
                 for i in range(2)]
    return labels, preds


def _feval(label, pred):
    return float(np.abs(label.ravel() - pred.ravel()).sum()), label.size


# create() name / args -> input kind
METRICS = [
    ("f1", {}, "binary"), ("f1", {"average": "micro"}, "binary"),
    ("mcc", {}, "binary"), ("mcc", {"average": "micro"}, "binary"),
    ("perplexity", {"ignore_label": None}, "classes"),
    ("perplexity", {"ignore_label": -1}, "classes"),
    ("mae", {}, "regression"), ("mse", {}, "regression"),
    ("rmse", {}, "regression"), ("nll_loss", {}, "classes"),
    ("pearsonr", {}, "regression"), ("loss", {}, "regression"),
    ("torch", {}, "regression"), ("caffe", {}, "regression"),
    ("custom", {}, "regression"), ("np", {}, "regression"),
]


def _make(mx, name, kwargs):
    if name == "custom":
        return mx.metric.create(_feval)
    if name == "np":
        return mx.metric.np(_feval, name="absdiff")
    return mx.metric.create(name, **kwargs)


@pytest.mark.parametrize("name,kwargs,kind", METRICS, ids=[
    "%s-%s" % (n, "-".join("%s%s" % kv for kv in sorted(k.items())))
    for n, k, _ in METRICS])
def test_metric_matches_jax(name, kwargs, kind):
    labels, preds = _metric_inputs(kind, 7)
    if name == "nll_loss":
        labels = [np.abs(l) for l in labels]
    vals = []
    for mx in (jmx, tmx):
        m = _make(mx, name, kwargs)
        for _ in range(2):
            m.update([mx.nd.array(l, ctx=mx.cpu()) for l in labels],
                     [mx.nd.array(p, ctx=mx.cpu()) for p in preds])
        vals.append((type(m).__name__, m.get()))
        m.reset()
        assert np.isnan(m.get()[1])
    assert vals[0][0] == vals[1][0]
    assert vals[0][1][0] == vals[1][1][0]
    np.testing.assert_allclose(vals[1][1][1], vals[0][1][1], rtol=1e-6)


def test_metric_config_and_errors():
    m = tmx.metric.create("perplexity", ignore_label=-1)
    assert m.get_config()["ignore_label"] == -1
    assert tmx.metric.create(["acc", "mae"]).get()[0] == ["accuracy", "mae"]
    with pytest.raises(tmx.MXNetError, match="unknown metric"):
        tmx.metric.create("no_such_metric")
    with pytest.raises(ValueError, match="binary"):
        tmx.metric.F1().update([tmx.nd.array([0, 1, 2], ctx=tmx.cpu())],
                               [tmx.nd.array(np.eye(3, dtype=np.float32),
                                             ctx=tmx.cpu())])
