"""The port's remaining ``gluon.nn`` layers and ``gluon.contrib`` against
the JAX package's.

Each layer is made by both packages under one explicit prefix (so its
parameter names are equal, and held so), the JAX package initializes it
and ``convert.gluon_params_from_jax`` carries the values across. On
numpy-seeded inputs at three shapes a layer, under
``autograd.record()`` with a loss of the outputs weighted by a fixed
pattern, held: the outputs and the input's gradient within ``TOL`` =
1e-5 of each tensor's largest magnitude, every parameter's gradient
within ``TOL`` of the largest among them (float32 sums in another
order). The port runs each layer eagerly and hybridized (its traced
Symbol through the CachedOp); both are held against the JAX package's
eager layer. Inputs are uniform in (-1, 1), off the kinks where the
packages' gradient conventions differ (ROADMAP C caveats).

Dropout draws from the port's generator, not ``jax.random``: predict
mode is held against the JAX package (the identity), and training mode
by definition (kept values are ``x / (1 - p)``, the backward's mask is
the forward's, the kept share within 5 sigma). PReLU's ``alpha`` starts
at 0.25 in the port, as in reference MXNet; the JAX package's
``Constant`` initializer goes by the parameter name's suffix and raises
for ``alpha``, so its JAX twin takes its value from a test initializer.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.gluon.contrib  # noqa: E402,F401

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.convert import gluon_params_from_jax  # noqa: E402

TOL = 1e-5
RNG = np.random.RandomState(0)


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


class _JaxAlpha(jmx.init.Initializer):
    """0.25 for the JAX package's PReLU alpha (see the module doc)."""

    def __call__(self, desc, arr):
        arr[:] = 0.25


def _nn(mx):
    return mx.gluon.nn


def _contrib(mx):
    return mx.gluon.contrib.nn


# name -> (build(mx), three input shapes, input kind). Built under the
# prefix "l_"; "index" inputs are integer rows of an Embedding.
LAYERS = {
    "Embedding": (lambda mx: _nn(mx).Embedding(10, 5, prefix="l_"),
                  [(4,), (2, 3), (2, 2, 2)], "index"),
    "EmbeddingSparseGrad": (
        lambda mx: _nn(mx).Embedding(7, 3, sparse_grad=True, prefix="l_"),
        [(5,), (3, 2), (1, 4)], "index"),
    "InstanceNorm": (lambda mx: _nn(mx).InstanceNorm(scale=True, prefix="l_"),
                     [(2, 3, 5), (2, 4, 3, 3), (1, 2, 2, 3, 4)], "float"),
    "LayerNorm": (lambda mx: _nn(mx).LayerNorm(prefix="l_"),
                  [(4, 6), (2, 3, 5), (2, 2, 3, 4)], "float"),
    "LayerNormAxis1": (lambda mx: _nn(mx).LayerNorm(axis=1, epsilon=1e-3,
                                                    prefix="l_"),
                       [(4, 6), (2, 3, 5), (2, 5, 2, 2)], "float"),
    "LeakyReLU": (lambda mx: _nn(mx).LeakyReLU(0.1, prefix="l_"),
                  [(4, 6), (2, 3, 5), (2, 2, 3, 4)], "float"),
    "PReLU": (lambda mx: _nn(mx).PReLU(
        alpha_initializer=_JaxAlpha() if mx is jmx else None, prefix="l_"),
        [(4, 6), (2, 3, 5), (2, 2, 3, 4)], "float"),
    "ELU": (lambda mx: _nn(mx).ELU(alpha=0.7, prefix="l_"),
            [(4, 6), (2, 3, 5), (2, 2, 3, 4)], "float"),
    "SELU": (lambda mx: _nn(mx).SELU(prefix="l_"),
             [(4, 6), (2, 3, 5), (2, 2, 3, 4)], "float"),
    "GELU": (lambda mx: _nn(mx).GELU(prefix="l_"),
             [(4, 6), (2, 3, 5), (2, 2, 3, 4)], "float"),
    "Conv1DTranspose": (lambda mx: _nn(mx).Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, prefix="l_"),
        [(2, 3, 7), (1, 2, 4), (3, 1, 5)], "float"),
    "Conv2DTranspose": (lambda mx: _nn(mx).Conv2DTranspose(
        6, (3, 2), strides=(2, 1), padding=(1, 0), output_padding=(1, 0),
        groups=3, activation="tanh", prefix="l_"),
        [(2, 3, 5, 4), (1, 6, 3, 3), (2, 9, 2, 5)], "float"),
    "Conv3DTranspose": (lambda mx: _nn(mx).Conv3DTranspose(
        2, 2, strides=2, use_bias=False, in_channels=2, prefix="l_"),
        [(1, 2, 3, 3, 3), (2, 2, 2, 3, 2), (1, 2, 1, 2, 4)], "float"),
    "ReflectionPad2D": (lambda mx: _nn(mx).ReflectionPad2D(2, prefix="l_"),
                        [(1, 2, 4, 5), (2, 3, 3, 3), (1, 1, 6, 4)], "float"),
    "HybridConcurrent": (lambda mx: _concurrent(mx, True),
                         [(2, 6), (3, 4), (1, 5)], "float"),
    "Concurrent": (lambda mx: _concurrent(mx, False),
                   [(2, 6), (3, 4), (1, 5)], "float"),
}


def _concurrent(mx, hybrid):
    cls = _contrib(mx).HybridConcurrent if hybrid else _contrib(mx).Concurrent
    net = cls(axis=1, prefix="l_")
    with net.name_scope():
        net.add(_nn(mx).Dense(3, activation="relu"), _contrib(mx).Identity(),
                _nn(mx).Dense(2, use_bias=False))
    return net


def _input(shape, kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "index":
        return rng.randint(0, 5, shape).astype(np.float32)
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _run(mx, net, x, kind):
    xa = _arr(mx, x)
    if kind == "float":
        xa.attach_grad()
    with mx.autograd.record():
        out = net(xa)
        w = _arr(mx, np.linspace(-1, 1, out.size, dtype=np.float32)
                 .reshape(out.shape))
        loss = (out * w).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    return out.asnumpy(), (xa.grad.asnumpy() if kind == "float" else None), \
        grads


# Concurrent is a Block: it has no hybridized form
CASES = [(name, i, hybrid) for name in sorted(LAYERS) for i in range(3)
         for hybrid in (False, True) if not (hybrid and name == "Concurrent")]


@pytest.mark.parametrize("name,shape_i,hybrid", CASES, ids=[
    "%s-%d-%s" % (n, i, "hybrid" if h else "eager") for n, i, h in CASES])
def test_layer_matches_jax(name, shape_i, hybrid):
    build, shapes, kind = LAYERS[name]
    x = _input(shapes[shape_i], kind, 10 * shape_i + 1)
    jnet = build(jmx)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    with jmx.autograd.predict_mode():
        jnet(_arr(jmx, x))
    tnet = build(tmx)
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    gluon_params_from_jax(jnet.collect_params(), tnet, ctx=tmx.cpu())
    if hybrid:
        tnet.hybridize()
    want = _run(jmx, jnet, x, kind)
    got = _run(tmx, tnet, x, kind)
    assert got[0].shape == want[0].shape
    assert _rel(got[0], want[0]) <= TOL
    if kind == "float":
        assert _rel(got[1], want[1]) <= TOL
    assert sorted(got[2]) == sorted(want[2])
    scale = max([np.abs(v).max() for v in want[2].values()] + [1e-30])
    for k in want[2]:
        assert np.abs(got[2][k] - want[2][k]).max() <= TOL * scale, k
    if hybrid:
        assert tnet._cached_op is not None and tnet._cached_op.traces == 1


def test_concurrent_is_not_hybridizable_in_either_package():
    for mx in (jmx, tmx):
        assert not isinstance(_concurrent(mx, False), mx.gluon.HybridBlock)


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("shape", [(4, 6), (2, 3, 5), (2, 2, 3, 4)])
def test_dropout(shape, hybrid):
    """Predict mode: the identity in both packages. Training mode: each
    value 0 or ``x / (1 - p)``, the gradient's mask the forward's, the
    kept share within 5 sigma, new draws each call; ``axes`` shares one
    draw along them."""
    p = 0.4
    x = RNG.uniform(0.5, 1.5, shape).astype(np.float32)
    jnet = jmx.gluon.nn.Dropout(p, prefix="l_")
    jout = jnet(_arr(jmx, x)).asnumpy()
    net = tmx.gluon.nn.Dropout(p, prefix="l_")
    if hybrid:
        net.hybridize()
    np.testing.assert_array_equal(net(_arr(tmx, x)).asnumpy(), jout)
    np.testing.assert_array_equal(jout, x)
    big = np.ones((64, 256), np.float32)
    outs = []
    for _ in range(2):
        xa = _arr(tmx, big * 1.0)
        xa.attach_grad()
        with tmx.autograd.record():
            out = net(xa)
        out.backward()
        y, g = out.asnumpy(), xa.grad.asnumpy()
        kept = y != 0
        np.testing.assert_allclose(y[kept], 1 / (1 - p), rtol=1e-6)
        np.testing.assert_array_equal(g, y)
        n = big.size
        assert abs(kept.sum() - n * (1 - p)) <= 5 * np.sqrt(n * p * (1 - p))
        outs.append(kept)
    assert (outs[0] != outs[1]).any()
    shared = tmx.gluon.nn.Dropout(p, axes=(1,), prefix="s_")
    with tmx.autograd.record():
        y = shared(_arr(tmx, big)).asnumpy()
    assert (y == y[:, :1]).all()
    assert repr(net) == repr(jnet)


def test_prelu_starts_at_a_quarter():
    net = tmx.gluon.nn.PReLU()
    net.initialize(ctx=tmx.cpu())
    np.testing.assert_array_equal(net.alpha.data().asnumpy(), [0.25])
    with pytest.raises(ValueError, match="alpha"):
        jmx.gluon.nn.PReLU().initialize()


def test_instance_norm_other_axis():
    """The port sizes gamma by the channel axis it normalizes over (the
    JAX package reads axis 1, and fails for another axis of another
    size): axis 2 equals axis 1 after swapping the two."""
    x = RNG.uniform(-1, 1, (2, 3, 4, 5)).astype(np.float32)
    net = tmx.gluon.nn.InstanceNorm(axis=2, scale=True)
    net.initialize(ctx=tmx.cpu())
    assert net(_arr(tmx, x)).shape == x.shape
    assert net.gamma.shape == (4,)
    ref = tmx.gluon.nn.InstanceNorm(axis=1, scale=True)
    ref.initialize(ctx=tmx.cpu())
    want = ref(_arr(tmx, x.swapaxes(1, 2))).asnumpy().swapaxes(1, 2)
    np.testing.assert_allclose(net(_arr(tmx, x)).asnumpy(), want, atol=1e-6)


@pytest.mark.parametrize("args", [(10, 3), (10, 3, False), (7, 7), (9, 4)])
def test_interval_sampler_matches_jax(args):
    got = tmx.gluon.contrib.data.IntervalSampler(*args)
    want = jmx.gluon.contrib.data.IntervalSampler(*args)
    assert list(got) == list(want) and len(got) == len(want)


def test_contrib_layers_queued_elsewhere_raise():
    with pytest.raises(MXNetError, match="A15"):
        tmx.gluon.contrib.nn.SparseEmbedding(10, 3)
    with pytest.raises(MXNetError, match="A8.3"):
        tmx.gluon.contrib.nn.SyncBatchNorm()


def test_transposed_conv_deferred_weight_shape():
    """Deconvolution's weight is (in_channels, channels // groups, *k):
    the deferred shape takes its first axis from the input."""
    for mx in (jmx, tmx):
        net = mx.gluon.nn.Conv2DTranspose(6, 3, groups=2, prefix="t_")
        assert net.weight.shape == (0, 3, 3, 3)
    net.initialize(ctx=tmx.cpu())
    net(_arr(tmx, np.zeros((1, 4, 5, 5), np.float32)))
    assert net.weight.shape == (4, 3, 3, 3)


def test_layer_norm_gradient_against_a_float64_witness():
    """Normalizing over 9 values, LayerNorm's input gradient is float32's
    own error apart in the two packages (1.07e-5 of its largest value
    when written, each ~9e-6 from float64): the port's error against a
    float64 witness is held to at most 1.25x the JAX package's."""
    rng = np.random.RandomState(0)
    rng.uniform(-1, 1, (4, 6))
    x = rng.uniform(-1, 1, (2, 3, 9, 9)).astype(np.float32)
    grads = []
    for mx in (jmx, tmx):
        net = mx.gluon.nn.LayerNorm(prefix="w_")
        net.initialize(ctx=mx.cpu())
        xa = _arr(mx, x)
        xa.attach_grad()
        with mx.autograd.record():
            out = net(xa)
            w = _arr(mx, np.linspace(-1, 1, out.size, dtype=np.float32)
                     .reshape(out.shape))
            loss = (out * w).sum()
        loss.backward()
        grads.append(xa.grad.asnumpy())
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    var, mean = torch.var_mean(x64, dim=-1, keepdim=True, correction=0)
    out = (x64 - mean) * torch.rsqrt(var + 1e-5)
    w = torch.linspace(-1, 1, out.numel(), dtype=torch.float32).to(
        torch.float64).reshape(out.shape)
    (out * w).sum().backward()
    ref = x64.grad.numpy()
    jerr, terr = _rel(grads[0], ref), _rel(grads[1], ref)
    assert 0 < jerr < 1e-4 and terr <= 1.25 * jerr, (terr, jerr)
