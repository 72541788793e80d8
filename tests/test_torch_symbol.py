"""The port's ResNet op set and symbol layer against the JAX package.

Ops: each op of the ResNet training path (``FullyConnected``,
``Convolution``, ``Pooling``, ``BatchNorm``, ``Activation``,
``SoftmaxOutput``, ``Flatten``, ``elemwise_add``) runs on the same
numpy-seeded inputs through ``mxnet_tpu.ops.registry.get_op(name).fn``
with ``jax.vjp`` and through the port's op with ``torch.autograd.grad``,
under the same cotangent. Forward outputs and every input gradient must
agree within rtol/atol 1e-5: float32 sums in another order (the
convolution's and the matmul's reductions, BatchNorm's batch moments),
a few ULPs of values of order 1.

Symbols: ResNet symbols built by the two packages have the same
argument, auxiliary-state and output names and the same inferred
shapes; the JAX package's ``tojson()`` loads in the port with the same
lists and evaluates to the same outputs.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.models  # noqa: E402,F401
from mxnet_tpu.ops import registry as jreg  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402
from mxnet_tpu_torch.symbol.symbol import _graph_eval_fn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(name, arrays, attrs, cot_seed=0, grad_inputs=None):
    """(forward outputs, input gradients) of op ``name`` from JAX
    (``jax.vjp``) and the port (``torch.autograd.grad``), as numpy."""
    grad_inputs = range(len(arrays)) if grad_inputs is None else grad_inputs
    jfn = jreg.get_op(name).fn
    jouts, vjp = jax.vjp(lambda *a: jfn(*a, **attrs),
                         *[jnp.asarray(a) for a in arrays])
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    rng = np.random.RandomState(cot_seed)
    cts = [rng.randn(*o.shape).astype(np.float32) for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cts) if len(jouts) > 1
                 else jnp.asarray(cts[0]))
    tin = [torch.from_numpy(a.copy()).requires_grad_(i in grad_inputs)
           for i, a in enumerate(arrays)]
    touts = treg.get_op(name).fn(*tin, **attrs)
    touts = touts if isinstance(touts, tuple) else (touts,)
    wanted = [t for i, t in enumerate(tin) if i in grad_inputs]
    tgrads = torch.autograd.grad(touts, wanted,
                                 [torch.from_numpy(c) for c in cts],
                                 allow_unused=True)
    tgrads = [np.zeros(t.shape, np.float32) if g is None else g.numpy()
              for g, t in zip(tgrads, wanted)]
    jgrads = [np.asarray(g) for i, g in enumerate(jgrads)
              if i in grad_inputs]
    return ([np.asarray(o) for o in jouts], jgrads,
            [o.detach().numpy() for o in touts], tgrads)


def _check(name, arrays, attrs, **kw):
    jo, jg, to, tg = _both(name, arrays, attrs, **kw)
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **TOL)
    return to, tg


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,attrs", [
    ((4, 3, 2, 2), {"num_hidden": 5}),                     # flattens NCHW
    ((4, 7), {"num_hidden": 3, "no_bias": True}),
    ((2, 3, 6), {"num_hidden": 4, "flatten": False}),
])
def test_fully_connected(shape, attrs):
    rng = np.random.RandomState(1)
    in_dim = shape[-1] if not attrs.get("flatten", True) \
        else int(np.prod(shape[1:]))
    arrays = [_randn(rng, *shape), _randn(rng, attrs["num_hidden"], in_dim)]
    if not attrs.get("no_bias"):
        arrays.append(_randn(rng, attrs["num_hidden"]))
    _check("FullyConnected", arrays, attrs)


@pytest.mark.parametrize("shape,attrs", [
    ((2, 3, 15, 15), {"kernel": (7, 7), "stride": (2, 2), "pad": (3, 3),
                      "num_filter": 8, "no_bias": True}),       # ResNet stem
    ((2, 4, 9, 9), {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6}),
    ((2, 4, 8, 8), {"kernel": (3, 3), "stride": (2, 2), "num_filter": 6,
                    "num_group": 2, "dilate": (2, 2)}),
    ((2, 4, 11), {"kernel": (3,), "pad": (1,), "num_filter": 5}),
])
def test_convolution(shape, attrs):
    rng = np.random.RandomState(2)
    c = shape[1] // attrs.get("num_group", 1)
    arrays = [_randn(rng, *shape),
              _randn(rng, attrs["num_filter"], c, *attrs["kernel"],
                     scale=0.3)]
    if not attrs.get("no_bias"):
        arrays.append(_randn(rng, attrs["num_filter"]))
    _check("Convolution", arrays, attrs)


@pytest.mark.parametrize("attrs", [
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)},         # stem max
    {"kernel": (7, 7), "global_pool": True, "pool_type": "avg"},  # head
    {"kernel": (3, 3), "stride": (2, 2), "pool_type": "max",
     "pooling_convention": "full"},
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg",
     "pooling_convention": "full"},
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg",
     "count_include_pad": False},
    {"kernel": (2, 2), "stride": (2, 2), "pool_type": "sum"},
    {"kernel": (3, 3), "global_pool": True, "pool_type": "max"},
])
def test_pooling(attrs):
    rng = np.random.RandomState(3)
    _check("Pooling", [_randn(rng, 2, 3, 10, 10)], attrs)


@pytest.mark.parametrize("attrs", [
    {"fix_gamma": False, "train_mode": True, "eps": 2e-5},
    {"fix_gamma": True, "train_mode": True, "eps": 2e-5},       # bn_data
    {"fix_gamma": False, "train_mode": True, "output_mean_var": True},
    {"fix_gamma": False, "train_mode": True, "use_global_stats": True},
    {"fix_gamma": False, "train_mode": False},
])
def test_batch_norm(attrs):
    rng = np.random.RandomState(4)
    c = 5
    arrays = [_randn(rng, 4, c, 3, 3) + 0.5, _randn(rng, c) + 1.0,
              _randn(rng, c), _randn(rng, c, scale=0.1),
              np.abs(_randn(rng, c)) + 0.5]
    # gradients w.r.t. data, gamma and beta (the moving stats are aux)
    _, grads = _check("BatchNorm", arrays, attrs, grad_inputs=(0, 1, 2))
    if attrs["fix_gamma"]:
        assert not grads[1].any()          # gamma replaced by ones


@pytest.mark.parametrize("act_type", ["relu", "sigmoid", "tanh",
                                      "softrelu", "softsign"])
def test_activation(act_type):
    rng = np.random.RandomState(5)
    _check("Activation", [_randn(rng, 3, 7, scale=2.0)],
           {"act_type": act_type})


@pytest.mark.parametrize("attrs", [
    {},
    {"grad_scale": 0.5},
    {"use_ignore": True, "ignore_label": 2.0},
    {"use_ignore": True, "ignore_label": 2.0, "normalization": "valid"},
    {"normalization": "batch"},
    {"smooth_alpha": 0.1},
    {"multi_output": True},
])
def test_softmax_output(attrs):
    """The gradient is (softmax - onehot(label)) * scale whatever the
    head gradient; the label arrives as float32 and gets no gradient."""
    rng = np.random.RandomState(6)
    if attrs.get("multi_output"):
        data = _randn(rng, 3, 4, 5)
        label = rng.randint(0, 4, (3, 5)).astype(np.float32)
    else:
        data = _randn(rng, 6, 4)
        label = np.array([0, 2, 3, 2, 1, 2], np.float32)
    _check("SoftmaxOutput", [data, label], attrs, grad_inputs=(0,))


def test_flatten_and_elemwise_add():
    rng = np.random.RandomState(7)
    _check("Flatten", [_randn(rng, 2, 3, 4)], {})
    a, b = _randn(rng, 2, 5), _randn(rng, 2, 5)
    _check("elemwise_add", [a, b], {})
    (out,) = treg.invoke("elemwise_add", [torch.from_numpy(a),
                                          torch.from_numpy(b)])
    np.testing.assert_array_equal(out.numpy(), a + b)


def test_unported_op_raises_naming_the_roadmap():
    with pytest.raises(MXNetError, match="ROADMAP A15"):
        treg.get_op("linalg_gemm")
    with pytest.raises(MXNetError, match="ROADMAP A8.3"):
        treg.get_op("SyncBatchNorm")


# ---------------------------------------------------------------------------
# symbols
# ---------------------------------------------------------------------------

RESNETS = [
    (1000, 50, (3, 224, 224), 32),
    (10, 20, (3, 32, 32), 4),
    (10, 8, (3, 16, 16), 4),
]


@pytest.mark.parametrize("classes,layers,image,batch", RESNETS)
def test_resnet_symbol_matches_jax(classes, layers, image, batch):
    js = jmx.models.resnet(num_classes=classes, num_layers=layers,
                           image_shape=image, bottle_neck=True)
    ts = tmx.models.resnet(num_classes=classes, num_layers=layers,
                           image_shape=image, bottle_neck=True)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs() == ["softmax_output"]
    shapes = {"data": (batch,) + image, "softmax_label": (batch,)}
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)


def test_resnet50_sizes():
    """157 trained arguments with 25,549,486 values; 102 moving stats."""
    s = tmx.models.resnet(num_classes=1000, num_layers=50,
                          image_shape=(3, 224, 224))
    args, _, aux = s.infer_shape(data=(32, 3, 224, 224),
                                 softmax_label=(32,))
    trained = [sh for n, sh in zip(s.list_arguments(), args)
               if n not in ("data", "softmax_label")]
    assert len(trained) == 157
    assert sum(int(np.prod(sh)) for sh in trained) == 25549486
    assert len(aux) == 102 and sum(int(np.prod(sh)) for sh in aux) == 45574


def test_jax_json_loads_in_port_and_evaluates_alike():
    js = jmx.models.resnet(num_classes=10, num_layers=8,
                           image_shape=(3, 16, 16), bottle_neck=True)
    ts = tmx.symbol.load_json(js.tojson())
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    shapes = {"data": (2, 3, 16, 16), "softmax_label": (2,)}
    args, outs, aux = ts.infer_shape(**shapes)
    assert (args, outs, aux) == js.infer_shape(**shapes)
    rng = np.random.RandomState(8)
    env = {n: _randn(rng, *s, scale=0.2)
           for n, s in zip(ts.list_arguments(), args)}
    env["softmax_label"] = np.array([1, 7], np.float32)
    env.update({n: np.abs(_randn(rng, *s)) + 0.5
                for n, s in zip(ts.list_auxiliary_states(), aux)})
    from mxnet_tpu.symbol.symbol import _graph_eval_fn as jeval
    for train in (False, True):
        jout, _ = jeval(js, train)({k: jnp.asarray(v)
                                    for k, v in env.items()}, None)
        tout, stats = _graph_eval_fn(ts, train)(
            {k: torch.from_numpy(v) for k, v in env.items()})
        np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                                   **TOL)
        assert len(stats) == (len(aux) // 2 if train else 0)
    # and back: the port's JSON loads in the JAX package
    back = jmx.symbol.load_json(ts.tojson())
    assert back.list_arguments() == js.list_arguments()


def test_auto_names_and_attrs():
    data = tmx.sym.Variable("data")
    fc = tmx.sym.FullyConnected(data, num_hidden=4, name="fc1")
    bn = tmx.sym.BatchNorm(fc, name="bn")
    out = tmx.sym.SoftmaxOutput(tmx.sym.Flatten(bn), name="softmax")
    assert out.list_arguments() == ["data", "fc1_weight", "fc1_bias",
                                    "bn_gamma", "bn_beta", "softmax_label"]
    assert out.list_auxiliary_states() == ["bn_moving_mean",
                                           "bn_moving_var"]
    assert out.attr_dict()["fc1"]["num_hidden"] == "4"
    a = tmx.sym.Flatten(data)
    b = tmx.sym.Flatten(data)
    na, nb = a.name, b.name
    assert na.startswith("flatten") and nb == "flatten%d" % (
        int(na[len("flatten"):]) + 1)
    with pytest.raises(MXNetError, match="cannot infer"):
        out.infer_shape()
