"""The port's Gluon model zoo against the JAX package's.

* ``get_model`` over the JAX package's whole name table (34 names): the
  same ``collect_params()`` names and (deferred) shapes, and an unknown
  name raises ``ValueError`` in both.
* Every family's forward (AlexNet, VGG with and without BatchNorm,
  SqueezeNet 1.0 / 1.1, DenseNet-121 at 224, Inception v3 at 299,
  MobileNet v1 / v2), batch 1-2 with 10 classes, from the same weights:
  the port's net is initialized, its running statistics, gammas and
  betas replaced by numpy draws, and the values set into the JAX twin.
  The port's logits, eager and hybridized, within ``TOL`` = 1e-5 of the
  JAX package's hybridized predict (its eager layers compile op by op
  on the CPU and take minutes for Inception). Inception's channel
  concatenation order is held by this too.
* ``pretrained=True`` in every family loads ``<root>/<name>.params``
  (``model_store``), and raises ``MXNetError`` naming the path without
  it.
* ``export`` of a BatchNorm net (MobileNet 0.25) imports in the other
  package's ``SymbolBlock``, both ways, within 1e-5 of the net; MobileNet
  v2 exports and imports back in the port.

Inception v3's training step is held in ``test_torch_zoo_train.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.gluon.model_zoo.vision as jvision  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.convert import (gluon_params_from_jax,  # noqa: E402
                                     gluon_params_to_numpy)

TOL = 1e-5

# the JAX package's get_model table
JAX_NAMES = (
    ["resnet%d_v%d" % (n, v) for v in (1, 2) for n in (18, 34, 50, 101, 152)]
    + ["vgg%d%s" % (n, bn) for bn in ("", "_bn") for n in (11, 13, 16, 19)]
    + ["alexnet"] + ["densenet%d" % n for n in (121, 161, 169, 201)]
    + ["squeezenet1.0", "squeezenet1.1", "inceptionv3"]
    + ["mobilenet%s" % m for m in ("1.0", "0.75", "0.5", "0.25")]
    + ["mobilenetv2_%s" % m for m in ("1.0", "0.75", "0.5", "0.25")])

# a net of each family: (name, input side, batch)
FAMILIES = [("alexnet", 64, 2), ("vgg11", 32, 2), ("vgg11_bn", 32, 2),
            ("squeezenet1.0", 64, 2), ("squeezenet1.1", 64, 2),
            ("densenet121", 224, 1), ("inceptionv3", 299, 1),
            ("mobilenet0.25", 32, 2), ("mobilenetv2_0.25", 32, 2)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _arr(mx, a):
    return mx.nd.array(a, ctx=mx.cpu())


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _build(mx, name):
    return mx.gluon.model_zoo.vision.get_model(name, classes=10,
                                               prefix="zoo_")


def _values(name, x, seed=0):
    """Numpy parameters of ``name``: the port's Xavier draw, with every
    BatchNorm's statistics, gamma and beta drawn from ``seed``."""
    tmx.random.seed(seed)
    net = _build(tmx, name)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    with tmx.autograd.predict_mode():
        net(_arr(tmx, x))
    rng = np.random.RandomState(seed)
    vals = gluon_params_to_numpy(net)
    for k, v in vals.items():
        if k.endswith(("running_var", "gamma")):
            vals[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith(("running_mean", "beta")):
            vals[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
    return vals


def _port(name, vals):
    net = _build(tmx, name)
    gluon_params_from_jax(vals, net, ctx=tmx.cpu())
    return net


def _jax(name, vals):
    """The JAX twin with ``vals`` set directly: the JAX package's own
    initialization draws op by op and takes a minute for Inception."""
    net = _build(jmx, name)
    for k, p in net.collect_params().items():
        p._set_shape_from(vals[k].shape)
        p._data = _arr(jmx, vals[k])
        if p.grad_req != "null":
            jmx.autograd.mark_variable(p._data, p.grad_req)
    return net


@pytest.mark.parametrize("name", JAX_NAMES)
def test_get_model_names_and_shapes_match_jax(name):
    got = tmx.gluon.model_zoo.vision.get_model(name, prefix="m_")
    want = jvision.get_model(name, prefix="m_")
    assert [(k, p.shape) for k, p in got.collect_params().items()] == \
        [(k, p.shape) for k, p in want.collect_params().items()]


def test_get_model_unknown_name_raises_in_both():
    for vision in (tmx.gluon.model_zoo.vision, jvision):
        with pytest.raises(ValueError, match="not supported"):
            vision.get_model("resnet19_v1")


@pytest.mark.parametrize("name,side,batch", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_family_forward_matches_jax(name, side, batch):
    x = np.random.RandomState(1).uniform(
        -1, 1, (batch, 3, side, side)).astype(np.float32)
    vals = _values(name, x)
    jnet = _jax(name, vals)
    jnet.hybridize()
    want = jnet(_arr(jmx, x)).asnumpy()
    tnet = _port(name, vals)
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    eager = tnet(_arr(tmx, x)).asnumpy()
    tnet.hybridize()
    hybrid = tnet(_arr(tmx, x)).asnumpy()
    assert want.shape == (batch, 10)
    assert _rel(eager, want) <= TOL and _rel(hybrid, want) <= TOL


# get_model name -> the file its getter loads (the JAX package's names)
PRETRAINED = {"resnet18_v2": "resnet18_v2", "vgg11": "vgg11",
              "vgg13_bn": "vgg13_bn", "alexnet": "alexnet",
              "densenet121": "densenet121", "squeezenet1.1": "squeezenet1.1",
              "inceptionv3": "inceptionv3", "mobilenet1.0": "mobilenet1",
              "mobilenet0.5": "mobilenet0_5",
              "mobilenetv2_0.75": "mobilenetv2_0_75"}


@pytest.mark.parametrize("name", sorted(PRETRAINED))
def test_pretrained_loads_the_staged_file(name, tmp_path):
    fname = PRETRAINED[name]
    net = tmx.gluon.model_zoo.vision.get_model(name, classes=10)
    with pytest.raises(MXNetError, match="%s.params" % fname):
        tmx.gluon.model_zoo.vision.get_model(name, pretrained=True,
                                             root=str(tmp_path))
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    side = {"alexnet": 64, "densenet121": 224, "inceptionv3": 299}.get(
        name, 32)
    with tmx.autograd.predict_mode():
        net(tmx.nd.zeros((1, 3, side, side), ctx=tmx.cpu()))
    net.save_parameters(str(tmp_path / ("%s.params" % fname)))
    got = tmx.gluon.model_zoo.vision.get_model(
        name, classes=10, pretrained=True, root=str(tmp_path), ctx=tmx.cpu())
    want = gluon_params_to_numpy(net)
    have = gluon_params_to_numpy(got)
    assert [k.split("_", 1)[1] for k in have] == \
        [k.split("_", 1)[1] for k in want]
    for a, b in zip(have.values(), want.values()):
        np.testing.assert_array_equal(a, b)


def test_model_store_purge(tmp_path):
    (tmp_path / "a.params").write_bytes(b"x")
    (tmp_path / "keep.txt").write_text("x")
    tmx.gluon.model_zoo.model_store.purge(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["keep.txt"]


def test_export_round_trips_between_the_packages(tmp_path):
    from mxnet_tpu.gluon import SymbolBlock as JSymbolBlock
    name = "mobilenet0.25"
    x = np.random.RandomState(2).uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32)
    vals = _values(name, x, seed=3)
    jnet, tnet = _jax(name, vals), _port(name, vals)
    ref = tnet(_arr(tmx, x)).asnumpy()
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    jmx.symbol.symbol._name_mgr._counter = {}
    tmx.symbol.symbol._name_mgr._counter = {}
    jsym, tsym = jnet.export(jp), tnet.export(tp)
    for what in ("list_arguments", "list_auxiliary_states", "list_outputs"):
        assert getattr(tsym, what)() == getattr(jsym, what)(), what
    port_of_jax = tmx.gluon.SymbolBlock.imports(
        jp + "-symbol.json", ["data"], jp + "-0000.params", ctx=tmx.cpu())
    jax_of_port = JSymbolBlock.imports(tp + "-symbol.json", ["data"],
                                       tp + "-0000.params")
    jax_of_port.hybridize()
    for out in (port_of_jax(_arr(tmx, x)).asnumpy(),
                jax_of_port(_arr(jmx, x)).asnumpy()):
        assert out.shape == (2, 10) and _rel(out, ref) <= TOL


def test_mobilenet_v2_exports_in_the_port(tmp_path):
    """MobileNet v2's ReLU6 is ``F.clip(x, 0, 6)``: the JAX package's
    Symbol trace refuses the positional bounds (ROADMAP C.9's fault, in
    that package), the port's binds them and its export imports back
    within 1e-5 of the net."""
    name = "mobilenetv2_0.25"
    x = np.random.RandomState(2).uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32)
    vals = _values(name, x, seed=3)
    tnet = _port(name, vals)
    ref = tnet(_arr(tmx, x)).asnumpy()
    tp = str(tmp_path / "port")
    tnet.export(tp)
    back = tmx.gluon.SymbolBlock.imports(
        tp + "-symbol.json", ["data"], tp + "-0000.params", ctx=tmx.cpu())
    assert _rel(back(_arr(tmx, x)).asnumpy(), ref) <= TOL
    with pytest.raises(TypeError, match="positional"):
        _jax(name, vals).export(str(tmp_path / "jax"))
