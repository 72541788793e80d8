"""One SGD step of the zoo's Inception v3 through ``Module``, the port
against the JAX package (``benchmark.py``'s ``train_inception``: the net
traced to a Symbol under ``SoftmaxOutput``, SGD at lr 0.05 and momentum
0.9), on the CPU at batch 1, 3x299x299 (its final ``AvgPool2D(8)`` needs
299), 10 classes.

Both start from the same weights (the port's Xavier draw, the
BatchNorms' statistics, gammas and betas from numpy) and the same
batch; Dropout's p is set to 0 through the traced JSON in both, since
the packages draw their masks from different generators. Held: the
outputs within ``TOL`` = 1e-5, and the step by float32's own error on
this problem, as ``test_torch_gluon.py`` holds ResNet-18 (ROADMAP C
caveats): one step from random weights through 94 training BatchNorms
at batch 1 is ill-conditioned, and a 1e-6 relative nudge of the port's
starting weights moves the updates by ~6% (relative RMS, the worst
tensor), as much as the port differs from the JAX package. So the
change of every weight and running statistic, against the JAX
package's (the largest relative RMS error over the tensors), is at
most ``RATIO`` times what the nudge makes of it (1.0 when written).
The JAX step compiles for about a minute on the CPU, so it has a file
of its own.
"""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.convert import (gluon_params_from_jax,  # noqa: E402
                                     gluon_params_to_numpy)

TOL = 1e-5
RATIO = 4.0
NUDGE = 1e-6     # relative nudge of every starting weight (a few ulps)


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


def _rel_rms(got, want):
    return float(np.sqrt(((got - want) ** 2).sum()
                         / max((want ** 2).sum(), 1e-60)))


def _worst_change_error(got, start_got, want, start_want):
    """The largest relative RMS error of a tensor's change in the step."""
    return max(_rel_rms(got[k] - start_got[k], want[k] - start_want[k])
               for k in want)


def _build(mx):
    return mx.gluon.model_zoo.vision.get_model("inceptionv3", classes=10,
                                               prefix="zoo_")


def _values(x, seed):
    tmx.random.seed(seed)
    net = _build(tmx)
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


def _traced(mx, vals):
    """The net's Symbol (auto-names from 0), Dropout's p set to 0."""
    net = _build(mx)
    if mx is tmx:
        gluon_params_from_jax(vals, net, ctx=tmx.cpu())
    else:
        # set directly: the JAX package's own initialization draws op by
        # op and takes a minute for Inception
        for k, p in net.collect_params().items():
            p._set_shape_from(vals[k].shape)
            p._data = _arr(jmx, vals[k])
    mx.symbol.symbol._name_mgr._counter = {}
    graph = json.loads(net._trace_symbol().tojson())
    dropouts = 0
    for node in graph["nodes"]:
        if node["op"] == "Dropout":
            node["attrs"]["p"] = 0.0
            dropouts += 1
    assert dropouts == 1
    return mx.sym.load_json(json.dumps(graph))


def _step(mx, sym, vals, x, y):
    """Outputs and every weight / statistic after one Module SGD step."""
    out = mx.sym.SoftmaxOutput(sym, name="softmax")
    mod = mx.mod.Module(out, context=mx.cpu())
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    args, auxs = set(out.list_arguments()), set(out.list_auxiliary_states())
    mod.init_params(
        arg_params={k: _arr(mx, v) for k, v in vals.items() if k in args},
        aux_params={k: _arr(mx, v) for k, v in vals.items() if k in auxs})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.05, "momentum": 0.9})
    mod.forward_backward(mx.io.DataBatch([_arr(mx, x)], [_arr(mx, y)]))
    mod.update()
    outs = mod.get_outputs()[0].asnumpy()
    arg, aux = mod.get_params()
    return outs, {k: v.asnumpy() for k, v in list(arg.items())
                  + list(aux.items())}


def test_inception_module_step_matches_jax():
    x = np.random.RandomState(4).uniform(-1, 1, (1, 3, 299, 299)).astype(
        np.float32)
    y = np.array([3], np.float32)
    vals = _values(x, seed=5)
    jsym, tsym = _traced(jmx, vals), _traced(tmx, vals)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert len(tsym.list_auxiliary_states()) == 2 * 94
    jout, jp = _step(jmx, jsym, vals, x, y)
    tout, tp = _step(tmx, tsym, vals, x, y)
    assert _rel(tout, jout) <= TOL
    assert sorted(tp) == sorted(jp)
    rng = np.random.RandomState(6)
    nudged = {k: (v * (1 + NUDGE * rng.uniform(-1, 1, v.shape))).astype(
        np.float32) for k, v in vals.items()}
    _, np_ = _step(tmx, tsym, nudged, x, y)
    err = _worst_change_error(tp, vals, jp, vals)
    floor = _worst_change_error(np_, nudged, tp, vals)
    assert err <= RATIO * floor, (err, floor)
    # the step moved the weights
    assert max(_rel(jp[k], vals[k]) for k in jp) > 1e-3
