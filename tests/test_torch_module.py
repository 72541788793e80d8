"""The port's ``Module.fit`` against the JAX package's.

A bottleneck ResNet (depth 8, 3x16x16, 10 classes, batch 4) is fitted
for 2 epochs of 3 batches by both packages from the same parameters (the
JAX package's initialization carried across with
``convert.module_params_from_numpy``): SGD with momentum and weight
decay under a MultiFactorScheduler whose milestones fall inside the run,
and Adam. After the run every parameter and moving statistic must agree
within 1e-4 of the tensor's largest magnitude (float32 sums in another
order over 6 steps of a network small enough not to amplify them), and the
metrics exactly (accuracy, top-5) or within 1e-5 (cross-entropy). The
port's fused step (one fused-update call over every parameter) and its
unfused path (``MXNET_FUSED_STEP=0``; ``get_outputs()`` before
``update()``) must give the same result bitwise, as the JAX package
holds its own two paths (tests/test_fused_step.py). What the port's
``fit`` does not support yet must raise, naming the feature.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.models  # noqa: E402,F401

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.convert import (module_params_from_numpy,  # noqa: E402
                                     module_params_to_numpy)

BATCH, EPOCHS = 4, 2
X = np.random.RandomState(0).uniform(-1, 1, (12, 3, 16, 16)).astype(
    np.float32)
Y = np.random.RandomState(1).randint(0, 10, (12,)).astype(np.float32)
PARAM_TOL = 1e-4
CE_TOL = 1e-5


def _symbol(mx):
    return mx.models.resnet(num_classes=10, num_layers=8,
                            image_shape=(3, 16, 16), bottle_neck=True)


def _opt(mx, name):
    if name == "sgd":   # milestones after updates 2 and 4 of the 6
        return {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
                "lr_scheduler": mx.lr_scheduler.MultiFactorScheduler(
                    step=[2, 4], factor=0.1, base_lr=0.1)}
    return {"learning_rate": 0.01, "wd": 1e-4}


def _metric(mx):
    return mx.metric.create(["accuracy",
                             mx.metric.create("top_k_accuracy", top_k=5),
                             "ce"])


@pytest.fixture(scope="module")
def init_params():
    """The JAX package's Xavier initialization, as numpy."""
    mod = jmx.mod.Module(_symbol(jmx), context=jmx.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 3, 16, 16))],
             label_shapes=[("softmax_label", (BATCH,))])
    jmx.random.seed(0)
    mod.init_params(jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _jax_fit(init, opt):
    mod = jmx.mod.Module(_symbol(jmx), context=jmx.cpu())
    metric = _metric(jmx)
    mod.fit(jmx.io.NDArrayIter(X, Y, batch_size=BATCH), num_epoch=EPOCHS,
            optimizer=opt, optimizer_params=_opt(jmx, opt),
            arg_params={k: jmx.nd.array(v) for k, v in init[0].items()},
            aux_params={k: jmx.nd.array(v) for k, v in init[1].items()},
            eval_metric=metric)
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()},
            metric.get_name_value(), mod.predict(
                jmx.io.NDArrayIter(X, Y, batch_size=BATCH)).asnumpy())


def _port_fit(init, opt):
    mod = tmx.mod.Module(_symbol(tmx), context=tmx.cpu())
    metric = _metric(tmx)
    arg, aux = module_params_from_numpy(init[0], init[1], device="cpu")
    mod.fit(tmx.io.NDArrayIter(X, Y, batch_size=BATCH), num_epoch=EPOCHS,
            optimizer=opt, optimizer_params=_opt(tmx, opt), arg_params=arg,
            aux_params=aux, eval_metric=metric)
    arg, aux = module_params_to_numpy(*mod.get_params())
    return (arg, aux, metric.get_name_value(), mod.predict(
        tmx.io.NDArrayIter(X, Y, batch_size=BATCH)).asnumpy())


@pytest.fixture(scope="module")
def jax_runs(init_params):
    return {opt: _jax_fit(init_params, opt) for opt in ("sgd", "adam")}


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fit_matches_jax(jax_runs, init_params, opt):
    want = jax_runs[opt]
    got = _port_fit(init_params, opt)
    for g, w in ((got[0], want[0]), (got[1], want[1])):
        assert sorted(g) == sorted(w)
        for k in w:
            err = np.abs(g[k] - w[k]).max() / max(np.abs(w[k]).max(), 1e-6)
            assert err <= PARAM_TOL, (k, err)
    moved = max(np.abs(got[0][k] - init_params[0][k]).max()
                for k in init_params[0])
    assert moved > 1e-3                 # the run trained
    names, values = zip(*got[2])
    jnames, jvalues = zip(*want[2])
    assert names == jnames
    assert values[:2] == jvalues[:2]    # accuracy, top-5: exactly
    assert abs(values[2] - jvalues[2]) <= CE_TOL
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-5)


def test_fused_and_unfused_paths_agree_bitwise(init_params, monkeypatch):
    fused = _port_fit(init_params, "sgd")
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    unfused = _port_fit(init_params, "sgd")
    for a, b in ((fused[0], unfused[0]), (fused[1], unfused[1])):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert fused[2] == unfused[2]


def test_outputs_read_before_update_replay_unfused(init_params):
    """get_outputs() between forward_backward() and update() replays the
    deferred batch unfused; the step is the fused step's, bitwise."""
    runs = []
    for peek in (False, True):
        mod = tmx.mod.Module(_symbol(tmx), context=tmx.cpu())
        mod.bind(data_shapes=[("data", (BATCH, 3, 16, 16))],
                 label_shapes=[("softmax_label", (BATCH,))])
        arg, aux = module_params_from_numpy(*init_params, device="cpu")
        mod.set_params(arg, aux)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=_opt(tmx, "sgd"))
        for batch in tmx.io.NDArrayIter(X, Y, batch_size=BATCH):
            mod.forward_backward(batch)
            if peek:
                mod.get_outputs()
                assert mod._exec.grad_dict["fc1_weight"]._data.abs().sum() \
                    > 0
            mod.update()
        runs.append(module_params_to_numpy(*mod.get_params()))
    for k in runs[0][0]:
        assert np.array_equal(runs[0][0][k], runs[1][0][k]), k


def test_fused_step_launches_one_update_call_per_step(init_params,
                                                      monkeypatch):
    """On the fused path the whole parameter list goes to the rule in one
    call a step (one kernel launch on the card)."""
    from mxnet_tpu_torch.ops.cuda import fused_update as tfu
    calls = []
    real = tfu.sgd_fused_update
    monkeypatch.setattr(tfu, "sgd_fused_update",
                        lambda ws, *a: calls.append(len(ws)) or real(ws, *a))
    _port_fit(init_params, "sgd")
    n_params = len(_symbol(tmx).list_arguments()) - 2
    assert calls == [n_params] * (EPOCHS * len(X) // BATCH)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_per_index_hypers_match_jax(init_params, opt):
    """The lr and wd each parameter gets on each step, index by index as
    both Modules hand them to the fused step, are the JAX package's:
    wd only on ``_weight``/``_gamma`` names (``bn_data_gamma`` decays
    under fix_gamma), the schedule's milestones, Adam's bias correction.
    (The fit comparison above cannot see a wd mistake under SGD: the whole
    decay of the run is about 1e-4 of a weight.)"""
    mods = []
    for mx, arg, aux in (
            (jmx, {k: jmx.nd.array(v) for k, v in init_params[0].items()},
             {k: jmx.nd.array(v) for k, v in init_params[1].items()}),
            (tmx,) + module_params_from_numpy(*init_params, device="cpu")):
        mod = mx.mod.Module(_symbol(mx), context=mx.cpu())
        mod.bind(data_shapes=[("data", (BATCH, 3, 16, 16))],
                 label_shapes=[("softmax_label", (BATCH,))])
        mod.init_params(arg_params=arg, aux_params=aux)
        mod.init_optimizer(optimizer=opt, optimizer_params=_opt(mx, opt))
        mods.append(mod)
    jmod, tmod = mods
    assert tmod._param_names == jmod._param_names
    wd_names = set()
    for _ in range(6):                  # the milestones fall after 2 and 4
        for i, name in enumerate(jmod._param_names):
            want = jmod._optimizer.fused_hyper(i)
            assert tmod._optimizer.fused_hyper(i) == want, (name, want)
            if want["wd"]:
                wd_names.add(name)
    assert wd_names == {n for n in jmod._param_names
                        if n.endswith(("_weight", "_gamma"))}
    assert "bn_data_gamma" in wd_names


@pytest.mark.parametrize("kwargs,match", [
    ({"checkpoint_prefix": "ck", "checkpoint_period": 0},
     "checkpoint_period"),
    ({"resume": True}, "needs checkpoint_prefix"),
    ({"monitor": object()}, "A8.6"),
    ({"sparse_row_id_fn": lambda b: b}, "A8.6"),
    ({"kvstore": "dist_sync"}, "A13"),
    ({"optimizer_params": {"multi_precision": True}}, "A8.4"),
    ({"optimizer": "nag"}, "A8.5"),
    ({"epoch_end_callback": None, "elastic": True}, "A13"),
])
def test_refused_features_raise(init_params, monkeypatch, kwargs, match):
    kwargs = dict(kwargs)
    if kwargs.pop("elastic", False):
        monkeypatch.setenv("MXNET_ELASTIC_DIR", "/nonexistent")
    mod = tmx.mod.Module(_symbol(tmx), context=tmx.cpu())
    args = dict(num_epoch=1, optimizer="sgd",
                initializer=tmx.init.Xavier())
    args.update(kwargs)
    with pytest.raises((MXNetError, NotImplementedError), match=match):
        mod.fit(tmx.io.NDArrayIter(X, Y, batch_size=BATCH), **args)


def test_refused_contexts_weights_and_callbacks():
    sym = _symbol(tmx)
    with pytest.raises(NotImplementedError, match="A8.3"):
        tmx.mod.Module(sym, context=[tmx.cpu(), tmx.cpu()])
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.mod.Module(sym)             # cuda:0 by default; none here
    assert callable(tmx.callback.do_checkpoint("prefix"))  # ported (A8.2)
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 3, 16, 16))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(tmx.init.Xavier())
    mod._exec.arg_dict["fc1_bias"]._set_data(torch.zeros(10,
                                                         dtype=torch.float16))
    with pytest.raises(NotImplementedError, match="float32"):
        mod.init_optimizer(optimizer="sgd")


def test_xavier_and_name_dispatch():
    tmx.random.seed(3)
    w = tmx.nd.zeros((256, 32, 3, 3), ctx=tmx.cpu())
    tmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                    magnitude=2)("conv_weight", w)
    std = float(w.asnumpy().std())
    assert abs(std / np.sqrt(2.0 / (32 * 9)) - 1) <= 0.05
    u = tmx.nd.zeros((64, 100), ctx=tmx.cpu())
    tmx.init.Xavier()("fc_weight", u)    # uniform, factor avg, magnitude 3
    bound = np.sqrt(3.0 / ((100 + 64) / 2.0))
    assert np.abs(u.asnumpy()).max() <= bound
    init = tmx.init.Uniform(0.5)
    for name, value in (("fc_bias", 0.0), ("bn_beta", 0.0),
                        ("bn_moving_mean", 0.0), ("bn_gamma", 1.0),
                        ("bn_moving_var", 1.0)):
        arr = tmx.nd.array(np.full((3,), 7.0, np.float32), ctx=tmx.cpu())
        init(name, arr)
        assert (arr.asnumpy() == value).all(), name
    with pytest.raises(ValueError, match="Unknown initialization"):
        init("mystery", tmx.nd.zeros((2,), ctx=tmx.cpu()))
    tmx.random.seed(3)
    again = tmx.nd.zeros((256, 32, 3, 3), ctx=tmx.cpu())
    tmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                    magnitude=2)("conv_weight", again)
    assert np.array_equal(again.asnumpy(), w.asnumpy())   # seeded


def test_score_and_resize_iter(init_params):
    mod = tmx.mod.Module(_symbol(tmx), context=tmx.cpu())
    it = tmx.io.ResizeIter(tmx.io.NDArrayIter(X, Y, batch_size=BATCH), 5)
    arg, aux = module_params_from_numpy(*init_params, device="cpu")
    mod.fit(it, num_epoch=1, optimizer="sgd", arg_params=arg,
            aux_params=aux)
    assert it.cur == 0                  # reset at the epoch's end
    res = dict(mod.score(tmx.io.NDArrayIter(X, Y, batch_size=BATCH),
                         ["acc", "ce"]))
    assert 0.0 <= res["accuracy"] <= 1.0 and np.isfinite(
        res["cross-entropy"])
    with pytest.raises(MXNetError, match="A8.6"):
        tmx.metric.create("f1")
