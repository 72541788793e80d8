"""Low-precision training in the port against the JAX package, on the
CPU.

* float16 weights with ``multi_precision`` (a float32 master copy and
  float32 states, the kernel's master mode; ``sgd_fused_update`` /
  ``_sgd_fused`` and ``adam_fused_update`` / ``_adam_fused`` with
  ``masters``) through Gluon's ``Trainer`` and through the ``Updater``,
  fed the same gradients in both packages: the masters and states are
  the JAX package's within F32_ULPS float32 ULPs of their scale (its
  update ops are jitted, and XLA contracts their multiply-adds), the
  float16 weights within one float16 ULP. The state files cross both ways
  (``Trainer.save_states`` / ``load_states``, ``Updater.get_states`` /
  ``set_states``) and training goes on from them.
* A bfloat16 weight with ``multi_precision`` takes its plain bf16
  update, as in the JAX package (the master copy is float16's only).
* The analog of the JAX package's ``test_bf16_end_to_end_convergence``:
  an MLP of 64 units cast to bfloat16 and hybridized learns a 10-class
  problem of 1000 samples to accuracy above 0.9.
* A Conv + BatchNorm + Dense ``HybridSequential`` cast to bfloat16 (its
  BatchNorm float32, as in both packages) takes three ``Trainer`` steps
  in both packages from converted weights; each update is one call over
  bf16 and float32 tensors together. Against a float64 witness (the
  same net and steps in float64), the port's error is at most 1.5 times
  the JAX package's own.
"""
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.ops.cuda import fused_update as tfu  # noqa: E402

SHAPES = [(6, 5), (5,), (3, 2, 3, 3)]
RATIO = 1.5
# the JAX package's update ops are jitted: XLA contracts multiply-adds
F32_ULPS = 4


def _params(mx, dtype, w0, ctx):
    params = []
    for i, w in enumerate(w0):
        p = mx.gluon.Parameter("p%d_weight" % i, shape=w.shape)
        p.initialize(ctx=ctx)
        p.set_data(mx.nd.array(w, **({"ctx": ctx} if ctx else {})))
        p.cast(dtype)
        params.append(p)
    return params


def _set_grads(mx, params, grads):
    for p, g in zip(params, grads):
        target = p.grad()
        if mx is tmx:
            with torch.no_grad():
                target._data.copy_(torch.from_numpy(g))
        else:
            target._set_data(jnp.asarray(g).astype(target._data.dtype))


def _snapshot(params, states):
    out = []
    for p, s in zip(params, states):
        flat = []
        stack = [s]
        while stack:
            x = stack.pop(0)
            if isinstance(x, (list, tuple)):
                stack = list(x) + stack
            elif x is not None:
                flat.append(x.asnumpy())
        out.append([p.data().asnumpy()] + flat)
    return out


def _bits_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    view = {2: np.uint16, 4: np.uint32}[a.dtype.itemsize]
    assert np.array_equal(a.view(view), b.view(view)), what


def _ulps_close(a, b, scale, ulps, what):
    """Within ``ulps`` ULPs (of ``scale``'s type) of ``scale``."""
    spacing = np.spacing(scale).astype(np.float64)
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.all(err <= ulps * spacing), (what, np.max(err / spacing))


def _compare(got, want, what):
    """Each tensor's float32 arrays (master, states) within F32_ULPS of
    their scale (the largest magnitude in any of them, both sides: the
    updates add a gradient term larger than many of the values), its
    float16 weight within one float16 ULP."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) and [a.dtype for a in g] == [
            a.dtype for a in w]
        f32 = [a for a in g + w if a.dtype == np.float32]
        scale = np.max(np.abs(np.stack(f32))) if f32 else None
        for k, (a, b) in enumerate(zip(g, w)):
            tag = "%s tensor %d array %d" % (what, i, k)
            if a.dtype == np.float16:
                _ulps_close(a, b, np.maximum(np.abs(a), np.abs(b)), 1, tag)
            else:
                _ulps_close(a, b, scale, F32_ULPS, tag)


OPT = {"sgd": dict(learning_rate=0.1, momentum=0.9, wd=1e-3,
                   clip_gradient=0.5, multi_precision=True),
       "adam": dict(learning_rate=0.01, wd=1e-3, multi_precision=True)}


def _trainers(name, w0):
    out = {}
    for key, mx, ctx in (("torch", tmx, tmx.cpu()), ("jax", jmx, None)):
        params = _params(mx, "float16", w0, ctx)
        out[key] = (mx, params, mx.gluon.Trainer(params, name,
                                                  dict(OPT[name])))
    return out


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_float16_multi_precision_trainer_matches_jax(name, tmp_path,
                                                    monkeypatch):
    """Three Trainer steps on float16 weights with multi_precision (one
    call of the rule a step, every tensor on its master), the states
    saved by each package and loaded by the other, two more steps each:
    the same weights, masters and states as the JAX package."""
    rng = np.random.RandomState(3)
    w0 = [(rng.randn(*s) * 0.1).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float16) for s in SHAPES]
             for _ in range(5)]
    run = _trainers(name, w0)
    plain = "_%s_fused" % name
    real, calls = getattr(tfu, plain), []

    def spy(ws, gs, states, hypers, masters=None):
        calls.append(sum(m is not None for m in masters or ()))
        return real(ws, gs, states, hypers, masters)

    monkeypatch.setattr(tfu, plain, spy)
    for step in range(3):
        for key, (mx, params, tr) in run.items():
            _set_grads(mx, params, grads[step])
            tr.step(4)
    assert calls == [len(SHAPES)] * 3
    for state, p in zip(run["torch"][2]._states, run["torch"][1]):
        assert state[1].dtype == np.float32 and state[1].shape == p.shape
    _compare(_snapshot(run["torch"][1], run["torch"][2]._states),
             _snapshot(run["jax"][1], run["jax"][2]._states),
             name + " after 3 steps")
    # the state files cross: each package continues from the other's,
    # held against the JAX package continuing from its own (its file
    # keeps num_update, not the per-index counts Adam's correction reads)
    paths = {k: str(tmp_path / ("%s.states" % k)) for k in run}
    for key, (_mx, _p, tr) in run.items():
        tr.save_states(paths[key])
    crossed = _trainers(name, w0)
    crossed["again"] = _trainers(name, w0)["jax"]
    for key, other in (("torch", "jax"), ("jax", "torch"), ("again", "jax")):
        mx, params, tr = crossed[key]
        for p, q in zip(params, run[other][1]):
            p.set_data(mx.nd.array(q.data().asnumpy().astype(np.float32),
                                   **({"ctx": tmx.cpu()} if mx is tmx
                                      else {})).astype("float16"))
        tr.load_states(paths[other])
    for step in range(3, 5):
        for runs in (run, crossed):
            for key, (mx, params, tr) in runs.items():
                _set_grads(mx, params, grads[step])
                tr.step(4)

    def snap(runs, key):
        return _snapshot(runs[key][1], runs[key][2]._states)

    _compare(snap(run, "torch"), snap(run, "jax"), name + " after 5 steps")
    for key in ("torch", "jax"):
        _compare(snap(crossed, key), snap(crossed, "again"),
                 "%s after 5 steps, %s loading the other's file"
                 % (name, key))


def test_float16_multi_precision_updater_matches_jax():
    """The Updater (Module's per-parameter path) with multi_precision on
    float16 weights: the same values as the JAX package's
    ``mp_sgd_mom_update``, and ``get_states`` crosses both ways."""
    rng = np.random.RandomState(4)
    w0 = [(rng.randn(*s) * 0.1).astype(np.float16) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float16) for s in SHAPES]
             for _ in range(4)]
    ups, ws = {}, {}
    for key, mx, kw in (("torch", tmx, {"ctx": tmx.cpu()}), ("jax", jmx, {})):
        ups[key] = mx.optimizer.get_updater(mx.optimizer.create(
            "sgd", **OPT["sgd"]))
        ws[key] = [mx.nd.array(w, dtype=np.float16, **kw) for w in w0]

    def step(key, k):
        mx = tmx if key == "torch" else jmx
        kw = {"ctx": tmx.cpu()} if key == "torch" else {}
        for i, (w, g) in enumerate(zip(ws[key], grads[k])):
            ups[key](i, mx.nd.array(g, dtype=np.float16, **kw), w)

    def values(key):
        return [[w.asnumpy()] + [s.asnumpy() for s in ups[key].states[i]]
                for i, w in enumerate(ws[key])]

    for k in range(2):
        step("torch", k)
        step("jax", k)
    _compare(values("torch"), values("jax"), "updater")
    blobs = {k: u.get_states() for k, u in ups.items()}
    ups["torch"].set_states(blobs["jax"])
    ups["jax"].set_states(blobs["torch"])
    for k in range(2, 4):
        step("torch", k)
        step("jax", k)
    _compare(values("torch"), values("jax"), "updater, crossed")
    assert pickle.loads(blobs["torch"])[0][1].dtype == np.float32


def test_bfloat16_multi_precision_is_the_plain_update():
    """multi_precision keeps master copies of float16 weights only: a
    bfloat16 weight takes the bf16 rule, bitwise what it takes without
    the flag, and its state is bf16, as in the JAX package."""
    rng = np.random.RandomState(6)
    w = (rng.randn(40) * 0.1).astype(np.float32)
    g = rng.randn(40).astype(np.float32)
    out = []
    for mp in (True, False):
        opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                   multi_precision=mp)
        upd = tmx.optimizer.get_updater(opt)
        x = tmx.nd.array(w, ctx=tmx.cpu(), dtype="bfloat16")
        upd(0, tmx.nd.array(g, ctx=tmx.cpu(), dtype="bfloat16"), x)
        assert upd.states[0].dtype == "bfloat16"
        out.append(x.asnumpy())
    jopt = jmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                multi_precision=True)
    state = jopt.create_state_multi_precision(0, jmx.nd.array(w).astype(
        "bfloat16"))
    assert str(state.dtype) == "bfloat16"
    _bits_equal(out[0], out[1], "bf16 with and without multi_precision")


def _synthetic_mnist(n=1000, seed=7):
    """The JAX package's test problem (tests/test_module.py)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(10, 784).astype(np.float32) * 1.2
    labels = rng.randint(0, 10, size=n)
    data = centers[labels] + rng.randn(n, 784).astype(np.float32)
    return data.astype(np.float32), labels.astype(np.float32)


def test_bf16_end_to_end_convergence():
    """The port's run of the JAX package's bf16 convergence test: every
    update one ``sgd_fused_update`` call over bf16 weights."""
    mx = tmx
    tmx.random.seed(0)
    data, labels = _synthetic_mnist()
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(64, activation="relu"))
        net.add(mx.gluon.nn.Dense(10))
    net.initialize(ctx=mx.cpu())
    net(mx.nd.array(data[:2], ctx=mx.cpu()))
    net.cast("bfloat16")
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.2})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    it = mx.io.NDArrayIter(data, labels, batch_size=100, shuffle=True)
    calls = []
    real = tfu._sgd_fused

    def spy(ws, *args):
        calls.append({w.dtype for w in ws})
        return real(ws, *args)

    tfu._sgd_fused = spy
    try:
        for _ in range(4):
            it.reset()
            for batch in it:
                x = batch.data[0].astype("bfloat16")
                with mx.autograd.record():
                    out = loss_fn(net(x), batch.label[0])
                out.backward()
                trainer.step(x.shape[0])
    finally:
        tfu._sgd_fused = real
    assert len(calls) == 40 and all(c == {torch.bfloat16} for c in calls)
    correct = total = 0
    it.reset()
    for batch in it:
        pred = net(batch.data[0].astype("bfloat16")).asnumpy()
        pred = pred.astype(np.float32).argmax(axis=1)
        n_real = batch.data[0].shape[0] - batch.pad
        correct += (pred[:n_real] == batch.label[0].asnumpy()[:n_real]).sum()
        total += n_real
    assert correct / total > 0.9, correct / total


def _convnet(mx, ctx):
    net = mx.gluon.nn.HybridSequential(prefix="cbd_")
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(6, 3, padding=1, in_channels=3))
        net.add(mx.gluon.nn.BatchNorm(in_channels=6))
        net.add(mx.gluon.nn.Activation("relu"))
        net.add(mx.gluon.nn.Dense(5, in_units=6 * 8 * 8))
    kw = {"ctx": ctx} if ctx else {}
    net.initialize(mx.init.Xavier(), **kw)
    return net


def _conv_steps(mx, net, xs, ys, dtype, ctx):
    """Three steps of SGD with momentum: ``Trainer.step``, or for the
    float64 witness (no kernel takes float64) the plain rule with the
    optimizer's own hypers."""
    kw = {"ctx": ctx} if ctx else {}
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
    params = net.collect_params()
    trained = [p for p in params.values() if p.grad_req != "null"]
    if dtype == "float64":
        sgd = mx.optimizer.create("sgd", rescale_grad=1.0 / len(ys[0]),
                                  param_dict=dict(enumerate(trained)), **opt)
        moms = [torch.zeros(p.shape, dtype=torch.float64) for p in trained]
    else:
        trainer = mx.gluon.Trainer(params, "sgd", opt)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in zip(xs, ys):
        x = mx.nd.array(x, **kw).astype(dtype)
        with mx.autograd.record():
            loss = loss_fn(net(x), mx.nd.array(y, **kw))
        loss.backward()
        if dtype != "float64":
            trainer.step(x.shape[0])
            continue
        with torch.no_grad():
            tfu._sgd_fused([p.data()._data for p in trained],
                           [p.grad()._data for p in trained],
                           [(m,) for m in moms],
                           [sgd.fused_hyper(i) for i in range(len(trained))])
    return {k.split("_", 1)[1]: p.data().asnumpy().astype(np.float64)
            for k, p in params.items()}


def test_bf16_conv_bn_dense_steps_within_ratio_of_jax(monkeypatch):
    """Three bf16 Trainer steps of Conv + BatchNorm + Dense in both
    packages from the same (bf16-exact) weights; against the float64
    witness the port's relative error (the norm of the difference over
    every trained weight, over the witness's norm) is at most RATIO
    times the JAX package's. (The conv bias, whose gradient BatchNorm
    makes 0, is rounding alone: no per-tensor ratio would mean much.)"""
    rng = np.random.RandomState(8)
    xs = [rng.uniform(-1, 1, (4, 3, 8, 8)).astype(np.float32)
          for _ in range(3)]
    ys = [rng.randint(0, 5, (4,)).astype(np.float32) for _ in range(3)]
    tmx.random.seed(1)
    tnet = _convnet(tmx, tmx.cpu())
    tnet.cast("bfloat16")
    start = {k: p.data().asnumpy() for k, p in
             tnet.collect_params().items()}
    jnet = _convnet(jmx, None)
    jnet.cast("bfloat16")
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(start[k].astype(np.float32)).astype(
            p.data().dtype))
    wnet = _convnet(tmx, tmx.cpu())
    wnet.cast("float64")
    for k, p in wnet.collect_params().items():
        p.set_data(tmx.nd.array(start[k].astype(np.float64), ctx=tmx.cpu(),
                                dtype=np.float64))
    wit = _conv_steps(tmx, wnet, xs, ys, "float64", tmx.cpu())
    calls, real = [], tfu._sgd_fused

    def spy(ws, *args):
        calls.append({w.dtype for w in ws})
        return real(ws, *args)

    monkeypatch.setattr(tfu, "_sgd_fused", spy)
    got = _conv_steps(tmx, tnet, xs, ys, "bfloat16", tmx.cpu())
    assert calls == [{torch.bfloat16, torch.float32}] * 3
    ref = _conv_steps(jmx, jnet, xs, ys, "bfloat16", None)

    keys = [k for k in wit if "running" not in k]

    def err(res):       # relative norm over every trained weight
        diff = np.concatenate([(res[k] - wit[k]).ravel() for k in keys])
        return np.linalg.norm(diff) / np.linalg.norm(
            np.concatenate([wit[k].ravel() for k in keys]))

    e_port, e_jax = err(got), err(ref)
    print("relative error against float64: port %.3g, JAX %.3g"
          % (e_port, e_jax))
    assert 0 < e_port <= RATIO * e_jax, (e_port, e_jax)
