"""The port's ``parallel.ShardedTrainer`` / ``make_train_step`` against
the JAX package's, on the CPU.

The same numpy parameters and batches go through the JAX package's
jitted ``make_train_step`` and the port's:

* the MLP (784-128-64-10, batch 8, lr 0.1, momentum 0.9, wd 1e-4): every
  parameter and momentum within 1e-4 of its largest magnitude over 3
  steps, the losses within 1e-5;
* a CIFAR ResNet-20 (3x28x28, batch 4, lr 0.05, momentum 0.9, wd 1e-4)
  in float32: the loss after one step within 1e-6, the moving
  statistics after one step float32 and within 1e-5 of each tensor's
  largest magnitude. ResNet gradients are ill-conditioned in float32
  (ROADMAP C's caveats): a 1e-6 nudge of the port's own starting weights
  moves the updates by percents within 3 steps. So after each of 3
  steps the relative norm of the difference of the parameter changes
  (all parameters as one vector), port against JAX, is held to at most
  ``RATIO`` times the nudge's (the rule of ``test_torch_gluon.py``);
  ``fix_gamma``'s gamma, which the outputs do not reach, decays by the
  weight decay as in the JAX step;
* the same ResNet-20 with ``compute_dtype="bfloat16"``: the port's
  distance from the JAX float32 step, as that relative norm, is at most
  ``BF16_RATIO`` (1.5) times the JAX bf16 step's own distance from it,
  after 1 and after 3 steps; the moving statistics come back float32,
  and those of the BatchNorm over the (bf16) data within 1e-5 of the JAX
  bf16 step's (float32 statistics of the same bf16 values);
* ``run_steps`` equals k ``step`` calls (rtol 1e-5, atol 1e-6, the JAX
  package's own test of its scan) on a net with Dropout, for an int key
  (step i keyed ``fold_in(key, i)``) and for a ``torch.Generator``;
* ``init``'s shapes, types and initial values; a mesh axis above 1 and
  the default device without a card raise.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.models  # noqa: E402,F401
from mxnet_tpu.parallel.trainer import \
    make_train_step as jax_train_step  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from mxnet_tpu_torch.parallel import transformer as T  # noqa: E402
from mxnet_tpu_torch.parallel.trainer import (ShardedTrainer,  # noqa: E402
                                              fold_in)

MLP_TOL = 1e-4
RATIO = 4.0
BF16_RATIO = 1.5
NUDGE = 1e-6
RES = dict(lr=0.05, momentum=0.9, wd=1e-4)
RES_BATCH, RES_IMAGE, STEPS = 4, (3, 28, 28), 3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _mesh():
    return tmesh.make_mesh(devices=[tmx.cpu()])


def _resnet(mx):
    return mx.models.resnet(num_classes=10, num_layers=20,
                            image_shape=RES_IMAGE)


def _batches(shape, k, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(k, *shape).astype(np.float32)
    y = rng.randint(0, 10, (k, shape[0])).astype(np.float32)
    return x, y


def _jax_run(sym, init, aux, x, y, compute_dtype=None, **hyper):
    step, _ = jax_train_step(sym, compute_dtype=compute_dtype, **hyper)
    step = jax.jit(step)
    p = {k: jnp.asarray(v) for k, v in init.items()}
    m = {k: jnp.zeros_like(v) for k, v in p.items()}
    a = {k: jnp.asarray(v) for k, v in aux.items()}
    out = []
    for i in range(len(x)):
        p, m, a, loss = step(p, m, a, jnp.asarray(x[i]), jnp.asarray(y[i]),
                             jax.random.PRNGKey(0))
        out.append((float(loss), *({k: np.asarray(v) for k, v in d.items()}
                                   for d in (p, m, a))))
    return out


def _port_run(sym, init, aux, x, y, compute_dtype=None, nudge=0.0,
              **hyper):
    tr = ShardedTrainer(sym, _mesh(), compute_dtype=compute_dtype, **hyper)
    gen = torch.Generator().manual_seed(5)
    p = {k: torch.tensor(v) * (1 + nudge * torch.randn(v.shape,
                                                        generator=gen))
         for k, v in init.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    a = {k: torch.tensor(v) for k, v in aux.items()}
    out = []
    for i in range(len(x)):
        p, m, a, loss = tr.step(p, m, a, x[i], y[i])
        out.append((float(loss), *({k: v.numpy().copy() for k, v in d.items()}
                                   for d in (p, m, a))))
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _update_dist(a, b, init):
    """Relative norm of the difference of two runs' parameter changes,
    all parameters as one vector."""
    num = sum(float(np.sum(((a[k] - init[k]) - (b[k] - init[k])) ** 2))
              for k in b)
    den = sum(float(np.sum((b[k] - init[k]) ** 2)) for k in b)
    return float(np.sqrt(num / den))


@pytest.fixture(scope="module")
def resnet_init():
    tmx.random.seed(0)
    tr = ShardedTrainer(_resnet(tmx), _mesh(), **RES)
    p, _m, a = tr.init((RES_BATCH,) + RES_IMAGE, (RES_BATCH,))
    x, y = _batches((RES_BATCH,) + RES_IMAGE, STEPS, 0)
    return ({k: v.numpy().copy() for k, v in p.items()},
            {k: v.numpy().copy() for k, v in a.items()}, x, y)


@pytest.fixture(scope="module")
def resnet_runs(resnet_init):
    init, aux, x, y = resnet_init
    runs = {}
    for name, cdt in (("f32", None), ("bf16", "bfloat16")):
        runs["jax_" + name] = _jax_run(_resnet(jmx), init, aux, x, y, cdt,
                                       **RES)
        runs["port_" + name] = _port_run(_resnet(tmx), init, aux, x, y, cdt,
                                         **RES)
    runs["port_nudged"] = _port_run(_resnet(tmx), init, aux, x, y,
                                    nudge=NUDGE, **RES)
    return runs


def test_mlp_steps_match_jax():
    tmx.random.seed(1)
    tr = ShardedTrainer(tmx.models.mlp(), _mesh(), lr=0.1, momentum=0.9,
                        wd=1e-4)
    p, _m, a = tr.init((8, 784), (8,))
    init = {k: v.numpy().copy() for k, v in p.items()}
    x, y = _batches((8, 784), 3, 1)
    hyper = dict(lr=0.1, momentum=0.9, wd=1e-4)
    want = _jax_run(jmx.models.mlp(), init, {}, x, y, **hyper)
    got = _port_run(tmx.models.mlp(), init, {}, x, y, **hyper)
    for (lg, pg, mg, _), (lw, pw, mw, _) in zip(got, want):
        assert abs(lg - lw) <= 1e-5 * max(1.0, abs(lw))
        for k in pw:
            assert _rel(pg[k], pw[k]) <= MLP_TOL, k
            assert _rel(mg[k], mw[k]) <= MLP_TOL, k


def test_resnet_f32_steps_match_jax_by_ratio(resnet_init, resnet_runs):
    init, aux, _x, _y = resnet_init
    got, want = resnet_runs["port_f32"], resnet_runs["jax_f32"]
    nudged = resnet_runs["port_nudged"]
    assert abs(got[0][0] - want[0][0]) <= 1e-6 * max(1.0, abs(want[0][0]))
    for step in range(STEPS):
        err = _update_dist(got[step][1], want[step][1], init)
        floor = _update_dist(nudged[step][1], got[step][1], init)
        assert err <= RATIO * floor, (step, err, floor)
    for k, v in got[0][3].items():
        assert v.dtype == np.float32
        assert _rel(v, want[0][3][k]) <= 1e-5, k
    assert all(np.isfinite(v).all() for v in got[-1][1].values())


def test_fix_gamma_decays_with_weight_decay(resnet_init, resnet_runs):
    """``bn_data`` has ``fix_gamma``: its gamma gets a zero gradient, and
    the weight decay moves it, ``gamma * (1 - lr * wd)`` after one step
    from zero momenta, as in the JAX step."""
    init = resnet_init[0]
    got = resnet_runs["port_f32"][0][1]["bn_data_gamma"]
    want = resnet_runs["jax_f32"][0][1]["bn_data_gamma"]
    expect = init["bn_data_gamma"] * np.float32(1 - RES["lr"] * RES["wd"])
    assert not np.array_equal(got, init["bn_data_gamma"])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, expect, rtol=1e-6)


@pytest.mark.parametrize("step", [0, STEPS - 1], ids=["1_step", "3_steps"])
def test_resnet_bf16_step_within_jax_bf16_error(resnet_init, resnet_runs,
                                                step):
    init = resnet_init[0]
    ref = resnet_runs["jax_f32"][step][1]
    ours = _update_dist(resnet_runs["port_bf16"][step][1], ref, init)
    theirs = _update_dist(resnet_runs["jax_bf16"][step][1], ref, init)
    assert ours <= BF16_RATIO * theirs, (ours, theirs)
    aux = resnet_runs["port_bf16"][step][3]
    assert all(v.dtype == np.float32 and np.isfinite(v).all()
               for v in aux.values())
    if step == 0:
        want = resnet_runs["jax_bf16"][0][3]
        for k in ("bn_data_moving_mean", "bn_data_moving_var"):
            assert _rel(aux[k], want[k]) <= 1e-5, k


def _dropout_net(mx):
    x = mx.sym.Variable("data")
    x = mx.sym.FullyConnected(x, num_hidden=32, name="fc1")
    x = mx.sym.Activation(x, act_type="relu")
    x = mx.sym.Dropout(x, p=0.5)
    x = mx.sym.FullyConnected(x, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(x, name="softmax")


@pytest.mark.parametrize("keyed", ["int", "generator"])
def test_run_steps_equals_k_steps(keyed):
    k, batch = 3, 8
    tmx.random.seed(2)
    tr = ShardedTrainer(_dropout_net(tmx), _mesh(), lr=0.1, momentum=0.9,
                        wd=1e-4)
    p1, m1, a1 = tr.init((batch, 20), (batch,))
    p2, m2, a2 = ({n: t.clone() for n, t in d.items()} for d in (p1, m1, a1))
    x, y = _batches((batch, 20), k, 3)
    if keyed == "int":
        key1, keys2 = 7, [fold_in(7, i) for i in range(k)]
    else:
        key1 = torch.Generator().manual_seed(7)
        gen2 = torch.Generator().manual_seed(7)
        keys2 = [gen2] * k
    d, lab = tr.stage_many(x, y)
    p1, m1, a1, loss1 = tr.run_steps(p1, m1, a1, d, lab, key=key1)
    for i in range(k):
        p2, m2, a2, loss2 = tr.step(p2, m2, a2, x[i], y[i], key=keys2[i])
    assert abs(float(loss1) - float(loss2)) < 1e-6
    for n in p1:
        np.testing.assert_allclose(p1[n].numpy(), p2[n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
        np.testing.assert_allclose(m1[n].numpy(), m2[n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    # the draws differ from step to step: another key, another update
    p3, m3, a3 = tr.init((batch, 20), (batch,))
    for n, t in p3.items():
        t.copy_(p2[n])
    tr.run_steps(p3, m3, a3, d, lab, key=8 if keyed == "int" else
                 torch.Generator().manual_seed(8))


def test_init_shapes_types_and_aux_values():
    tmx.random.seed(3)
    sym = _resnet(tmx)
    tr = ShardedTrainer(sym, _mesh())
    p, m, a = tr.init((RES_BATCH,) + RES_IMAGE, (RES_BATCH,))
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=(RES_BATCH,) + RES_IMAGE, softmax_label=(RES_BATCH,))
    shape_of = dict(zip(sym.list_arguments(), arg_shapes))
    assert sorted(p) == sorted(n for n in sym.list_arguments()
                               if n not in ("data", "softmax_label"))
    for n, t in p.items():
        assert tuple(t.shape) == tuple(shape_of[n]) and \
            t.dtype == torch.float32 and t.device.type == "cpu"
        assert torch.equal(m[n], torch.zeros_like(t))
    assert p["conv0_weight"].abs().max() > 0
    assert torch.equal(p["bn_data_gamma"], torch.ones_like(
        p["bn_data_gamma"]))
    assert list(a) == sym.list_auxiliary_states()
    for (n, t), shp in zip(a.items(), aux_shapes):
        assert tuple(t.shape) == tuple(shp) and t.dtype == torch.float32
        assert float(t.min()) == float(t.max()) == (
            1.0 if n.endswith("_var") else 0.0)


def test_mesh_axis_above_one_raises_naming_its_item():
    two = [tmx.cpu(), tmx.cpu()]
    with pytest.raises(NotImplementedError, match="A13"):
        tmesh.make_mesh((2,), devices=two)
    with pytest.raises(NotImplementedError, match="A15"):
        tmesh.make_mesh((1, 2), ("dp", "tp"), devices=two)
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        tmesh.make_mesh((3,), devices=two)
    mesh = tmesh.make_mesh((1, 1, 1, 1, 1), T.AXES, devices=[tmx.cpu()])
    T._check_mesh(mesh)
    assert list(mesh.shape.items()) == [(ax, 1) for ax in T.AXES]
    tmesh.set_mesh(mesh)
    assert tmesh.current_mesh() is mesh
    tmesh.set_mesh(None)
    assert tmesh.mesh_process_count(mesh) == 1
    with pytest.raises(ValueError, match="accum batch needs shape"):
        tmesh.make_accum_batch_global(mesh, np.zeros(4))
    b = tmesh.make_accum_batch_global(mesh, np.ones((2, 3, 5), np.float32))
    assert tuple(b.shape) == (2, 3, 5) and b.device.type == "cpu"
    assert tmesh.data_parallel_sharding(mesh, ndim=3).spec == \
        ("dp", None, None)


def test_trainer_on_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(MXNetError, match="no CUDA device"):
        ShardedTrainer(tmx.models.mlp(), tmesh.make_mesh())
