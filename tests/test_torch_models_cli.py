"""The CLI's other networks (AlexNet, VGG, MobileNet, Inception-BN)
against the JAX package's, on the CPU.

* Each builder gives the JAX builder's graph: the same arguments,
  auxiliary states and outputs, and the same inferred shapes; with
  ``dtype="float16"`` too (the same nodes, arguments, outputs and
  shapes), which both packages accept and build the same float32 graph
  for.
* Two ``Module.fit`` steps of each network (10 classes, VGG 11, batch 2
  at 64 x 64, MobileNet at 96 x 96, SGD with momentum and weight decay) from the JAX
  package's initialization, each step held from the JAX package's own
  starting weights and moving statistics (the second step starts from
  the JAX package's first, with the port's momentum): each tensor's
  update agrees with the JAX package's within 1e-4 relative RMS, or,
  where the network is ill-conditioned in float32, within RATIO times
  the port's own float32 error, the difference the step makes when
  every starting weight is nudged by NUDGE (a few ulps): the rule of
  ``test_torch_gluon.py::test_trainer_steps_match_jax``, tensor by
  tensor. BatchNorm over few values a channel (2 x 3 x 3 at MobileNet's
  end) amplifies float32 rounding that much: a nudge of 1e-6 moves some
  of MobileNet's updates by tens of percent. Chained steps are not compared: after one step
  the two packages' weights differ by float32 rounding, and in AlexNet
  that moves a ReLU unit across its kink in the second step (the
  second step's gradients agree within 1e-6 from equal weights). The
  moving statistics agree within 1e-4. A planted fault (LRN without its
  ``1 / nsize``, the fault phase 28 of ``chip_smoke.py`` plants on the
  card) fails the rule. AlexNet and VGG are run
  with every Dropout's ``p`` set to 0 in the symbol's JSON, which both
  packages load: their masks differ by design (``test_torch_dropout.py``
  holds Dropout at ``p > 0`` to its definition).
* The port's CLI and the JAX CLI, both started from one JAX checkpoint
  (``--load-epoch 0``) on the same small ``.rec``, end within the same
  rule (weights and moving statistics, the float32 error from the
  port's CLI started from the nudged checkpoint) for MobileNet and
  Inception-BN, the two networks without Dropout, whose CLI runs draw
  nothing.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.models  # noqa: E402,F401

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.convert import (module_params_from_numpy,  # noqa: E402
                                     module_params_to_numpy)
from mxnet_tpu_torch.examples import train_imagenet  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 2
NETS = {"alexnet": {}, "vgg": {"num_layers": 11}, "mobilenet": {},
        "inception_bn": {}}
# MobileNet at 96: at 64 its last BatchNorms see 2 x 2 x 2 values a
# channel, and one nudge no longer measures its float32 error
SIDE = {"alexnet": 64, "vgg": 64, "mobilenet": 96, "inception_bn": 64}
OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
PARAM_TOL = 1e-4
RATIO = 4.0
NUDGE = 1e-6


def _symbol(mx, net):
    sym = getattr(mx.models, net)(num_classes=10, **NETS[net])
    graph = json.loads(sym.tojson())
    for node in graph["nodes"]:
        if node["op"] == "Dropout":
            node["attrs"]["p"] = 0.0
    return mx.sym.load_json(json.dumps(graph))


@pytest.mark.parametrize("net", sorted(NETS))
def test_builder_matches_jax(net):
    j = getattr(jmx.models, net)(num_classes=10, **NETS[net])
    t = getattr(tmx.models, net)(num_classes=10, **NETS[net])
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    shape = (BATCH, 3, SIDE[net], SIDE[net])
    assert t.infer_shape(data=shape) == j.infer_shape(data=shape)
    t16 = getattr(tmx.models, net)(num_classes=10, dtype="float16",
                                   **NETS[net])
    j16 = getattr(jmx.models, net)(num_classes=10, dtype="float16",
                                   **NETS[net])
    for a, b in ((t16, j16), (t16, t)):
        assert a.list_arguments() == b.list_arguments()
        assert a.list_auxiliary_states() == b.list_auxiliary_states()
        assert a.list_outputs() == b.list_outputs()
        assert [n["op"] for n in json.loads(a.tojson())["nodes"]] == [
            n["op"] for n in json.loads(b.tojson())["nodes"]]
    assert t16.infer_shape(data=shape) == j16.infer_shape(data=shape)


def _data(net):
    rng = np.random.RandomState(0)
    side = SIDE[net]
    return (rng.uniform(-1, 1, (2 * BATCH, 3, side, side)).astype(
        np.float32), rng.randint(0, 10, (2 * BATCH,)).astype(np.float32))


def _init(net):
    mod = jmx.mod.Module(_symbol(jmx, net), context=jmx.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 3, SIDE[net], SIDE[net]))],
             label_shapes=[("softmax_label", (BATCH,))])
    jmx.random.seed(0)
    mod.init_params(jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _steps(mx, net, starts, nudge=0.0):
    """``Module.fit`` over batch ``i`` from ``starts[i]`` (arg, aux; None
    goes on from the step before) for each ``i``, in one Module (its
    optimizer state carried from step to step), every starting weight
    scaled by ``1 + nudge * N(0, 1)``; the (arg, aux) after each step, as
    numpy."""
    x, y = _data(net)
    mod = mx.mod.Module(_symbol(mx, net), context=mx.cpu())
    rng = np.random.RandomState(5)
    out = []
    arg = aux = None
    for i, start in enumerate(starts):
        if start is not None:
            arg = {k: v * (1 + nudge * rng.randn(*v.shape)).astype(v.dtype)
                   for k, v in start[0].items()}
            aux = start[1]
            if mx is tmx:
                arg, aux = module_params_from_numpy(arg, aux, device="cpu")
            else:
                arg = {k: jmx.nd.array(v) for k, v in arg.items()}
                aux = {k: jmx.nd.array(v) for k, v in aux.items()}
            if i:
                mod.set_params(arg, aux)
        batch = slice(i * BATCH, (i + 1) * BATCH)
        mod.fit(mx.io.NDArrayIter(x[batch], y[batch], batch_size=BATCH),
                num_epoch=1, optimizer="sgd", optimizer_params=dict(OPT),
                arg_params=arg, aux_params=aux)
        a, b = mod.get_params()
        out.append(({k: v.asnumpy() for k, v in a.items()},
                    {k: v.asnumpy() for k, v in b.items()}))
    return out


def _update_errors(got, want, start):
    """Per tensor, the relative RMS error of ``got``'s change from
    ``start`` against ``want``'s."""
    assert sorted(got) == sorted(want)
    errs = {}
    for k in want:
        w, g = want[k] - start[k], got[k] - start[k]
        den = np.linalg.norm(w)
        errs[k] = float(np.linalg.norm(g - w) / den) if den > 0 \
            else float(np.linalg.norm(g - w))
    return errs


def _bad(errs, floors):
    """The tensors whose error is above both PARAM_TOL and RATIO times
    their float32 error."""
    return {k: (e, floors[k]) for k, e in errs.items()
            if e > max(PARAM_TOL, RATIO * floors[k])}


def _planted_lrn(monkeypatch):
    """LRN without its 1 / nsize divisor."""
    import functools
    op = tmx.ops.registry.get_op("LRN")
    real = op.fn

    @functools.wraps(real)
    def fn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
        return real(data, alpha=alpha * nsize, beta=beta, knorm=knorm,
                    nsize=nsize)
    monkeypatch.setattr(op, "fn", fn)


@pytest.mark.parametrize("net", sorted(NETS))
def test_two_fit_steps_match_jax(net, monkeypatch):
    init = _init(net)
    want = _steps(jmx, net, [init, None])
    starts = [init, want[0]]
    got = _steps(tmx, net, starts)
    nudged = _steps(tmx, net, starts, nudge=NUDGE)
    floors = []
    for step, start in enumerate(starts):
        floors.append(_update_errors(nudged[step][0], got[step][0],
                                     start[0]))
        errs = _update_errors(got[step][0], want[step][0], start[0])
        assert not _bad(errs, floors[-1]), (step, _bad(errs, floors[-1]))
        assert max(np.abs(want[step][0][k] - start[0][k]).max()
                   for k in errs) > 1e-4          # the step trained
        for k in want[step][1]:
            np.testing.assert_allclose(got[step][1][k], want[step][1][k],
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    if net == "alexnet":
        _planted_lrn(monkeypatch)
        bad = _steps(tmx, net, starts)
        assert any(_bad(_update_errors(b[0], w[0], s[0]), f)
                   for b, w, s, f in zip(bad, want, starts, floors))


def _write_rec(path, n=16, seed=0):
    from mxnet_tpu_torch import recordio
    rng = np.random.RandomState(seed)
    w = recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                   path, "w")
    for i in range(n):
        im = rng.randint(0, 255, (40, 44, 3), dtype=np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(
            0, float(i % 10), i, 0), im))
    w.close()


@pytest.mark.parametrize("net", ["mobilenet", "inception-bn"])
def test_cli_matches_jax_cli_from_one_checkpoint(tmp_path, net):
    """One epoch of two batches; the port's float32 error is that of its
    own CLI started from the checkpoint nudged by NUDGE."""
    rec = str(tmp_path / "train.rec")
    _write_rec(rec)
    sym = train_imagenet.get_network(train_imagenet.parse_args(
        ["--network", net, "--num-classes", "10"]))
    jsym = jmx.sym.load_json(sym.tojson())
    mod = jmx.mod.Module(jsym, context=jmx.cpu())
    mod.bind(data_shapes=[("data", (8, 3, 32, 32))],
             label_shapes=[("softmax_label", (8,))])
    jmx.random.seed(3)
    mod.init_params(jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    for side in ("jax", "port", "nudged"):
        os.makedirs(str(tmp_path / side))
        mod.save_checkpoint(str(tmp_path / side / "m"), 0)
    rng = np.random.RandomState(5)
    nsym, narg, naux = tmx.model.load_checkpoint(
        str(tmp_path / "nudged" / "m"), 0)
    for v in narg.values():
        v[:] = v.asnumpy() * (1 + NUDGE * rng.randn(*v.shape)).astype(
            np.float32)
    tmx.model.save_checkpoint(str(tmp_path / "nudged" / "m"), 0, nsym,
                              narg, naux)
    common = ["--network", net, "--image-shape", "3,32,32",
              "--num-classes", "10", "--num-examples", "16",
              "--batch-size", "8", "--num-epochs", "1", "--kv-store",
              "local", "--data-train", rec, "--random-mirror", "1",
              "--load-epoch", "0", "--lr", "0.01"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "train_imagenet.py")]
        + common + ["--model-prefix", str(tmp_path / "jax" / "m")],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    got = {}
    for side in ("port", "nudged"):
        train_imagenet.main(common + ["--gpus", "", "--model-prefix",
                                      str(tmp_path / side / "m")])
        _, ta, tx = tmx.model.load_checkpoint(str(tmp_path / side / "m"), 1)
        got[side] = module_params_to_numpy(ta, tx)
    _, ja, jx = jmx.model.load_checkpoint(str(tmp_path / "jax" / "m"), 1)
    for i, (start, want) in enumerate(((mod.get_params()[0], ja),
                                       (mod.get_params()[1], jx))):
        start = {k: v.asnumpy() for k, v in start.items()}
        want = {k: v.asnumpy() for k, v in want.items()}
        floors = _update_errors(got["nudged"][i], got["port"][i], start)
        errs = _update_errors(got["port"][i], want, start)
        assert not _bad(errs, floors), _bad(errs, floors)
        assert max(np.abs(want[k] - start[k]).max() for k in start) > 1e-4


def test_unknown_network_raises_the_jax_clis_error():
    args = train_imagenet.parse_args(["--network", "googlenet"])
    with pytest.raises(ValueError, match="unknown --network 'googlenet'"):
        train_imagenet.get_network(args)
    for spelling in ("inception-bn", "inception_bn"):
        args = train_imagenet.parse_args(["--network", spelling,
                                          "--num-classes", "10"])
        assert train_imagenet.get_network(args).list_arguments() == \
            tmx.models.inception_bn(num_classes=10).list_arguments()
