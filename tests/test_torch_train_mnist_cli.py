"""The port's ``train_mnist`` CLI (``mxnet_tpu_torch.examples.train_mnist``)
against the repo's JAX ``examples/train_mnist.py``, both in-process on
the CPU.

Both CLIs train one epoch on the same seeded synthetic set from the
same weights and the same ``np.random`` seed (which fixes
``NDArrayIter``'s shuffle in both packages). The weights come from
``Module.fit``'s default ``Uniform(0.01)``, whose draw is patched in
both packages to a numpy draw seeded by the parameter's name, since the
packages' generators differ. Held, for MLP and LeNet:

* every parameter of the ``--model-prefix`` checkpoints within
  ``PARAM_TOL`` = 1e-4 of the largest magnitude of its JAX value (lr 0.3
  with momentum 0.9 over 19 steps; float32 sums in other orders); for
  LeNet within the larger of ``PARAM_TOL`` and ``RATIO`` = 4 times the
  port's own float32 error, the distance of its epoch from the same
  epoch started from weights nudged by ``NUDGE`` = 1e-6 (the rule of
  ``test_torch_models_cli.py``): with one torch thread LeNet's epoch
  moves a tensor by 2.56e-4 under that nudge, as far as the packages
  differ (2.56e-4), and with 3 or 8 threads both are below 1e-5;
* each checkpoint loads in the other package with the same arrays, and
  the port's ``Module`` on the JAX checkpoint predicts within 1e-5 of
  the JAX ``Module`` on it;
* both score the same validation accuracy, and ``--gpus ""`` prints
  the final accuracy line.
"""
import importlib.util
import os
import sys
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.examples import train_mnist  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = 1200         # 19 batches of 64 a epoch, 200 validation images
PARAM_TOL = 1e-4
PRED_TOL = 1e-5
NUDGE = 1e-6
RATIO = 4.0


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "_jax_train_mnist", os.path.join(ROOT, "examples", "train_mnist.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeded_uniform(mx, nudge=0.0):
    """``Uniform._init_weight`` as a numpy draw seeded by the name;
    with ``nudge`` each value scaled by ``1 + nudge * N(0, 1)``."""
    def _init_weight(self, name, arr):
        seed = zlib.crc32(str(name).encode())
        value = np.random.RandomState(seed).uniform(
            -self.scale, self.scale, arr.shape)
        if nudge:
            value = value * (1 + nudge * np.random.RandomState(seed + 1)
                             .randn(*value.shape))
        arr[:] = mx.nd.array(value.astype(np.float32), ctx=arr.context)
    return _init_weight


def _params(mx, prefix):
    sym, arg, aux = mx.model.load_checkpoint(prefix, 1)
    return sym, {k: v.asnumpy() for k, v in arg.items()}, \
        {k: v.asnumpy() for k, v in aux.items()}


def _scorer(mx, prefix, shape):
    mod = mx.mod.Module.load(prefix, 1, context=mx.cpu())
    mod.bind(data_shapes=[("data", (64,) + shape[1:])],
             label_shapes=[("softmax_label", (64,))], for_training=False)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For each network: the JAX CLI's and the port's checkpoint prefix
    after one epoch, the port's trained ``Module``, and for LeNet the
    prefix of the port's epoch from weights nudged by ``NUDGE``."""
    from mxnet_tpu.symbol.symbol import _name_mgr as jnames
    from mxnet_tpu_torch.symbol.symbol import _name_mgr as tnames
    mp = pytest.MonkeyPatch()
    mp.setattr(jmx.init.Uniform, "_init_weight", _seeded_uniform(jmx))
    cli = _jax_cli()
    out = {}
    try:
        for net in ("mlp", "lenet"):
            d = tmp_path_factory.mktemp(net)
            flags = ["--network", net, "--num-epochs", "1",
                     "--num-examples", str(EXAMPLES)]
            jprefix, tprefix = str(d / "jax"), str(d / "port")
            mp.setattr(sys, "argv", ["train_mnist.py"] + flags
                       + ["--model-prefix", jprefix])
            # every run names its layers from 0 (``convolution0_weight``),
            # whatever other tests named before, so that the draw seeded
            # by the name starts each run from the same weights
            mp.setattr(jnames, "_counter", {})
            np.random.seed(0)
            cli.main()
            mp.setattr(tnames, "_counter", {})
            mp.setattr(tmx.init.Uniform, "_init_weight",
                       _seeded_uniform(tmx))
            np.random.seed(0)
            tmod = train_mnist.main(["--gpus", ""] + flags
                                    + ["--model-prefix", tprefix])
            nprefix = None
            if net == "lenet":
                nprefix = str(d / "nudged")
                mp.setattr(tnames, "_counter", {})
                mp.setattr(tmx.init.Uniform, "_init_weight",
                           _seeded_uniform(tmx, NUDGE))
                np.random.seed(0)
                train_mnist.main(["--gpus", ""] + flags
                                 + ["--model-prefix", nprefix])
            out[net] = (jprefix, tprefix, tmod, nprefix)
    finally:
        mp.undo()
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("net", ["mlp", "lenet"])
def test_one_epoch_matches_jax(runs, net):
    jprefix, tprefix, _, nprefix = runs[net]
    jsym, jarg, jaux = _params(jmx, jprefix)
    tsym, targ, taux = _params(tmx, tprefix)
    nudged = _params(tmx, nprefix)[1] if nprefix else None
    # auto-named layers count from each package's own name manager: match
    # the parameters by their place in the symbol
    jnames, tnames = jsym.list_arguments(), tsym.list_arguments()
    assert len(jnames) == len(tnames)
    assert not jaux and not taux
    over = {}
    for jn, tn in zip(jnames, tnames):
        if jn in ("data", "softmax_label"):
            continue
        want, got = jarg[jn], targ[tn]
        assert want.shape == got.shape, jn
        err = _rel(got, want)
        bound = PARAM_TOL
        if nudged is not None:
            bound = max(PARAM_TOL, RATIO * _rel(nudged[tn], got))
        if err > bound:
            over[tn] = (err, bound)
    assert not over, over


@pytest.mark.parametrize("net", ["mlp", "lenet"])
def test_checkpoints_load_in_the_other_package(runs, net):
    jprefix, tprefix, _, _ = runs[net]
    for prefix in (jprefix, tprefix):
        _, ja, _ = _params(jmx, prefix)
        _, ta, _ = _params(tmx, prefix)
        assert sorted(ja) == sorted(ta)
        for k in ja:
            np.testing.assert_array_equal(ta[k], ja[k])
    x, _ = train_mnist.synthetic_mnist(64, seed=3)
    preds = []
    for mx in (jmx, tmx):
        mod = mx.mod.Module.load(jprefix, 1, context=mx.cpu())
        mod.bind(data_shapes=[("data", x.shape)], for_training=False)
        preds.append(mod.predict(mx.io.NDArrayIter(x, batch_size=64))
                     .asnumpy())
    assert np.abs(preds[1] - preds[0]).max() <= PRED_TOL


@pytest.mark.parametrize("net", ["mlp", "lenet"])
def test_validation_accuracy_matches_jax(runs, net):
    """Each package scores its own checkpoint on the validation set: the
    same accuracy (200 images; one flipped argmax would show)."""
    jprefix, tprefix, tmod, _ = runs[net]
    xv, yv = train_mnist.synthetic_mnist(EXAMPLES // 6, seed=1)
    accs = []
    for mx, mod in ((jmx, _scorer(jmx, jprefix, xv.shape)), (tmx, tmod)):
        accs.append(dict(mod.score(mx.io.NDArrayIter(xv, yv, batch_size=64),
                                   "acc"))["accuracy"])
    assert accs[1] == accs[0]


def test_cli_flags(capsys):
    """``--gpus ""`` trains on the host and prints the final accuracy;
    an unknown network is refused by argparse."""
    mod = train_mnist.main(["--gpus", "", "--num-epochs", "1",
                            "--num-examples", "384"])
    assert "final validation accuracy" in capsys.readouterr().out
    assert mod.get_params()[0]["fc1_weight"].context.type == "cpu"
    with pytest.raises(SystemExit):
        train_mnist.main(["--network", "resnet"])
