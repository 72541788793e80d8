"""The port's checkpoints and its north-star CLI
(``mxnet_tpu_torch.examples.train_imagenet``) against the JAX package's.

* A JAX ``Module.save_checkpoint(..., save_optimizer_states=True)`` of a
  small ResNet (8 layers, 3x16x16, 10 classes) loads in the port with
  its optimizer states (``Module.load(..., load_optimizer_states=True)``),
  and the next epoch of ``fit`` in each package ends within 1e-4 of each
  tensor's largest value; the reverse holds too (the port saves, the JAX
  package loads). Without the states the epoch ends elsewhere, so the
  states carried.
* ``fit(resume=True)`` is bitwise equal to an uninterrupted run (an
  unshuffled ``NDArrayIter``): from an epoch boundary, from a save made
  within an epoch (the batches it had trained replayed), and past a
  corrupt newest checkpoint, which is skipped.
* An optimizer-state file that pickles the JAX optimizer object
  (``dump_optimizer=True``) is refused without importing the JAX
  package.
* The CLI: the port's and the JAX package's, both started from one JAX
  checkpoint with ``--load-epoch 0`` on the same small ``.rec``, end
  within 1e-4; ``--gpus ""`` trains on the host, the default wants the
  card, and what is not ported raises naming its ROADMAP item.
"""
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.models  # noqa: E402,F401

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.examples import train_imagenet  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
X = np.random.RandomState(0).uniform(-1, 1, (12, 3, 16, 16)).astype(
    np.float32)
Y = np.random.RandomState(1).randint(0, 10, (12,)).astype(np.float32)
OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
PARAM_TOL = 1e-4


def _symbol(mx):
    return mx.models.resnet(num_classes=10, num_layers=8,
                            image_shape=(3, 16, 16), bottle_neck=True)


def _iter(mx):
    return mx.io.NDArrayIter(X, Y, batch_size=BATCH)


def _numpy(params):
    arg, aux = params
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _close(got, want, tol=PARAM_TOL):
    worst = 0.0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            err = np.abs(g[k] - w[k]).max() / max(np.abs(w[k]).max(), 1e-6)
            worst = max(worst, float(err))
    assert worst <= tol, worst
    return worst


def _jax_epoch1(prefix):
    jmx.random.seed(0)
    mod = jmx.mod.Module(_symbol(jmx), context=jmx.cpu())
    mod.fit(_iter(jmx), num_epoch=1, optimizer="sgd", optimizer_params=OPT,
            initializer=jmx.init.Xavier(rnd_type="gaussian",
                                        factor_type="in", magnitude=2))
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)


def _jax_next_epoch(prefix, states=True):
    mod = jmx.mod.Module.load(prefix, 1, load_optimizer_states=states,
                              context=jmx.cpu())
    mod.fit(_iter(jmx), begin_epoch=1, num_epoch=2, optimizer="sgd",
            optimizer_params=OPT)
    return _numpy(mod.get_params())


def _port_next_epoch(prefix, states=True):
    mod = tmx.mod.Module.load(prefix, 1, load_optimizer_states=states,
                              context=tmx.cpu())
    mod.fit(_iter(tmx), begin_epoch=1, num_epoch=2, optimizer="sgd",
            optimizer_params=OPT)
    return _numpy(mod.get_params())


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX checkpoint after one epoch, and the JAX package's second
    epoch from it."""
    prefix = str(tmp_path_factory.mktemp("jck") / "r8")
    _jax_epoch1(prefix)
    return prefix, _jax_next_epoch(prefix)


def test_jax_checkpoint_resumes_in_port(jax_ckpt):
    prefix, want = jax_ckpt
    assert os.path.exists(prefix + "-0001.states")
    got = _port_next_epoch(prefix)
    _close(got, want)
    # the momentum states carried: without them the epoch ends elsewhere
    with pytest.raises(AssertionError):
        _close(_port_next_epoch(prefix, states=False), want)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    prefix = str(tmp_path / "r8")
    tmx.random.seed(0)
    mod = tmx.mod.Module(_symbol(tmx), context=tmx.cpu())
    mod.fit(_iter(tmx), num_epoch=1, optimizer="sgd", optimizer_params=OPT,
            initializer=tmx.init.Xavier(rnd_type="gaussian",
                                        factor_type="in", magnitude=2))
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    tck = tmx.checkpoint.verify_checkpoint(prefix, 1)
    jck = jmx.checkpoint.verify_checkpoint(prefix, 1)
    assert tck["has_optimizer_states"] and jck["has_optimizer_states"]
    _close(_port_next_epoch(prefix), _jax_next_epoch(prefix))


def _fit(prefix=None, num_epoch=3, resume=False, callback=None):
    mod = tmx.mod.Module(_symbol(tmx), context=tmx.cpu())
    tmx.random.seed(0)
    mod.fit(_iter(tmx), num_epoch=num_epoch, optimizer="sgd",
            optimizer_params=OPT,
            initializer=tmx.init.Xavier(rnd_type="gaussian",
                                        factor_type="in", magnitude=2),
            checkpoint_prefix=prefix, resume=resume,
            batch_end_callback=callback)
    return mod


@pytest.fixture(scope="module")
def uninterrupted():
    mod = _fit()
    return _numpy(mod.get_params()), mod._updater.get_states()


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_resume_at_an_epoch_boundary_is_bitwise(tmp_path, uninterrupted):
    prefix = str(tmp_path / "ck" / "r8")
    os.makedirs(os.path.dirname(prefix))
    _fit(prefix, num_epoch=2)
    assert tmx.checkpoint.list_checkpoints(prefix) == [1, 2]
    mod = _fit(prefix, num_epoch=3, resume=True)
    _bitwise(_numpy(mod.get_params()), uninterrupted[0])
    assert mod._updater.get_states() == uninterrupted[1]
    assert tmx.checkpoint.list_checkpoints(prefix) == [1, 2, 3]


class _Stop(Exception):
    pass


def test_resume_within_an_epoch_replays_and_is_bitwise(tmp_path,
                                                       uninterrupted):
    prefix = str(tmp_path / "r8")

    def save_and_stop(param):
        # after the second batch of the third epoch: a save within it
        if param.epoch == 2 and param.nbatch == 1:
            param.locals["self"].save_checkpoint(prefix, 2, True, nbatch=2)
            raise _Stop()

    with pytest.raises(_Stop):
        _fit(prefix, callback=save_and_stop)
    assert tmx.checkpoint.verify_checkpoint(prefix, 2)["nbatch"] == 2
    mod = _fit(prefix, resume=True)
    _bitwise(_numpy(mod.get_params()), uninterrupted[0])


def test_resume_skips_a_corrupt_newest_checkpoint(tmp_path, uninterrupted):
    prefix = str(tmp_path / "r8")
    _fit(prefix, num_epoch=3)
    with open(prefix + "-0003.params", "r+b") as f:
        f.truncate(100)
    mod = _fit(prefix, resume=True)           # from epoch 2, trains the 3rd
    _bitwise(_numpy(mod.get_params()), uninterrupted[0])
    with pytest.raises(MXNetError, match="checkpoint_prefix"):
        _fit(resume=True)
    with pytest.raises(MXNetError, match="checkpoint_period"):
        tmx.mod.Module(_symbol(tmx), context=tmx.cpu()).fit(
            _iter(tmx), num_epoch=1, checkpoint_prefix=prefix,
            checkpoint_period=0)


def test_optimizer_state_files_both_ways_and_refusals(tmp_path):
    prefix = str(tmp_path / "r8")
    _jax_epoch1(prefix)
    with open(prefix + "-0001.states", "rb") as f:
        jax_bytes = f.read()
    upd = tmx.optimizer.get_updater(tmx.optimizer.create("sgd",
                                                         momentum=0.9))
    upd.set_states(jax_bytes)
    # the port writes back the JAX package's bytes
    assert {k: np.asarray(v) for k, v in pickle.loads(
        upd.get_states()).items()}.keys() == pickle.loads(jax_bytes).keys()
    for k, v in pickle.loads(jax_bytes).items():
        np.testing.assert_array_equal(pickle.loads(upd.get_states())[k], v)
    jupd = jmx.optimizer.get_updater(jmx.optimizer.create("sgd",
                                                          momentum=0.9))
    jupd.set_states(jax_bytes)
    dumped = jupd.get_states(dump_optimizer=True)
    with pytest.raises(MXNetError, match="dump_optimizer"):
        upd.set_states(dumped)
    with pytest.raises(MXNetError, match="dump_optimizer"):
        upd.get_states(dump_optimizer=True)
    assert "mxnet_tpu" not in [m.split(".")[0] for m in sys.modules
                               if m.startswith("mxnet_tpu_torch.")]


def _write_rec(path, n=32, seed=0):
    from mxnet_tpu_torch import recordio
    rng = np.random.RandomState(seed)
    w = recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                   path, "w")
    for i in range(n):
        im = rng.randint(0, 255, (40, 44, 3), dtype=np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(
            0, float(i % 10), i, 0), im))
    w.close()


def test_cli_matches_jax_cli_from_one_checkpoint(tmp_path):
    rec = str(tmp_path / "train.rec")
    _write_rec(rec)
    # one JAX checkpoint (epoch 0), copied for each CLI to continue
    sym = jmx.models.mlp(num_classes=10)
    mod = jmx.mod.Module(sym, context=jmx.cpu())
    mod.bind(data_shapes=[("data", (8, 3, 32, 32))],
             label_shapes=[("softmax_label", (8,))])
    jmx.random.seed(3)
    mod.init_params(jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    for side in ("jax", "port"):
        os.makedirs(str(tmp_path / side))
        mod.save_checkpoint(str(tmp_path / side / "m"), 0)
    common = ["--network", "mlp", "--image-shape", "3,32,32",
              "--num-classes", "10", "--num-examples", "32",
              "--batch-size", "8", "--num-epochs", "1", "--kv-store",
              "local", "--data-train", rec, "--random-crop", "1",
              "--random-mirror", "1", "--load-epoch", "0"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "train_imagenet.py")]
        + common + ["--model-prefix", str(tmp_path / "jax" / "m")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    train_imagenet.main(common + ["--gpus", "", "--model-prefix",
                                  str(tmp_path / "port" / "m")])
    _, ja, jx = jmx.model.load_checkpoint(str(tmp_path / "jax" / "m"), 1)
    _, ta, tx = tmx.model.load_checkpoint(str(tmp_path / "port" / "m"), 1)
    start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    moved = max(np.abs(ta[k].asnumpy() - start[k]).max() for k in start)
    assert moved > 1e-3                     # the epoch trained
    _close(_numpy((ta, tx)), _numpy((ja, jx)))


def test_cli_devices_and_refusals(tmp_path):
    synth = ["--network", "mlp", "--benchmark", "1", "--image-shape",
             "3,8,8", "--num-classes", "10", "--num-examples", "32",
             "--batch-size", "8", "--num-epochs", "1"]
    mod = train_imagenet.main(synth + ["--gpus", ""])
    assert mod._context[0].type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            train_imagenet.main(synth)
    for extra, tag in ((["--gpus", "0,1"], "A8.3"),
                       (["--gpus", "", "--kv-store", "dist_sync"], "A13"),
                       (["--gpus", "", "--monitor", "1"], "A8.6"),
                       (["--gpus", "", "--network", "vgg"], "A8.8")):
        with pytest.raises(NotImplementedError, match=tag):
            train_imagenet.main(synth + extra)
    prefix = str(tmp_path / "ck" / "m")
    train_imagenet.main(synth + ["--gpus", "", "--model-prefix", prefix,
                                 "--num-epochs", "2", "--save-period", "2"])
    assert tmx.checkpoint.list_checkpoints(prefix) == [2]
    man = tmx.checkpoint.verify_checkpoint(prefix, 2)
    assert man["has_optimizer_states"]
    shutil.rmtree(str(tmp_path / "ck"))
