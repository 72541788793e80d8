"""The port's ``lstm_bucketing`` CLI
(``mxnet_tpu_torch.examples.lstm_bucketing``) against the repo's JAX
``examples/lstm_bucketing.py``, both in-process on the CPU at a small
width.

Both CLIs train one epoch of the synthetic corpus (400 sentences of
4-16 tokens, buckets 8/16/24/32, batch 16) through ``BucketingModule``
from the same weights and the same ``random`` / ``np.random`` seeds (which
fix ``BucketSentenceIter``'s shuffles in both packages). The weights come
from the CLI's ``Xavier(factor_type="in", magnitude=2.34)``, whose draw is
patched in both packages to a numpy draw seeded by the parameter's name.
Held:

* every parameter after the epoch (its SGD steps at lr 0.5, momentum
  0.9, over buckets in shuffled order) within ``PARAM_TOL`` = 1e-4 of the largest
  magnitude of its JAX value, with the same names;
* the perplexity each package's module scores on the corpus, ignoring
  the padding, within 1e-4 relative;
* ``--gpus ""`` trains on the host; an unknown flag is refused.
"""
import importlib.util
import logging
import os
import random
import sys
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.examples import lstm_bucketing  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_TOL = 1e-4
FLAGS = ["--num-epochs", "1", "--num-hidden", "16", "--num-embed", "8",
         "--disp-batches", "10"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "_jax_lstm_bucketing", os.path.join(ROOT, "examples",
                                            "lstm_bucketing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeded_xavier(mx):
    def _init_weight(self, name, arr):
        rng = np.random.RandomState(zlib.crc32(str(name).encode()))
        value = rng.uniform(-0.2, 0.2, arr.shape).astype(np.float32)
        arr[:] = mx.nd.array(value, ctx=arr.context)
    return _init_weight


def _seed():
    random.seed(0)
    np.random.seed(0)


@pytest.fixture(scope="module")
def runs():
    """(JAX BucketingModule, port BucketingModule) after one epoch."""
    mp = pytest.MonkeyPatch()
    made = []
    real_init = jmx.mod.BucketingModule.__init__

    def record(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        made.append(self)

    mp.setattr(jmx.mod.BucketingModule, "__init__", record)
    for mx in (jmx, tmx):
        mp.setattr(mx.init.Xavier, "_init_weight", _seeded_xavier(mx))
    try:
        cli = _jax_cli()
        mp.setattr(sys, "argv", ["lstm_bucketing.py"] + FLAGS)
        _seed()
        cli.main()
        _seed()
        tmod = lstm_bucketing.main(["--gpus", ""] + FLAGS)
    finally:
        mp.undo()
    return made[0], tmod


def test_one_epoch_matches_jax(runs):
    jmod, tmod = runs
    jarg, jaux = jmod.get_params()
    targ, taux = tmod.get_params()
    assert sorted(targ) == sorted(jarg) and not jaux and not taux
    assert "lstm_l1_h2h_weight" in targ and "embed_weight" in targ
    worst = {}
    for k in jarg:
        want, got = jarg[k].asnumpy(), targ[k].asnumpy()
        assert want.shape == got.shape, k
        worst[k] = float(np.abs(got - want).max() / np.abs(want).max())
    assert max(worst.values()) <= PARAM_TOL, worst


def _perplexity(mx, mod):
    sents, _ = lstm_bucketing.synthetic_corpus()
    _seed()
    it = mx.rnn.BucketSentenceIter(sents, 16, buckets=[8, 16, 24, 32],
                                   invalid_label=-1)
    return dict(mod.score(it, mx.metric.Perplexity(ignore_label=-1)))[
        "perplexity"]


def test_scored_perplexity_matches_jax(runs):
    jmod, tmod = runs
    want, got = _perplexity(jmx, jmod), _perplexity(tmx, tmod)
    assert np.isfinite(got) and 1.0 < got < 31.0
    assert abs(got - want) <= 1e-4 * want


def test_cli_flags(caplog):
    """``--gpus ""`` trains on the host and logs the Speedometer and the
    epoch's perplexity; argparse refuses an unknown flag."""
    with caplog.at_level(logging.INFO):
        mod = lstm_bucketing.main(["--gpus", "", "--num-epochs", "1",
                                   "--num-hidden", "8", "--num-embed", "4",
                                   "--buckets", "8,16",
                                   "--disp-batches", "5"])
    text = caplog.text
    assert "Train-perplexity" in text and "samples/sec" in text
    arg, _ = mod.get_params()
    assert arg["pred_weight"].context.type == "cpu"
    assert sorted(mod._buckets) == [8, 16]
    with pytest.raises(SystemExit):
        lstm_bucketing.main(["--no-such-flag"])
