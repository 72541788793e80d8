"""The port's ``serving.Predictor`` and ``serve.InferenceEngine`` on the
CPU.

The model is an int8 artifact of a small MLP (``quantize_checkpoint`` of
a seeded checkpoint): its int8 products are exact, so a row's output
does not depend on the batch it rides in, and the engine's answers must
equal, bitwise, a direct ``Predictor`` forward of the same rows, whatever
bucket and padding the batcher chose. Also held: the bucket ladder and
its config, admission control (full queue, closed engine, bad feeds),
deadlines (counted once), drain on close, worker restarts, warmup of
every bucket, and ``Predictor.reshape`` sharing the weights but never
the inputs. As in the JAX package's tests/test_serve.py, without the
tracing, fault-point, health and program-registry hooks, which are not
ported yet.
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import telemetry as tm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import (DeadlineExceededError, EngineClosedError,
                                   InferenceEngine, QueueFullError,
                                   ServeConfig, parse_buckets,
                                   validate_buckets)

IN = 12
X = np.random.RandomState(8).randn(40, IN).astype(np.float32)


def _mlp():
    data = tmx.sym.Variable("data")
    fc1 = tmx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = tmx.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = tmx.sym.FullyConnected(act, num_hidden=5, name="fc2")
    return tmx.sym.SoftmaxOutput(fc2, name="softmax")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    rng = np.random.RandomState(0)
    params = {"fc1_weight": rng.randn(16, IN).astype(np.float32) * 0.3,
              "fc1_bias": rng.randn(16).astype(np.float32) * 0.1,
              "fc2_weight": rng.randn(5, 16).astype(np.float32) * 0.3,
              "fc2_bias": rng.randn(5).astype(np.float32) * 0.1}
    prefix = str(tmp_path_factory.mktemp("s") / "mlp")
    tmx.model.save_checkpoint(prefix, 0, _mlp(), {
        k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in params.items()}, {})
    qp = tmx.quantize.quantize_checkpoint(prefix, [X[:16], X[16:32]],
                                          calib_mode="naive", ctx=tmx.cpu())
    assert sorted(qp.meta) == ["fc1", "fc2"]
    return qp


def _pred(qp, rows=1):
    return tmx.serving.Predictor(qp.symbol_json, qp.param_bytes(),
                                 dev_type=1,
                                 input_shapes={"data": (rows, IN)})


def _direct(qp, rows):
    pred = _pred(qp, len(rows))
    pred.set_input("data", np.ascontiguousarray(rows).tobytes())
    pred.forward()
    return np.frombuffer(pred.get_output(0), np.float32).reshape(
        pred.get_output_shape(0))


def _engine(qp, **cfg):
    cfg.setdefault("max_batch", 8)
    cfg.setdefault("batch_wait_ms", 5)
    return InferenceEngine(_pred(qp), ServeConfig(**cfg))


def _value(name):
    return tm.snapshot().get(name, 0)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_bucket_ladders():
    assert parse_buckets("", 8) == (1, 2, 4, 8)
    assert parse_buckets("", 6) == (1, 2, 4, 6)
    assert parse_buckets("1,4,16", 8) == (1, 4, 16)
    assert validate_buckets([2, 3]) == (2, 3)
    for bad in ("16,4,8", "1,1,2", "0,2", "a,b"):
        with pytest.raises(MXNetError):
            parse_buckets(bad, 8)
    with pytest.raises(MXNetError):
        validate_buckets([])


def test_serve_config_reads_its_knobs(monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_BUCKETS", "1,3")
    monkeypatch.setenv("MXNET_SERVE_QUEUE_DEPTH", "5")
    monkeypatch.setenv("MXNET_SERVE_BATCH_WAIT_MS", "7")
    monkeypatch.setenv("MXNET_SERVE_DEADLINE_MS", "0")
    cfg = ServeConfig()
    assert cfg.buckets == (1, 3) and cfg.max_batch == 3
    assert cfg.queue_depth == 5 and cfg.batch_wait == 0.007
    assert cfg.default_timeout == 0.0 and cfg.workers == 1
    assert ServeConfig(buckets=[2, 4], queue_depth=1).max_batch == 4
    with pytest.raises(MXNetError):
        ServeConfig(queue_depth=0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_batched_answers_equal_a_direct_forward(artifact):
    """Requests of 1-3 rows from 6 threads, coalesced into padded
    buckets: every request gets exactly its rows' direct outputs."""
    eng = _engine(artifact).start().warmup()
    sizes = [1, 2, 3, 1, 1, 2, 3, 1, 2, 1, 3, 1]
    starts = np.cumsum([0] + sizes[:-1])
    results = [None] * len(sizes)
    b0 = _value("serving/batches_total")

    def client(i):
        rows = X[starts[i]:starts[i] + sizes[i]]
        results[i] = eng.predict({"data": rows})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(sizes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    eng.close()
    assert not any(t.is_alive() for t in threads)
    for i, n in enumerate(sizes):
        got = results[i][0]
        assert got.shape == (n, 5)
        want = _direct(artifact, X[starts[i]:starts[i] + n])
        assert got.tobytes() == want.tobytes(), i
    batches = _value("serving/batches_total") - b0
    assert 3 <= batches < len(sizes)     # 21 rows in buckets of <= 8


def test_padding_is_invisible_and_bucket_predictors_share_weights(artifact):
    eng = _engine(artifact, buckets=[1, 4])
    eng.start()
    got = eng.predict(X[:3])[0]          # 3 rows padded to 4
    assert got.tobytes() == _direct(artifact, X[:3]).tobytes()
    eng.close()
    base, four = eng._bucket_pred(1), eng._preds[4]
    assert base is eng._base
    for k in ("fc1_weight_q", "fc1_w_scale", "fc2_bias"):
        assert four._exe.arg_dict[k] is base._exe.arg_dict[k]
    assert four._exe.arg_dict["data"] is not base._exe.arg_dict["data"]
    assert four._exe.arg_dict["fc1_weight_q"]._data.dtype == torch.int8


def test_warmup_runs_every_bucket(artifact):
    eng = _engine(artifact, max_batch=4)
    assert not eng.ready
    eng.warmup()
    assert sorted(eng._preds) == [1, 2, 4]
    assert not eng.ready                 # no worker yet
    eng.start()
    assert eng.ready
    eng.close()
    assert not eng.ready


def test_single_row_without_batch_axis(artifact):
    eng = _engine(artifact).start()
    got = eng.predict(X[5])[0]
    eng.close()
    assert got.tobytes() == _direct(artifact, X[5:6]).tobytes()


def test_admission_control(artifact):
    eng = _engine(artifact, queue_depth=2)
    r0 = _value("serving/rejected_total")
    eng.submit(X[:1])
    eng.submit(X[:1])
    with pytest.raises(QueueFullError):
        eng.submit(X[:1])
    for bad in (X[:9], np.zeros((2, IN + 1), np.float32),
                np.zeros((0, IN), np.float32)):
        with pytest.raises(MXNetError):
            eng.submit(bad)
    with pytest.raises(MXNetError, match="missing"):
        eng.submit({"other": X[:1]})
    eng.close(drain=False)
    with pytest.raises(EngineClosedError):
        eng.submit(X[:1])
    assert _value("serving/rejected_total") == r0 + 2


def test_close_without_workers_fails_the_queue(artifact):
    eng = _engine(artifact)
    fut = eng.submit(X[:2])
    eng.close(drain=True)                # no worker to drain through
    with pytest.raises(EngineClosedError):
        fut.result()


def test_drain_on_close_answers_every_queued_request(artifact):
    eng = _engine(artifact)
    futs = [eng.submit(X[i:i + 1]) for i in range(20)]
    eng.start()
    eng.close(drain=True)
    for i, f in enumerate(futs):
        assert f.result()[0].tobytes() == \
            _direct(artifact, X[i:i + 1]).tobytes()
    assert eng._workers == []


def test_deadline_expires_in_the_queue_and_counts_once(artifact):
    eng = _engine(artifact)
    t0 = _value("serving/timeouts_total")
    fut = eng.submit(X[:1], timeout_ms=1)
    keep = eng.submit(X[1:2], timeout_ms=0)        # no deadline
    time.sleep(0.05)
    eng.start()
    with pytest.raises(DeadlineExceededError):
        fut.result()
    assert keep.result()[0].shape == (1, 5)
    eng.close()
    assert _value("serving/timeouts_total") == t0 + 1


def test_a_crashed_worker_restarts(artifact, monkeypatch):
    eng = _engine(artifact, worker_restarts=2)
    real = eng._take_batch
    crashes = [0]

    def flaky():
        if crashes[0] == 0:
            crashes[0] += 1
            raise RuntimeError("scheduler bug")
        return real()

    monkeypatch.setattr(eng, "_take_batch", flaky)
    n0 = _value("serving/worker_restarts_total")
    eng.start()
    out = eng.predict(X[:2])[0]
    eng.close()
    assert out.shape == (2, 5)
    assert _value("serving/worker_restarts_total") == n0 + 1


def test_a_failing_batch_fails_its_requests_and_the_worker_lives(artifact,
                                                                monkeypatch):
    eng = _engine(artifact, buckets=[1, 2]).start()
    pred = eng._bucket_pred(2)
    real = pred._exe.forward
    monkeypatch.setattr(pred._exe, "forward",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("device fault")))
    with pytest.raises(MXNetError, match="batch execution failed"):
        eng.predict(X[:2])
    monkeypatch.setattr(pred._exe, "forward", real)
    assert eng.predict(X[:2])[0].shape == (2, 5)
    eng.close()


# ---------------------------------------------------------------------------
# the Predictor
# ---------------------------------------------------------------------------

def test_predictor_api(artifact):
    pred = _pred(artifact, 2)
    with pytest.raises(MXNetError, match="forward"):
        pred.get_output(0)
    with pytest.raises(MXNetError, match="size mismatch"):
        pred.set_input("data", X[:1].tobytes())
    with pytest.raises(MXNetError, match="unknown input"):
        pred.set_input("nope", X[:2].tobytes())
    pred.set_input("data", X[:2].tobytes())
    pred.forward()
    assert pred.num_outputs() == 1 and pred.get_output_shape(0) == (2, 5)
    probs = np.frombuffer(pred.get_output(0), np.float32).reshape(2, 5)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-6)
    # reshape: weights shared, the input buffer not
    big = pred.reshape({"data": (6, IN)})
    assert big._exe.arg_dict["fc2_weight_q"] is \
        pred._exe.arg_dict["fc2_weight_q"]
    big.set_input("data", X[:6].tobytes())
    big.forward()
    assert big.get_output_shape(0) == (6, 5)
    assert np.frombuffer(big.get_output(0), np.float32)[:10].tobytes() == \
        probs.tobytes()
    assert pred._exe.arg_dict["data"].asnumpy().tobytes() == \
        X[:2].tobytes()


def test_predictor_defaults_to_the_card(artifact):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default binds there")
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.serving.Predictor(artifact.symbol_json, artifact.param_bytes(),
                              input_shapes={"data": (1, IN)})
    with pytest.raises(MXNetError, match="dev_type"):
        tmx.serving.Predictor(artifact.symbol_json, artifact.param_bytes(),
                              dev_type=7, input_shapes={"data": (1, IN)})


def test_engine_needs_named_inputs(artifact):
    pred = tmx.serving.Predictor(artifact.symbol_json,
                                 artifact.param_bytes(), dev_type=1,
                                 input_shapes={"data": (1, IN)})
    pred._input_names = []
    with pytest.raises(MXNetError, match="input_shapes"):
        InferenceEngine(pred)
