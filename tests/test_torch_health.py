"""The port's ``health``, ``fault`` and ``blackbox`` held against the JAX
package's modules of the same names, in one process.

* Fault points: the same table, arm / step / count / kind semantics and
  ``MXNET_FAULT_INJECT`` parsing.
* Flight recorder: each package reads the other's file (a torn tail
  included) and the two CLIs print the same lines.
* SLO engine: the same observation stream on a fake clock gives the same
  alert transitions and ``/alerts`` payload; the default rule sets are
  the same.
* Numerics sentinel: a NaN batch in ``Module.fit`` trips both packages'
  sentinels under ``raise``, ``warn`` and ``checkpoint-and-raise``, with
  the same healthy-step loss and gradient norm (within 1e-4 relative).
* Cost counts: the port's count of a small conv net's forward and of a
  tiny decode model's prefill and step buckets against the JAX
  package's XLA cost pass (``capture_cost``), within the factors stated
  at each test (XLA also counts the elementwise work its fusions do).
"""
import os
import struct
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import blackbox as jbb  # noqa: E402
from mxnet_tpu import fault as jfault  # noqa: E402
from mxnet_tpu import health as jhl  # noqa: E402
from mxnet_tpu import telemetry as jtm  # noqa: E402
import mxnet_tpu_torch as pmx  # noqa: E402
from mxnet_tpu_torch import blackbox as pbb  # noqa: E402
from mxnet_tpu_torch import fault as pfault  # noqa: E402
from mxnet_tpu_torch import health as phl  # noqa: E402
from mxnet_tpu_torch import telemetry as ptm  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

HEALTH = [(jhl, jtm), (phl, ptm)]


@pytest.fixture(autouse=True)
def _isolation():
    saved = [(h.numerics_mode(), h.numerics_policy()) for h, _ in HEALTH]
    yield
    for (h, _), (mode, policy) in zip(HEALTH, saved):
        h.set_numerics(mode)
        h.set_numerics_policy(policy)
        h.reset()
    for bb in (jbb, pbb):
        bb.reset()
    for f in (jfault, pfault):
        f.disarm()


# ---------------------------------------------------------------------------
# fault points
# ---------------------------------------------------------------------------

def test_fault_points_and_kinds_equal():
    assert pfault.POINTS == jfault.POINTS
    assert pfault.KINDS == jfault.KINDS
    assert pbb.EVENTS == jbb.EVENTS


def _fire_pattern(fault, point, n, **kw):
    fault.arm(point, **kw)
    out = []
    for _ in range(n):
        try:
            fault.inject(point)
            out.append("ok")
        except fault.TransientKVError:
            out.append("transient")
        except fault.PartitionError:
            out.append("partition")
        except fault.FaultInjected:
            out.append("raise")
    return out, fault.hits(point), fault.armed()


@pytest.mark.parametrize("kw", [dict(step=1), dict(step=3, count=2),
                                dict(step=2, kind="transient", count=3),
                                dict(step=1, kind="partition"),
                                dict(step=2, kind="delay", delay_ms=1)])
def test_arm_step_count_kind_semantics_equal(kw):
    got = [_fire_pattern(f, "serve.worker", 6, **kw)
           for f in (jfault, pfault)]
    assert got[1] == got[0]
    for f in (jfault, pfault):
        f.disarm()
        assert f.hits("serve.worker") == 6     # kept until re-armed
        with f.arming("decode.step", step=1):
            with pytest.raises(f.FaultInjected):
                f.inject("decode.step")
        assert f.armed() == {}


def test_bad_arming_raises_in_both():
    for f in (jfault, pfault):
        for args, kw in ((("no.such.point",), {}),
                         (("serve.worker",), {"kind": "explode"}),
                         (("serve.worker",), {"step": 0})):
            with pytest.raises(Exception) as ei:
                f.arm(*args, **kw)
            assert "known" in str(ei.value) or ">= 1" in str(ei.value)


@pytest.mark.parametrize("spec", [
    "ckpt.mid_write:1:crash",
    "serve.worker:2:raise:3, decode.step:1:delay",
    "io.worker:4:transient,engine.step:1:raise:2",
    "serve.worker:1",
    "serve.worker:x:raise",
    "nope:1:raise"])
def test_env_parsing_equal(monkeypatch, spec):
    monkeypatch.setenv("MXNET_FAULT_INJECT", spec)
    got = []
    for f in (jfault, pfault):
        f.disarm()
        try:
            f._load_env()
            got.append(("armed", f.armed()))
        except (ValueError, Exception) as e:
            got.append(("error", type(e).__name__))
        f.disarm()
    assert got[1] == got[0]


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _write(bb, path):
    bb.configure(path)
    bb.record_event("swap", quantized=True, decode_rotated=False)
    bb.record_event("fault", point="serve.worker", kind="raise", hit=1)
    bb.record_event("alert", rule="numerics", state="firing", value=1.0,
                    threshold=0.0)
    bb.record_event("checkpoint", file="m-0001.params", seconds=0.01)
    bb.configure(None)


@pytest.mark.parametrize("writer,reader", [(jbb, pbb), (pbb, jbb)])
def test_each_package_reads_the_others_ring(tmp_path, writer, reader,
                                            capsys):
    path = str(tmp_path / "flight.bin")
    _write(writer, path)
    ev_w, torn_w = writer.read_events(path)
    ev_r, torn_r = reader.read_events(path)
    assert ev_r == ev_w and torn_r == torn_w == 0
    assert [e["event"] for e in ev_r] == ["start", "swap", "fault",
                                          "alert", "checkpoint"]
    # a torn tail: half a frame appended (a SIGKILL mid-write)
    payload = b'{"event": "swap", "t": 1.0}'
    frame = struct.pack("<4sII", b"FR\x00\x00", len(payload),
                        zlib.crc32(payload) & 0xFFFFFFFF) + payload
    with open(path, "ab") as f:
        f.write(frame[:len(frame) // 2])
    assert reader.read_events(path) == writer.read_events(path)
    assert reader.read_events(path)[1] == len(frame) // 2
    assert reader.tail(2, path) == ev_w[-2:]
    for bb in (writer, reader):
        bb.main([path, "--json"])
    out = capsys.readouterr().out.strip().split("\n")
    half = len(out) // 2
    assert out[:half] == out[half:] and "torn tail" in out[-1]
    assert reader.merge_rings([path])["count"] == len(ev_w)


def test_unknown_event_raises_and_disabled_is_a_noop(tmp_path):
    for bb in (jbb, pbb):
        with pytest.raises(Exception, match="unknown flight-recorder"):
            bb.record_event("nope")
        assert bb.record_event("swap") is False


# ---------------------------------------------------------------------------
# SLO engine
# ---------------------------------------------------------------------------

class _Series(object):
    def __init__(self, values):
        self.values = list(values)

    def __call__(self):
        return self.values.pop(0) if self.values else None


def _mine(names):
    return [n for n in names if n.startswith("t_")]


def test_alert_transitions_and_payload_equal(monkeypatch):
    burn = [0.1, 2.0, 2.5, 3.0, 0.2, 0.1, 0.1, 2.0, None, 0.0]
    events = [0, 0, 1, 0, 0, 0, 0, 0, 2, 0]
    out = []
    for hl, tm in HEALTH:
        hl.reset()
        hl.set_interval(3600.0)          # no evaluator tick in the test
        clock = [1000.0]
        monkeypatch.setattr(hl, "_monotonic", lambda: clock[0])
        hl.watch("t_burn", value_fn=_Series(burn), threshold=1.0,
                 short_s=3.0, long_s=6.0, burn=0.5, description="burn")
        hl.watch("t_events", value_fn=_Series(events), threshold=0.0,
                 mode="events", short_s=2.0, long_s=4.0)
        hl.watch("t_low", value_fn=_Series([5, 0.5, 0.4, 0.3]),
                 threshold=1.0, cmp="<", short_s=2.0, long_s=2.0,
                 burn=1.0)
        seq = []
        for _ in range(len(burn)):
            clock[0] += 1.0
            seq.append(_mine(hl.evaluate_once(clock[0])))
        # the default rules read each package's own global telemetry:
        # only the scripted rules are compared
        payload = hl.alerts_payload()
        payload["rules"] = [r for r in payload["rules"]
                            if r["name"].startswith("t_")]
        payload["firing"] = _mine(payload["firing"])
        payload.pop("evaluator_alive")
        js = hl.alerts_endpoint("format=json")[1]
        js["rules"] = [r for r in js["rules"] if r["rule"].startswith("t_")]
        js["firing"] = _mine(js["firing"])
        out.append((seq, payload, js, _mine(hl.alerts_firing())))
        hl.stop_evaluator()
    assert out[1] == out[0]
    seq = out[1][0]
    assert "t_burn" in seq[3] and "t_burn" not in seq[0]
    assert "t_events" in seq[2] and "t_events" in seq[8]


def test_default_rules_on_the_same_telemetry_stream(monkeypatch):
    """``worker_restart_burn`` fires on one restart, ``numerics`` on one
    trip, and every default rule over a series the port never writes
    stays ok."""
    out = []
    for hl, tm in HEALTH:
        hl.reset()
        hl.set_interval(3600.0)
        clock = [50.0]
        monkeypatch.setattr(hl, "_monotonic", lambda: clock[0])
        seq = []
        for step in range(6):
            clock[0] += 1.0
            if step == 2:
                tm.counter("serving/worker_restarts_total",
                           "Serve worker threads restarted after a "
                           "crash").inc()
            if step == 3:
                tm.counter("health/numerics_trips_total", "trips",
                           ("kind",)).labels("nonfinite").inc()
            seq.append(hl.evaluate_once(clock[0]))
        out.append((seq, hl.rules()))
        hl.stop_evaluator()
    # the two driven rules compare; the rest read each package's own
    # global telemetry (the JAX package's goodput ledger, written by
    # any JAX fit in this process, feeds its badput_fraction rule)
    driven = ("worker_restart_burn", "numerics")
    assert [[n for n in f if n in driven] for f in out[1][0]] == \
        [[n for n in f if n in driven] for f in out[0][0]]
    assert out[1][1] == out[0][1]
    seq, rules = out[1]
    assert rules == sorted(["serve_p99", "decode_itl_p99", "queue_depth",
                            "worker_restart_burn", "kv_giveups",
                            "numerics", "mfu_divergence",
                            "badput_fraction"])
    assert "worker_restart_burn" in seq[2] and "numerics" in seq[3]
    # the port writes neither kvstore/giveups_total nor
    # goodput/badput_fraction: their rules stay ok
    assert not {"kv_giveups", "badput_fraction"} & set(sum(seq, []))


def test_peaks_are_the_cards_spec_sheet(monkeypatch):
    assert phl.peak_flops() == 989.4e12
    assert phl.peak_hbm_bytes_per_s() == 3350e9
    monkeypatch.setenv("MXNET_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("MXNET_TPU_PEAK_HBM_GBPS", "100")
    assert phl.peak_flops() == 1e12
    assert phl.peak_hbm_bytes_per_s() == 100e9
    rec = {"flops": 2e12, "bytes": 50e9}
    assert phl.note_serve_batch(4, 1.0, rec) == (2.0, 0.5)
    assert ptm.snapshot()["serving/mfu{bucket=4}"] == 2.0
    assert phl.note_decode("step", 2, 4.0, rec)[0] == 0.5
    assert phl.note_mfu_divergence(1.0, 1.3) == pytest.approx(1.3)
    assert phl.mfu_summary()["mfu_divergence"] == pytest.approx(0.3)


# ---------------------------------------------------------------------------
# numerics sentinel
# ---------------------------------------------------------------------------

BATCH, IN, NB = 4, 6, 4


def _data(nan_batch=None):
    rng = np.random.RandomState(3)
    X = rng.randn(BATCH * NB, IN).astype(np.float32)
    y = rng.randint(0, 3, (BATCH * NB,)).astype(np.float32)
    if nan_batch is not None:
        X[nan_batch * BATCH:(nan_batch + 1) * BATCH] = np.nan
    return X, y


def _params():
    rng = np.random.RandomState(4)
    return {"fc1_weight": rng.randn(8, IN).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rng.randn(3, 8).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(3, np.float32)}


def _fit(mx, ctx, X, y, prefix=None, epochs=1):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = mx.sym.FullyConnected(act, num_hidden=3, name="fc2")
    sym = mx.sym.SoftmaxOutput(fc2, name="softmax")
    mod = mx.mod.Module(sym, context=ctx)
    args = {k: mx.nd.array(v, ctx=ctx) for k, v in _params().items()}
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=BATCH), num_epoch=epochs,
            optimizer="sgd", optimizer_params={"learning_rate": 0.1},
            arg_params=args, checkpoint_prefix=prefix)
    return mod


SIDES = [(jhl, jmx, lambda: jmx.cpu()), (phl, pmx, lambda: pmx.cpu())]


def test_healthy_steps_report_the_same_loss_and_norm():
    got = []
    for hl, mx, ctx in SIDES:
        hl.set_numerics("step")
        mod = _fit(mx, ctx(), *_data())
        mod._exec.flush_numerics()
        got.append((ctx_gauge(hl, "health/loss"),
                    ctx_gauge(hl, "health/grad_norm")))
    np.testing.assert_allclose(got[1], got[0], rtol=1e-4)


def ctx_gauge(hl, name):
    tm = hl._tm()
    return tm.REGISTRY._families[name].value


@pytest.mark.parametrize("policy", ["raise", "warn",
                                    "checkpoint-and-raise"])
def test_nan_batch_trips_both_sentinels(policy, tmp_path):
    got = []
    for hl, mx, ctx in SIDES:
        hl.set_numerics("step")
        hl.set_numerics_policy(policy)
        trips0 = hl.numerics_trips()
        prefix = str(tmp_path / ("%s_ck" % mx.__name__))
        raised = None
        try:
            _fit(mx, ctx(), *_data(nan_batch=1), prefix=prefix, epochs=2)
        except hl.NumericsError as e:
            raised = e.report["nonfinite"] > 0
        forensic = sorted(f.split(".numerics")[1] for f in
                          os.listdir(str(tmp_path))
                          if f.startswith(os.path.basename(prefix)
                                          + ".numerics")
                          and f.endswith(".params"))
        got.append((raised, hl.numerics_trips() - trips0, forensic))
    assert got[1] == got[0]
    if policy == "warn":
        assert got[1][0] is None and got[1][1] >= 1
    else:
        assert got[1][0] is True and got[1][1] == 1
    assert bool(got[1][2]) == (policy == "checkpoint-and-raise")


@pytest.mark.parametrize("on", [True, False])
def test_executor_mfu_only_while_telemetry_is_on(on):
    got = []
    for hl, mx, ctx in SIDES:
        tm = hl._tm()
        prev = tm.enable(on)
        try:
            tm.reset()
            mod = _fit(mx, ctx(), *_data())
        finally:
            tm.enable(prev)
        got.append("executor/mfu" in tm.REGISTRY._families)
        if on:
            assert ctx_gauge(hl, "executor/mfu") > 0
    assert got == [on, on]
    # the port keeps no step-end clock (no CUDA event on the card) while
    # telemetry is off
    assert (mod._exec._last_step_end is None) == (not on)


def test_unknown_policy_and_mode_raise_in_both():
    for hl, _mx, _ctx in SIDES:
        with pytest.raises(Exception, match="numerics policy"):
            hl.set_numerics_policy("skip")
        with pytest.raises(Exception, match="numerics mode"):
            hl.set_numerics("sometimes")


def test_full_mode_names_the_parameter():
    phl.set_numerics("full")
    phl.set_numerics_policy("raise")
    with pytest.raises(phl.NumericsError) as ei:
        _fit(pmx, pmx.cpu(), *_data(nan_batch=2))
    assert "worst param" in str(ei.value)
    per = ei.value.report["per_param"]
    assert sorted(per) == sorted(_params())
    assert sum(v["nonfinite"] for v in per.values()) > 0


# ---------------------------------------------------------------------------
# cost counts against XLA's cost pass
# ---------------------------------------------------------------------------

def _conv_net(mx):
    data = mx.sym.Variable("data")
    c1 = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                            name="c1")
    b1 = mx.sym.BatchNorm(c1, name="bn1")
    r1 = mx.sym.Activation(b1, act_type="relu", name="r1")
    c2 = mx.sym.Convolution(r1, num_filter=16, kernel=(3, 3),
                            stride=(2, 2), pad=(1, 1), name="c2")
    r2 = mx.sym.Activation(c2, act_type="relu", name="r2")
    p = mx.sym.Pooling(r2, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="p")
    fc = mx.sym.FullyConnected(mx.sym.Flatten(p), num_hidden=10, name="fc")
    return mx.sym.SoftmaxOutput(fc, name="softmax")


# the port counts convolutions and matmuls exactly and one operation
# per element elsewhere; XLA's pass counts the same products and its
# own elementwise work (the port's count read 1.052 of it)
CONV_FLOPS_BAND = (0.9, 1.1)


@pytest.mark.parametrize("batch", [2, 8])
def test_conv_net_bucket_cost_against_capture_cost(batch):
    shapes = {"data": (batch, 3, 16, 16), "softmax_label": (batch,)}
    jexe = _conv_net(jmx).simple_bind(ctx=jmx.cpu(), grad_req="null",
                                      **shapes)
    jexe.forward(is_train=False)
    jrec = jexe.forward_cost(False)
    pexe = _conv_net(pmx).simple_bind(ctx=pmx.cpu(), grad_req="null",
                                      **shapes)
    prec = pexe.forward_cost(False)
    ratio = prec["flops"] / jrec["flops"]
    print("conv net batch %d: port %.0f / XLA %.0f flops = %.4f"
          % (batch, prec["flops"], jrec["flops"], ratio))
    assert CONV_FLOPS_BAND[0] <= ratio <= CONV_FLOPS_BAND[1]
    assert prec["bytes"] > 0


# the port counts the projections, the FFN, attention over the bucket
# (prefill) or the block table's context (step) and the logits; XLA's
# pass also counts the norms, softmax and rotary work (the port's count
# read 0.89-0.91 of it)
DECODE_FLOPS_BAND = (0.8, 1.1)


def test_decode_bucket_costs_against_capture_cost():
    from jax.sharding import Mesh
    from mxnet_tpu.parallel import transformer as J
    from mxnet_tpu.serve import DecodeConfig as JDC
    from mxnet_tpu.serve import DecodeEngine as JDE
    from mxnet_tpu_torch.parallel import transformer as T
    small = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
                 n_layers=2, d_ff=64, max_len=64, pos_type="rope")
    dcfg = dict(slots=2, page_size=8, num_pages=16, max_context=16,
                queue_depth=4, max_new_tokens=8)
    dev = np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1)
    cj = J.TransformerConfig(**small)
    pj, _ = J.init_transformer_params(
        cj, Mesh(dev, ("dp", "sp", "tp", "pp", "ep")), seed=1)
    jeng = JDE(pj, cj, JDC(**dcfg)).start().warmup()
    jeng.close(drain=False)
    ct = T.TransformerConfig(**small)
    peng = pmx.serve.DecodeEngine(
        T.init_transformer_params_np(ct, seed=1, device="cpu"), ct,
        pmx.serve.DecodeConfig(**dcfg), device="cpu").start().warmup()
    peng.close(drain=False)
    assert sorted(peng._prog_costs) == sorted(jeng._prog_costs)
    for key in sorted(jeng._prog_costs):
        ratio = (peng._prog_costs[key]["flops"]
                 / jeng._prog_costs[key]["flops"])
        print("decode %s %s: port / XLA flops = %.4f" % (key + (ratio,)))
        assert DECODE_FLOPS_BAND[0] <= ratio <= DECODE_FLOPS_BAND[1], key


def test_capture_cost_counts_and_degrades():
    n0 = ptm.snapshot().get(
        "health/cost_analysis_unavailable_total{kind=serve_bucket}", 0)
    assert phl.capture_cost("serve_bucket", phl.next_cost_key("t"),
                            lambda: {"flops": 0.0}) is None
    assert ptm.snapshot()[
        "health/cost_analysis_unavailable_total{kind=serve_bucket}"] \
        == n0 + 1
    key = phl.next_cost_key("t")
    rec = phl.capture_cost("fused_step", key,
                           lambda a: {"flops": a, "bytes": 2.0}, (5.0,))
    assert rec["flops"] == 5.0 and phl.program_cost("fused_step", key) \
        is rec
    assert phl.register_cost("serve_bucket", "x", rec) is rec
    assert ("serve_bucket", "x") in phl.programs()
    with pytest.raises(MXNetError):
        phl.capture_cost("nope", "k", lambda: None)
