"""The port's ``telemetry`` sinks and ``tracing`` held against the JAX
package's modules of the same names, in one process.

* Prometheus text: the same registry operations (labelled counters and
  gauges, histograms with default and caller buckets, exemplars) render
  byte for byte the same text, and the same exemplars on a frozen clock.
* Span trees: one scripted call sequence (roots, implicit and explicit
  children, after-the-fact spans, errors, the slow ring) on a fixed
  clock and a fixed id stream gives the same finished traces, slow ring
  and ``traces_payload`` in both packages.
* The wire: a context from either package grafts into the other's trace.
"""
import random

import pytest

pytest.importorskip("jax")
from mxnet_tpu import telemetry as jtm  # noqa: E402
from mxnet_tpu import tracing as jtr  # noqa: E402
from mxnet_tpu_torch import telemetry as ptm  # noqa: E402
from mxnet_tpu_torch import tracing as ptr  # noqa: E402

BOTH = [(jtm, jtr), (ptm, ptr)]


class _Clock(object):
    """A clock that advances by a fixed step on every reading."""

    def __init__(self, t=100.0, step=0.0025):
        self.t = t
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def _registry_ops(tm):
    reg = tm.Registry()
    reg.counter("serving/requests_total", "Requests").inc(3)
    c = reg.counter("decode/rejected_total", "Refused", ("reason",))
    c.labels("pages").inc()
    c.labels(reason="queue_depth").inc(2)
    g = reg.gauge("serving/mfu", "Per-bucket MFU", ("bucket",))
    g.labels("8").set(0.123456789)
    g.labels("16").set(2)
    reg.gauge("serving/queue_depth", "Depth").set(4)
    reg.gauge("io/queue", 'quoted "help"\nsecond line').inc(2.5)
    h = reg.histogram("serving/request_seconds", "Latency", ("bucket",))
    for v in (1e-6, 0.003, 0.02, 0.7, 12.0):
        h.labels("4").observe(v)
    d = reg.histogram("quantize/shadow_drift", "Drift",
                      buckets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0))
    for v in (0.0, 3e-5, 0.2, 5.0):
        d.observe(v)
    reg.counter("label/escape", "", ("k",)).labels('a"b\\c').inc()
    return reg


def test_prometheus_text_and_snapshot_byte_equal():
    jreg, preg = _registry_ops(jtm), _registry_ops(ptm)
    text = preg.render_prometheus()
    assert text == jreg.render_prometheus()
    assert 'le="+Inf"' in text and "mxnet_quantize_shadow_drift" in text
    assert preg.snapshot() == jreg.snapshot()
    assert ptm.prom_name("serving/mfu") == jtm.prom_name("serving/mfu")


def test_exemplars_equal_on_a_frozen_clock(monkeypatch):
    out = []
    for tm, _tr in BOTH:
        clock = _Clock(500.0, 1.0)
        monkeypatch.setattr(tm, "monotonic", clock)
        monkeypatch.setattr(tm, "REGISTRY", tm.Registry())
        h = tm.histogram("serving/compute_seconds", "Compute")
        h.observe(0.01, trace_id="a" * 32)
        h.observe(0.5, trace_id="b" * 32)      # the worst
        h.observe(0.2, trace_id="c" * 32)
        h.observe(0.9)                          # untraced: no exemplar
        d = tm.histogram("decode/prefill_seconds", "Prefill", ("k",))
        d.labels("x").observe(0.05, trace_id="d" * 32)
        clock.t += 400.0                        # past the decay window
        e = tm.histogram("decode/step_seconds", "Step")
        e.observe(0.002, trace_id="e" * 32)
        out.append(tm.exemplars())
    assert out[1] == out[0]
    assert out[1] == {"decode/step_seconds": {
        "seconds": 0.002, "trace_id": "e" * 32, "age_s": 2.0}}


def _strip(trace):
    t = dict(trace)
    t.pop("wall_ts", None)
    t.pop("age_s", None)
    t["spans"] = [dict(s, tid=0) for s in t.get("spans", ())] \
        if isinstance(t.get("spans"), list) else t.get("spans")
    return t


def _script(tr):
    """Roots, implicit and explicit children, an after-the-fact span,
    an error root, an unsampled root, a marked error, the slow ring."""
    tr.set_slow_ms(12)
    with tr.start_span("http.request", trace_id="req-1",
                       attrs={"path": "/predict"}) as root:
        with tr.child_span("serve.queue_wait"):
            pass
        ctx = root.ctx
        sid = tr.record_span("serve.batch", ctx, 100.0, 100.01,
                             attrs={"rows": 3})
        tr.record_span("serve.compute", ctx, 100.001, 100.009,
                       parent_id=sid, attrs={"bucket": 4})
        with tr.use_context(ctx.child_of(sid)):
            with tr.child_span("executor.forward",
                               attrs={"is_train": False}) as sp:
                sp.set_attr("extra", 1)
        root.set_attr("http_status", 200)
    with pytest.raises(ValueError):
        with tr.start_span("train.step", attrs={"epoch": 0, "nbatch": 1}):
            with tr.child_span("train.forward_backward"):
                raise ValueError("boom")
    with tr.start_span("health.alert", attrs={"rule": "r"}):
        tr.mark_error("fault injected at 'serve.worker' (hit 1)")
    prev = tr.set_sample(0.0)
    with tr.start_span("unsampled") as s:
        assert s.ctx is None
        assert tr.child_span("x").ctx is None
    tr.set_sample(prev)
    assert tr.child_span("orphan") is tr.NOOP
    with tr.start_span("http.request", trace_id="req-2") as root:
        for i in range(3):
            tr.record_span("decode.step", root.ctx, 0.0, 0.001 * i,
                           attrs={"slots": i})


def test_span_trees_equal_on_a_fixed_clock(monkeypatch):
    from mxnet_tpu import health as jhl
    from mxnet_tpu_torch import health as phl
    for hl in (jhl, phl):
        hl.stop_evaluator()       # its alert spans would join the rings
    results = []
    for _tm, tr in BOTH:
        monkeypatch.setattr(tr, "_monotonic", _Clock())
        monkeypatch.setattr(tr, "_rng", random.Random(1234))
        tr.reset()
        prev_sample, prev_slow = tr.set_sample(1.0), tr.set_slow_ms(1000)
        try:
            _script(tr)
            results.append((
                [_strip(t) for t in tr.finished_traces()],
                [_strip(t) for t in tr.slow_traces()],
                [_strip(t) for t in tr.traces_payload()["recent"]],
                _strip(tr.traces_payload("req-1")),
                {k: v for k, v in tr.traces_payload().items()
                 if k not in ("recent", "slow", "exemplars")},
                tr.traces_endpoint("id=nope")))
        finally:
            tr.set_sample(prev_sample)
            tr.set_slow_ms(prev_slow)
            tr.reset()
    assert results[1] == results[0]
    traces = results[1][0]
    assert [t["root"] for t in traces] == [
        "http.request", "health.alert", "train.step", "http.request"]
    req1 = traces[-1]
    by_name = {s["name"]: s for s in req1["spans"]}
    root = by_name["http.request"]
    assert root["parent_id"] is None and root["trace_id"] == "req-1"
    assert by_name["serve.compute"]["parent_id"] == \
        by_name["serve.batch"]["span_id"]
    assert by_name["executor.forward"]["parent_id"] == \
        by_name["serve.batch"]["span_id"]
    assert by_name["executor.forward"]["attrs"] == {"is_train": False,
                                                    "extra": 1}
    step = traces[-2]
    assert step["error"] == "ValueError: boom"
    # slow: req-1 by duration, the other two by their errors
    assert [t["root"] for t in results[1][1]] == [
        "health.alert", "train.step", "http.request"]
    assert results[1][5][0] == 404


def test_chrome_events_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="A19"):
        ptr.chrome_events()


@pytest.mark.parametrize("sender,receiver", [(jtr, ptr), (ptr, jtr)])
def test_a_wire_from_either_package_grafts_into_the_other(sender,
                                                          receiver):
    """The sender's wire context crosses to the receiver, which records
    spans into a sink; the sink grafts back into the sender's trace,
    rebased by the clock pair, deduplicated on span id."""
    sender.reset()
    receiver.reset()
    with sender.start_span("router.forward") as root:
        wire = sender.wire_context()
        assert wire == {"trace_id": root.trace_id,
                        "span_id": root.span_id, "sampled": True}
        sink = []
        rctx = receiver.from_wire(dict(wire), sink)
        with receiver.start_span("http.request", ctx=rctx):
            with receiver.child_span("serve.compute"):
                pass
        assert [s["name"] for s in sink] == ["serve.compute",
                                             "http.request"]
        clock = (receiver._PROC_TOKEN, receiver._monotonic(),
                 sender._monotonic())
        sender.graft(sink, clock=clock)
        sender.graft(sink, clock=clock)          # replayed: no duplicates
    trace = sender.finished_traces()[0]
    names = sorted(s["name"] for s in trace["spans"])
    assert names == ["http.request", "router.forward", "serve.compute"]
    spans = {s["name"]: s for s in trace["spans"]}
    assert spans["http.request"]["parent_id"] == root.span_id
    assert spans["serve.compute"]["parent_id"] == \
        spans["http.request"]["span_id"]
    assert receiver.from_wire(None) is None
    assert receiver.from_wire({"trace_id": "t", "span_id": "s",
                               "sampled": False}) is None
    sender.reset()
    receiver.reset()


def test_sampling_draws_from_a_private_stream():
    """A sampled-at-0.5 run consumes nothing of ``random``'s global
    stream, in both packages."""
    for _tm, tr in BOTH:
        prev = tr.set_sample(0.5)
        try:
            random.seed(99)
            want = random.random()
            random.seed(99)
            for _ in range(20):
                with tr.start_span("x"):
                    pass
            assert random.random() == want
        finally:
            tr.set_sample(prev)
            tr.reset()


def _fit_traces(mx, tr, it):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    sym = mx.sym.SoftmaxOutput(fc, name="softmax")
    tr.reset()
    mx.mod.Module(sym, context=mx.cpu()).fit(
        it, num_epoch=1, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1})
    out = []
    for t in reversed(tr.finished_traces()):
        if t["root"] != "train.step":
            continue             # another thread's root (an SLO alert)
        name = {s["span_id"]: s["name"] for s in t["spans"]}
        # executor.compile (an XLA compile in the JAX package) is the
        # program registry's span (ROADMAP A6)
        out.append((t["root"], sorted((s["name"], name.get(s["parent_id"]))
                                      for s in t["spans"]
                                      if s["name"] != "executor.compile")))
    tr.reset()
    return out


def test_fit_step_spans_alike():
    """One root ``train.step`` a step, with the same children, in both
    packages' ``Module.fit``."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as pmx
    import numpy as np
    rng = np.random.RandomState(0)
    X = rng.randn(12, 5).astype(np.float32)
    y = rng.randint(0, 3, (12,)).astype(np.float32)
    got = [_fit_traces(mx, tr, mx.io.NDArrayIter(X, y, batch_size=4))
           for mx, tr in ((jmx, jtr), (pmx, ptr))]
    assert got[1] == got[0]
    assert [root for root, _ in got[1]] == ["train.step"] * 3
    assert ("train.data_wait", "train.step") in got[1][0][1]
    assert ("executor.train_step", "train.update") in got[1][0][1]


def test_pipeline_fit_records_data_wait_and_io_spans():
    import mxnet_tpu_torch as pmx
    import numpy as np
    rng = np.random.RandomState(1)
    X = rng.randn(32, 5).astype(np.float32)
    y = rng.randint(0, 3, (32,)).astype(np.float32)
    # the staging thread decodes ahead into the trace of the step that
    # last drew a batch: with 8 batches most land in some step's trace
    pipe = pmx.io.DataPipeline(pmx.io.ArrayBatchSource(X, y, batch_size=4),
                               num_workers=0, prefetch=1, ctx=pmx.cpu())
    traces = _fit_traces(pmx, ptr, pipe)
    pairs = set(p for _root, tree in traces for p in tree)
    assert ("io.batch_wait", "train.data_wait") in pairs
    assert {"io.h2d", "io.decode"} & set(n for n, _p in pairs)
