"""The port's HTTP front end (``serve.serve_http``) and model registry
(``serve.ModelRegistry``) held against the JAX package's, in one
process, on the CPU.

Two servers, one per package, run over the same weights: a small MLP
checkpoint (and its int8 artifact, quantized by the port; the files are
the JAX package's) for ``/predict``, and a tiny transformer with the
same draws in both packages, served greedily in float32 by each
package's ``DecodeEngine``, for ``/generate``. Held:

* ``/predict`` outputs agree within 1e-5; the ``serve.*`` spans nest in
  the request's span the same way; ``X-Request-Id`` is echoed;
* greedy ``/generate`` token streams are equal, chunk line for chunk line
  (streaming and not);
* status codes and bodies for 400, 404, 503 (a full queue, a full page
  pool; ``Retry-After``) and 504 match, and ``/healthz`` answers 503
  ``warming`` and then ``ok`` in both;
* the shadow canary mirrors the same request indices in both packages;
* and in the port: a client that hangs up mid-stream cancels its
  session and the page pool gets its pages back; a ``swap`` under
  concurrent clients drops nothing and later requests see the new
  weights; ``swap(quantized=)`` answers bitwise as the port's int8
  ``Predictor``; ``/programs`` and ``/cluster`` name their ROADMAP items.

Servers bind port 0 and every wait is bounded.
"""
import http.client
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from jax.sharding import Mesh  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import telemetry as jtm  # noqa: E402
from mxnet_tpu.parallel import transformer as J  # noqa: E402
import mxnet_tpu_torch as pmx  # noqa: E402
from mxnet_tpu_torch import telemetry as ptm  # noqa: E402
from mxnet_tpu_torch.parallel import transformer as T  # noqa: E402

IN = 12
X = np.random.RandomState(8).randn(40, IN).astype(np.float32)
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=64, max_len=64, pos_type="rope")
DCFG = dict(slots=4, page_size=4, num_pages=64, max_context=32,
            queue_depth=8, max_new_tokens=16, default_timeout_ms=60000)
# prompts and lengths whose greedy choices have top-2 margins well above
# the two packages' logit difference (tests/test_torch_decode_serve.py)
REQUESTS = [(3, 6), (7, 10), (12, 4), (5, 12)]
TIMEOUT = 60


def _mlp(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = mx.sym.FullyConnected(act, num_hidden=5, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _params(seed):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(16, IN).astype(np.float32) * 0.3,
            "fc1_bias": rng.randn(16).astype(np.float32) * 0.1,
            "fc2_weight": rng.randn(5, 16).astype(np.float32) * 0.3,
            "fc2_bias": rng.randn(5).astype(np.float32) * 0.1}


def _checkpoint(tmp, seed):
    prefix = str(tmp / ("mlp%d" % seed))
    pmx.model.save_checkpoint(prefix, 0, _mlp(pmx), {
        k: pmx.nd.array(v, ctx=pmx.cpu())
        for k, v in _params(seed).items()}, {})
    with open(prefix + "-0000.params", "rb") as f:
        return prefix, f.read()


def _prompts(seed=5):
    rng = np.random.RandomState(seed)
    return [([int(t) for t in rng.randint(0, 64, (pl,))], mn)
            for pl, mn in REQUESTS]


class _Side(object):
    """One package's registry, decode engine and server."""

    def __init__(self, mx, tm, pkg, blob, params, cfg, artifact):
        self.mx, self.tm = mx, tm
        self.reg = mx.serve.ModelRegistry(
            _mlp(mx).tojson(), blob, {"data": (1, IN)}, dev_type=1,
            config=mx.serve.ServeConfig(max_batch=4, batch_wait_ms=1,
                                        default_timeout_ms=60000))
        kw = {} if pkg == "jax" else {"device": "cpu"}
        self.decode = mx.serve.DecodeEngine(
            params, cfg, mx.serve.DecodeConfig(**DCFG), **kw).start()
        self.reg.attach_decode(self.decode)
        self.srv = mx.serve.serve_http(self.reg)
        self.artifact = artifact
        self.healthz_cold = _get(self.srv, "/healthz")
        self.reg.warmup()
        self.decode.warmup()

    def close(self):
        self.srv.close()
        self.reg.close(drain=False)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("http")
    prefix, blob = _checkpoint(tmp, 0)
    qp = pmx.quantize.quantize_checkpoint(prefix, [X[:16], X[16:32]],
                                          calib_mode="naive", ctx=pmx.cpu())
    art = str(tmp / "mlp_int8")
    qp.save(art)
    dev = np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1)
    pj, _ = J.init_transformer_params(
        J.TransformerConfig(**SMALL),
        Mesh(dev, ("dp", "sp", "tp", "pp", "ep")), seed=11)
    ct = T.TransformerConfig(**SMALL)
    jside = _Side(jmx, jtm, "jax", blob, pj, J.TransformerConfig(**SMALL),
                  art)
    pside = _Side(pmx, ptm, "torch", blob,
                  T.init_transformer_params_np(ct, seed=11, device="cpu"),
                  ct, art)
    pside.tmp = tmp
    pside.qp = qp
    yield jside, pside
    jside.close()
    pside.close()


def _request(srv, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                      timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _get(srv, path):
    return _request(srv, "GET", path)


def _post(srv, path, payload, headers=None):
    body = payload if isinstance(payload, bytes) \
        else json.dumps(payload).encode()
    return _request(srv, "POST", path, body, headers)


def _predict(srv, rows, **kw):
    st, hd, body = _post(srv, "/predict", {"data": rows.tolist()}, **kw)
    assert st == 200, body
    return np.asarray(json.loads(body)["outputs"][0], np.float32), hd


# ---------------------------------------------------------------------------
# the two packages answer alike
# ---------------------------------------------------------------------------

def test_healthz_warming_then_ok(sides):
    for side in sides:
        assert side.healthz_cold[:1] == (503,)
        assert side.healthz_cold[2] == b"warming\n"
        assert _get(side.srv, "/healthz")[::2] == (200, b"ok\n")


def test_predict_outputs_agree(sides):
    jside, pside = sides
    for lo, hi in ((0, 1), (1, 4), (4, 7)):
        a, ha = _predict(jside.srv, X[lo:hi],
                         headers={"X-Request-Id": "req-%d" % lo})
        b, hb = _predict(pside.srv, X[lo:hi],
                         headers={"X-Request-Id": "req-%d" % lo})
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
        assert ha["X-Request-Id"] == hb["X-Request-Id"] == "req-%d" % lo
    # a malformed id is replaced by a fresh trace id (never echoed)
    _, hd = _predict(pside.srv, X[:1], headers={"X-Request-Id": "a b"})
    assert hd["X-Request-Id"] != "a b" and len(hd["X-Request-Id"]) == 32


def _tree(srv, rid):
    st, _, body = _get(srv, "/traces?id=%s" % rid)
    assert st == 200
    spans = json.loads(body)["spans"]
    name = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], name.get(s["parent_id"])) for s in spans)


def test_serve_spans_nest_in_the_request_span_alike(sides):
    trees = []
    for side in sides:
        _predict(side.srv, X[:2], headers={"X-Request-Id": "tree-1"})
        trees.append(_tree(side.srv, "tree-1"))
    assert trees[1] == trees[0]
    assert ("serve.batch", "http.request") in trees[1]
    assert ("serve.compute", "serve.batch") in trees[1]
    assert ("serve.queue_wait", "http.request") in trees[1]


def _generate(srv, prompt, mn, stream=True):
    st, hd, body = _post(srv, "/generate", {"prompt": prompt,
                                            "max_new_tokens": mn,
                                            "stream": stream})
    assert st == 200, body
    return body.decode().splitlines(), hd


def test_generate_streams_equal(sides):
    jside, pside = sides
    for prompt, mn in _prompts():
        a, ha = _generate(jside.srv, prompt, mn)
        b, hb = _generate(pside.srv, prompt, mn)
        assert b == a
        assert json.loads(b[-1]) == {"done": True, "n": mn}
        assert hb["Transfer-Encoding"] == "chunked"
        c, _ = _generate(jside.srv, prompt, mn, stream=False)
        d, _ = _generate(pside.srv, prompt, mn, stream=False)
        assert d == c
        assert json.loads(d[0])["tokens"] == [json.loads(x)["token"]
                                             for x in b[:-1]]


BAD = [("POST", "/predict", b"not json"),
       ("POST", "/predict", b'{"inputs": {"nope": [[1]]}}'),
       ("POST", "/predict", b'{"data": [[1, 2]]}'),
       ("POST", "/generate", b'{"prompt": []}'),
       ("POST", "/generate", b'{"prompt": ["a"]}'),
       ("POST", "/generate", b'{"prompt": [1], "max_new_tokens": "x"}'),
       ("POST", "/generate", b'{"prompt": [999]}'),
       ("POST", "/nope", b"{}"),
       ("GET", "/nope", None)]


@pytest.mark.parametrize("method,path,body", BAD)
def test_client_errors_match(sides, method, path, body):
    got = [_request(side.srv, method, path, body) for side in sides]
    assert got[1][0] == got[0][0] and got[1][0] in (400, 404)
    assert got[1][2] == got[0][2]


def _cold(mx, pkg, params, cfg, blob):
    """A never-started engine (queue depth 1) and a decode engine whose
    page pool holds 3 pages, behind one server."""
    pred = mx.serving.Predictor(_mlp(mx).tojson(), blob, dev_type=1,
                                input_shapes={"data": (1, IN)})
    eng = mx.serve.InferenceEngine(pred, mx.serve.ServeConfig(
        max_batch=4, queue_depth=1))
    kw = {} if pkg == "jax" else {"device": "cpu"}
    dec = mx.serve.DecodeEngine(params, cfg, mx.serve.DecodeConfig(
        **dict(DCFG, num_pages=4)), **kw)
    return mx.serve.serve_http(eng, decode=dec), eng, dec


def test_503_and_504_match(sides):
    jside, pside = sides
    blob = _checkpoint(pside.tmp, 0)[1]
    ct = T.TransformerConfig(**SMALL)
    dev = np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1)
    pj, _ = J.init_transformer_params(
        J.TransformerConfig(**SMALL),
        Mesh(dev, ("dp", "sp", "tp", "pp", "ep")), seed=11)
    got = []
    for mx, pkg, params, cfg in (
            (jmx, "jax", pj, J.TransformerConfig(**SMALL)),
            (pmx, "torch",
             T.init_transformer_params_np(ct, seed=11, device="cpu"), ct)):
        srv, eng, dec = _cold(mx, pkg, params, cfg, blob)
        try:
            row = {"inputs": {"data": X[:1].tolist()}, "timeout_ms": 30}
            # nobody pops the queue: the deadline passes (504), and the
            # expired request still holds the queue's one place (503)
            r504 = _post(srv, "/predict", row)
            r503 = _post(srv, "/predict", row)
            pages = _post(srv, "/generate", {"prompt": [1, 2, 3],
                                             "max_new_tokens": 16})
            got.append([(r[0], r[1].get("Retry-After"), r[2])
                        for r in (r504, r503, pages)]
                       + [_get(srv, "/healthz")[::2]])
        finally:
            srv.close()
            eng.close(drain=False)
            dec.close(drain=False)
    assert got[1] == got[0]
    assert [g[0] for g in got[1][:3]] == [504, 503, 503]
    assert b"page pool" in got[1][2][2] and got[1][2][1] == "1"
    assert got[1][3] == (503, b"warming\n")


def _mirrored(side, n):
    """Indices of the requests (of ``n`` sequential ones) that the
    registry mirrored to its shadow engine."""
    def mirrored():
        fam = side.tm.REGISTRY._families.get(
            "quantize/shadow_requests_total")
        return fam.value if fam is not None else 0

    out = []
    for i in range(n):
        before = mirrored()
        _predict(side.srv, X[i % 40:i % 40 + 1])
        if mirrored() > before:
            out.append(i)
    return out


def test_shadow_mirrors_the_same_requests(sides):
    got = []
    for side in sides:
        side.reg.enable_shadow(side.artifact, fraction=0.25)
        try:
            got.append(_mirrored(side, 24))
        finally:
            side.reg.disable_shadow()
        rep = side.reg.shadow_report()
        assert rep["active"] is False and rep["compared_total"] >= 1
    assert got[1] == got[0] and 0 < len(got[1]) < 24
    fam = ptm.REGISTRY._families["quantize/shadow_drift"]
    assert sum(c.count for _l, c in fam.series()) >= len(got[1])


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------

def test_programs_and_cluster_name_their_items(sides):
    for path, item in (("/programs", b"A6"), ("/cluster", b"A16")):
        st, _, body = _get(sides[1].srv, path)
        assert st == 404 and item in body
    st, _, body = _get(sides[1].srv, "/alerts")
    assert st == 200 and "worker_restart_burn" in [
        r["name"] for r in json.loads(body)["rules"]]
    st, _, body = _get(sides[1].srv, "/metrics")
    assert st == 200 and b"mxnet_serving_mfu" in body \
        and b"mxnet_decode_mfu" in body


def test_disconnect_mid_stream_cancels_and_frees_pages(sides):
    pside = sides[1]
    dec = pside.decode
    free0 = dec._pool.free_pages
    gate = threading.Semaphore(0)
    dec.set_iteration_hook(lambda: gate.acquire(timeout=TIMEOUT))
    pre0 = ptm.REGISTRY._families["decode/preempted_total"].value
    try:
        s = socket.create_connection(("127.0.0.1", pside.srv.port),
                                     timeout=TIMEOUT)
        body = json.dumps({"prompt": [1, 2, 3],
                           "max_new_tokens": 16}).encode()
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: %d\r\n\r\n" % len(body) + body)
        gate.release()                    # admission + prefill + a step
        first = s.recv(4096)
        assert b"200 OK" in first
        assert dec._pool.free_pages < free0
        # hang up with a reset: the next chunk write fails
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
        s.close()
        t_end = time.monotonic() + TIMEOUT
        released = 1
        while dec._pool.free_pages < free0 and time.monotonic() < t_end:
            if released < 8:              # well short of 16 tokens
                gate.release()
                released += 1
            time.sleep(0.02)
        # back to the free count within 8 iterations: at most 10 of the
        # 16 tokens were made, so the cancel freed the pages
        assert dec._pool.free_pages == free0 and released < 8
        assert ptm.REGISTRY._families["decode/preempted_total"].value \
            == pre0 + 1
    finally:
        dec.set_iteration_hook(None)
        for _ in range(32):
            gate.release()


def test_swap_under_concurrent_clients_drops_nothing(sides):
    pside = sides[1]
    reg = pside.reg
    _, new_blob = _checkpoint(pside.tmp, 1)
    old_direct = _direct(_checkpoint(pside.tmp, 0)[1], X[:1])
    new_direct = _direct(new_blob, X[:1])
    results, errors = [], []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                st, _, body = _post(pside.srv, "/predict",
                                    {"data": X[:1].tolist()})
                results.append((st, body))
            except Exception as e:     # noqa: BLE001 -- counted below
                errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        t_end = time.monotonic() + TIMEOUT
        while len(results) < 8 and time.monotonic() < t_end:
            time.sleep(0.01)
        swaps0 = ptm.REGISTRY._families["serving/swaps_total"].value
        reg.swap(new_blob)
        n_at_swap = len(results)
        while len(results) < n_at_swap + 8 and time.monotonic() < t_end:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(TIMEOUT)
    assert not errors and all(st == 200 for st, _ in results)
    outs = [np.asarray(json.loads(b)["outputs"][0], np.float32)
            for _, b in results]
    for o in outs:
        assert (np.allclose(o, old_direct, atol=1e-6)
                or np.allclose(o, new_direct, atol=1e-6))
    after, _ = _predict(pside.srv, X[:1])
    np.testing.assert_allclose(after, new_direct, atol=1e-6)
    assert ptm.REGISTRY._families["serving/swaps_total"].value \
        == swaps0 + 1
    reg.swap(_checkpoint(pside.tmp, 0)[1])          # back to the fixture's


def _direct(blob, rows, sym_json=None):
    pred = pmx.serving.Predictor(sym_json or _mlp(pmx).tojson(), blob,
                                 dev_type=1,
                                 input_shapes={"data": rows.shape})
    pred.set_input("data", np.ascontiguousarray(rows).tobytes())
    pred.forward()
    return np.frombuffer(pred.get_output(0), np.float32).reshape(
        pred.get_output_shape(0))


def test_quantized_swap_answers_bitwise_as_the_int8_predictor(sides):
    pside = sides[1]
    qp = pside.qp
    reg = pside.reg
    reg.swap(quantized=qp)
    try:
        assert reg.quantized_active
        for lo, hi in ((0, 1), (1, 4), (9, 12)):
            got, _ = _predict(pside.srv, X[lo:hi])
            want = _direct(qp.param_bytes(), X[lo:hi], qp.symbol_json)
            assert got.tobytes() == want.tobytes()
    finally:
        reg.swap(_checkpoint(pside.tmp, 0)[1])      # roll back
    assert not reg.quantized_active
    assert ptm.snapshot()["quantize_swaps"] >= 1
