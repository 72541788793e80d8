"""The port's CTC against the JAX package's: the ``CTCLoss`` op (and its
names ``ctc_loss``, ``_contrib_CTCLoss``, ``_contrib_ctc_loss``) and
``gluon.loss.CTCLoss``.

Activations are numpy-seeded normals; labels are random classes of random
lengths, padded at the end. Held, at three shapes, with ``blank_label``
"first" (labels 1..A-1, padded with 0 or -1) and "last" (labels 0..A-2,
padded with -1), without lengths and with data and label lengths: the
loss of each sequence, and the gradient of their weighted sum to the
activations, within ``TOL`` = 1e-5 of the largest magnitude of the JAX
value (float32 log-sum-exp recursions over at most 12 steps). The
Gluon loss is held in both layouts, eager and hybridized, with and
without lengths.

An alignment that cannot exist (three labels, two steps) gives ``inf``
in the port (``torch.ctc_loss``) and a loss of about 1e30 in the JAX
package (its ``-1e30`` floor): both are held to say "impossible".
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402

TOL = 1e-5
# (T, N, A, max label length)
SHAPES = [(8, 3, 5, 3), (12, 2, 7, 5), (5, 4, 4, 2)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _arr(mx, a):
    return mx.nd.array(a, ctx=mx.cpu())


def _case(shape_i, blank_label, pad=-1.0):
    T, N, A, L = SHAPES[shape_i]
    rng = np.random.RandomState(shape_i + 3)
    data = rng.randn(T, N, A).astype(np.float32)
    lens = rng.randint(1, L + 1, N)
    lens[0] = L
    label = np.full((N, L), pad, np.float32)
    lo, hi = (1, A) if blank_label == "first" else (0, A - 1)
    for i, n in enumerate(lens):
        label[i, :n] = rng.randint(lo, hi, n)
    if N > 1:
        label[1, :2] = label[1, 0]      # a repeat: needs a blank between
        lens[1] = max(lens[1], 2)
    data_lens = rng.randint(T - 2, T + 1, N).astype(np.float32)
    return data, label, lens.astype(np.float32), data_lens


def _run_op(mx, name, data, label, lens, data_lens, attrs):
    d = _arr(mx, data)
    d.attach_grad()
    arrays = [d, _arr(mx, label)]
    if attrs.get("use_data_lengths") or attrs.get("use_label_lengths"):
        arrays += [_arr(mx, data_lens), _arr(mx, lens)]
    with mx.autograd.record():
        loss = mx.nd.invoke_op(name, arrays, attrs) if mx is tmx else \
            getattr(mx.nd, name)(*arrays, **attrs)
        w = _arr(mx, np.linspace(0.5, 1.5, loss.size, dtype=np.float32))
        (loss * w).sum().backward()
    return loss.asnumpy(), d.grad.asnumpy()


OP_CASES = [(i, b, lengths) for i in range(3) for b in ("first", "last")
            for lengths in ("none", "both", "data")]


@pytest.mark.parametrize("shape_i,blank_label,lengths", OP_CASES, ids=[
    "%d-%s-%s" % c for c in OP_CASES])
def test_ctc_op_matches_jax(shape_i, blank_label, lengths):
    data, label, lens, data_lens = _case(shape_i, blank_label)
    attrs = {"blank_label": blank_label}
    if lengths in ("both", "data"):
        attrs["use_data_lengths"] = True
    if lengths == "both":
        attrs["use_label_lengths"] = True
    want = _run_op(jmx, "CTCLoss", data, label, lens, data_lens, attrs)
    got = _run_op(tmx, "CTCLoss", data, label, lens, data_lens, attrs)
    assert got[0].shape == want[0].shape == (data.shape[1],)
    assert np.all(np.isfinite(got[0]))
    assert _rel(got[0], want[0]) <= TOL, (got[0], want[0])
    assert _rel(got[1], want[1]) <= TOL


@pytest.mark.parametrize("name", ["ctc_loss", "_contrib_CTCLoss",
                                  "_contrib_ctc_loss"])
def test_ctc_aliases(name):
    data, label, lens, data_lens = _case(0, "first", pad=0.0)
    want = _run_op(jmx, "CTCLoss", data, label, lens, data_lens, {})
    got = _run_op(tmx, name, data, label, lens, data_lens, {})
    assert _rel(got[0], want[0]) <= TOL and _rel(got[1], want[1]) <= TOL


def test_impossible_alignment():
    """Three distinct labels cannot align with two steps: ``inf`` in the
    port, ~1e30 in the JAX package; a possible row beside it is equal."""
    rng = np.random.RandomState(1)
    data = rng.randn(2, 2, 5).astype(np.float32)
    label = np.array([[1, 2, 3], [4, -1, -1]], np.float32)
    j = jmx.nd.CTCLoss(_arr(jmx, data), _arr(jmx, label)).asnumpy()
    t = tmx.nd.CTCLoss(_arr(tmx, data), _arr(tmx, label)).asnumpy()
    assert np.isinf(t[0]) and t[0] > 0
    assert np.isfinite(j[0]) and j[0] >= 1e29
    assert abs(t[1] - j[1]) <= TOL * abs(j[1])


def _gluon_run(mx, loss_fn, pred, label, pl, ll, hybrid=False):
    if hybrid:
        loss_fn.hybridize()
    p = _arr(mx, pred)
    p.attach_grad()
    args = [p, _arr(mx, label)]
    if pl is not None or ll is not None:
        args.append(None if pl is None else _arr(mx, pl))
    if ll is not None:
        args.append(_arr(mx, ll))
    with mx.autograd.record():
        loss = loss_fn(*args)
    loss.backward()
    return loss.asnumpy(), p.grad.asnumpy()


GLUON_CASES = [(layout, lengths, hybrid) for layout in ("NTC", "TNC")
               for lengths in (False, True) for hybrid in (False, True)]


@pytest.mark.parametrize("layout,lengths,hybrid", GLUON_CASES, ids=[
    "%s-%s-%s" % (l, "lengths" if n else "nolengths",
                  "hybrid" if h else "eager") for l, n, h in GLUON_CASES])
def test_gluon_ctc_loss_matches_jax(layout, lengths, hybrid):
    data, label, lens, data_lens = _case(1, "first")
    pred = data.swapaxes(0, 1) if layout == "NTC" else data
    lab = label if layout == "NTC" else label.T.copy()
    label_layout = "NT" if layout == "NTC" else "TN"
    pl, ll = (data_lens, lens) if lengths else (None, None)
    want = _gluon_run(jmx, jmx.gluon.loss.CTCLoss(layout, label_layout),
                      pred, lab, pl, ll)
    got = _gluon_run(tmx, tmx.gluon.loss.CTCLoss(layout, label_layout),
                     pred, lab, pl, ll, hybrid)
    assert _rel(got[0], want[0]) <= TOL and _rel(got[1], want[1]) <= TOL


def test_gluon_ctc_label_lengths_alone():
    """Label lengths alone count in the port's loss; the JAX package's
    loss drops them (its keyword arrays fill the op's slots in order), so
    the port's loss is held against the JAX op given both lengths, the
    data's all T, and differs from the loss without the label lengths."""
    data, label, lens, _ = _case(0, "first")
    lens[0] -= 1                     # one label fewer than the padding says
    T, N = data.shape[:2]
    pred = data.swapaxes(0, 1)
    got = _gluon_run(tmx, tmx.gluon.loss.CTCLoss(), pred, label, None, lens)
    want = _run_op(jmx, "CTCLoss", data, label, lens,
                   np.full(N, T, np.float32),
                   {"use_data_lengths": True, "use_label_lengths": True})
    assert _rel(got[0], want[0]) <= TOL
    dropped = _run_op(jmx, "CTCLoss", data, label, lens, None, {})[0]
    assert abs(dropped[0] - got[0][0]) > 1e-2
