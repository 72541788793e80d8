"""The port's imperative API and autograd against the JAX package's.

Each case is one function of the package (``mx``), run on the same
numpy-seeded inputs by ``mxnet_tpu`` and by ``mxnet_tpu_torch`` on the
CPU; its outputs (values and gradients) must agree within 1e-6
(relative and absolute: float32 arithmetic of a few elementwise ops and
small reductions, summed in another order). The port maps the tape onto
``torch.autograd``; these cases pin the MXNet semantics that mapping
must keep: recording only inside ``record()``, train/predict mode,
``head_grads``, ``grad_req`` write / add / null, ``retain_graph``,
``autograd.grad`` (without touching ``.grad``, and with
``create_graph`` for a second derivative), ``autograd.Function``, and
the NDArray operators and generated ``nd.<op>`` functions.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

TOL = 1e-6
RNG = np.random.RandomState(0)
X = RNG.uniform(-1, 1, (3, 4)).astype(np.float32)
W = RNG.uniform(-1, 1, (4, 2)).astype(np.float32)
HEAD = RNG.uniform(-1, 1, (3, 2)).astype(np.float32)
LABEL = np.array([1, 0, 1], np.float32)


def _arr(mx, a, grad=None):
    x = mx.nd.array(a, ctx=mx.cpu())
    if grad is not None:
        x.attach_grad(grad_req=grad)
    return x


def _np(outs):
    return [o.asnumpy() if hasattr(o, "asnumpy") else np.asarray(o)
            for o in outs]


def case_record_and_modes(mx):
    """Gradients of a small network; recording and training flags in
    and out of the scopes."""
    x, w = _arr(mx, X, "write"), _arr(mx, W, "write")
    flags = [mx.autograd.is_recording(), mx.autograd.is_training()]
    with mx.autograd.record():
        flags += [mx.autograd.is_recording(), mx.autograd.is_training()]
        h = mx.nd.relu(mx.nd.FullyConnected(x, w.T, no_bias=True,
                                            num_hidden=2))
        with mx.autograd.pause():
            flags += [mx.autograd.is_recording(), mx.autograd.is_training()]
            skipped = h * 3
        with mx.autograd.predict_mode():
            flags.append(mx.autograd.is_training())
        loss = (mx.nd.log_softmax(h) * h).sum() + (h ** 2).mean()
    with mx.autograd.train_mode():
        flags.append(mx.autograd.is_training())
    loss.backward()
    return [np.array(flags, np.float32), loss, skipped, x.grad, w.grad]


def case_head_grads(mx):
    x, w = _arr(mx, X, "write"), _arr(mx, W, "write")
    with mx.autograd.record():
        y = mx.nd.FullyConnected(x, w.T, no_bias=True, num_hidden=2)
        y = mx.nd.tanh(y) * 2 - 1
    y.backward(_arr(mx, HEAD))
    return [y, x.grad, w.grad]


def case_grad_req_add_and_null(mx):
    x = _arr(mx, X, "add")
    w = _arr(mx, W, "write")
    frozen = _arr(mx, W, "null")
    for scale in (1.0, 0.5):
        with mx.autograd.record():
            y = mx.nd.FullyConnected(x * scale, (w + frozen).T,
                                     no_bias=True, num_hidden=2)
            loss = mx.nd.sum(mx.nd.square(y))
        loss.backward()
    return [x.grad, w.grad, np.float32(frozen.grad is None)]


def case_retain_graph(mx):
    x = _arr(mx, X, "add")
    with mx.autograd.record():
        y = mx.nd.sum(mx.nd.exp(x) * x)
    y.backward(retain_graph=True)
    y.backward()
    return [x.grad]


def case_grad_and_create_graph(mx):
    x = _arr(mx, X, "write")
    with mx.autograd.record():
        y = mx.nd.sum(x * x * x)
        (gx,) = mx.autograd.grad([y], [x], create_graph=True)
        z = mx.nd.sum(gx * gx)
    z.backward()
    x2 = _arr(mx, X, "write")
    with mx.autograd.record():
        y2 = mx.nd.sum(mx.nd.sigmoid(x2) * 3)
    g2 = mx.autograd.grad(y2, x2)
    return [gx, x.grad, g2, x2.grad]


def case_function(mx):
    class Sigmoid(mx.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + mx.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    x = _arr(mx, X, "write")
    with mx.autograd.record():
        y = Sigmoid()(x)
        loss = (y * _arr(mx, X)).sum()
    loss.backward()
    return [y, x.grad]


def case_operators_and_ops(mx):
    a, b = _arr(mx, X, "write"), _arr(mx, X[::-1].copy(), "write")
    with mx.autograd.record():
        outs = [a + b, a - 2, 3 - a, a * b, a / (b + 3), 2 / (a + 3),
                a ** 2, 2 ** a, -a, abs(a), (a > b), (a <= 0.25),
                (a == a), mx.nd.broadcast_maximum(a, b),
                mx.nd.broadcast_minimum(a, b), a.reshape((2, -1)),
                a.reshape((0, 2, -1)), mx.nd.sum(a, axis=1, keepdims=True),
                mx.nd.mean(a, axis=0), mx.nd.sum(a, axis=0, exclude=True),
                mx.nd.norm(a), mx.nd.norm(a, axis=1),
                mx.nd.pick(a, _arr(mx, LABEL), axis=-1),
                mx.nd.pick(a, _arr(mx, np.array([0, 3, 2], np.float32)),
                           axis=1, keepdims=True),
                mx.nd.where(a > 0, a, b), mx.nd.softmax(a, axis=0),
                mx.nd.log_softmax(a), mx.nd.ones_like(a),
                mx.nd.clip(a, -0.5, 0.5), mx.nd.Activation(
                    a, act_type="softrelu"), a.T, a.max(axis=1),
                mx.nd.square(a).sqrt(), mx.nd.log(mx.nd.exp(a))]
        total = outs[0].sum()
        for o in outs[1:]:
            total = total + o.sum()
    total.backward()
    res = _np(outs + [total, a.grad, b.grad])
    a += 1          # in place outside record(); the reference's views
    b *= 2          # (reshape, T) would see it, so read them first
    return res + [a, b]


CASES = [case_record_and_modes, case_head_grads, case_grad_req_add_and_null,
         case_retain_graph, case_grad_and_create_graph, case_function,
         case_operators_and_ops]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_port_matches_jax(case):
    want, got = _np(case(jmx)), _np(case(tmx))
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.shape == g.shape, (i, w.shape, g.shape)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg="output %d" % i)


def test_second_backward_without_retain_graph_raises():
    x = _arr(tmx, X, "write")
    with tmx.autograd.record():
        y = tmx.nd.sum(tmx.nd.exp(x))
    y.backward()
    with pytest.raises(MXNetError, match="retain_graph"):
        y.backward()


def test_backward_outside_record_raises():
    x = _arr(tmx, X, "write")
    y = tmx.nd.sum(x * 2)           # not recorded
    with pytest.raises(MXNetError, match="recorded"):
        y.backward()


def test_no_graph_outside_record():
    x = _arr(tmx, X, "write")
    y = x * 2 + 1
    assert not y._data.requires_grad
    x += 1                          # in place, the leaf is kept
    assert x._data.is_leaf and x._data.requires_grad
    np.testing.assert_array_equal(x.asnumpy(), X + 1)


def test_function_instance_is_single_use():
    class Ident(tmx.autograd.Function):
        def forward(self, x):
            return x

        def backward(self, dy):
            return dy

    f = Ident()
    f(_arr(tmx, X))
    with pytest.raises(MXNetError, match="once"):
        f(_arr(tmx, X))


def test_creation_defaults_to_the_card():
    """Without ``ctx`` an array goes to cuda:0, and without a card that
    raises instead of landing on the host."""
    import torch
    if torch.cuda.is_available():
        assert tmx.nd.array(X).context.type == "cuda"
    else:
        with pytest.raises(MXNetError, match="no CUDA device"):
            tmx.nd.array(X)
    assert tmx.nd.array(X, ctx=tmx.cpu()).context.type == "cpu"
