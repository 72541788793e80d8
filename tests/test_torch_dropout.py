"""Dropout held to its definition on the CPU, and its random numbers.

The port's masks are not the JAX package's (``jax.random.bernoulli``'s
bits); ``test_torch_ops_surface.py`` holds Dropout against the JAX op
at ``p = 0`` and in predict mode. Here, at ``p > 0``:

* training keeps each value with probability ``1 - p`` (the kept share
  within 4 sigma), as exactly ``x / (1 - p)``, zeroes the rest; ``axes``
  shares one draw along those axes; predict mode and ``p = 0`` are the
  identity, ``mode="always"`` drops in predict mode too;
* the mask comes from the port's generator of the device
  (``random.generator``), never torch's global one: ``random.seed(n)``
  repeats it, successive draws differ, and torch's own seed changes
  nothing;
* the gradient uses the forward's mask, through ``nd``, through a
  hybridized block (whose CPU evaluation draws the eager call's masks)
  and through the executor: ``train_step`` draws once a step, and a
  ``backward`` that has to run the forward again replays the draws of
  the last training ``forward``;
* shape inference draws nothing.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx

P = 0.5
N = 20000


def _x(shape=(N,), seed=0):
    return tmx.nd.array(np.random.RandomState(seed).uniform(
        0.5, 1.5, shape).astype(np.float32), ctx=tmx.cpu())


def _drop(x, **kw):
    with tmx.autograd.train_mode():
        return tmx.nd.Dropout(x, **kw)


@pytest.mark.parametrize("p", [0.5, 0.2, 0.9])
def test_training_keeps_a_share_and_scales_exactly(p):
    x = _x()
    y = _drop(x, p=p).asnumpy()
    xs = x.asnumpy()
    kept = y != 0
    share = kept.mean()
    sigma = np.sqrt(p * (1 - p) / N)
    assert abs(share - (1 - p)) <= 4 * sigma
    np.testing.assert_array_equal(y[kept], (xs * np.float32(
        np.float32(1.0) / np.float32(1 - p)))[kept])
    if p == 0.5:
        np.testing.assert_array_equal(y[kept], xs[kept] / np.float32(0.5))


def test_axes_share_one_draw():
    x = _x((8, 6, 5))
    y = _drop(x, p=P, axes=(1,)).asnumpy()
    kept = y != 0
    assert (kept == kept[:, :1, :]).all()
    assert 0 < kept.mean() < 1


def test_identity_in_predict_mode_and_at_p_zero():
    x = _x((100,))
    with tmx.autograd.predict_mode():
        np.testing.assert_array_equal(tmx.nd.Dropout(x, p=P).asnumpy(),
                                      x.asnumpy())
        dropped = tmx.nd.Dropout(x, p=P, mode="always").asnumpy()
        assert (dropped == 0).any()
    np.testing.assert_array_equal(_drop(x, p=0.0).asnumpy(), x.asnumpy())


def test_masks_follow_the_ports_generator():
    x = _x((1000,))
    tmx.random.seed(11)
    a, b = _drop(x, p=P).asnumpy(), _drop(x, p=P).asnumpy()
    assert not np.array_equal(a, b)
    tmx.random.seed(11)
    torch.manual_seed(1234)             # torch's own generator: no effect
    np.testing.assert_array_equal(_drop(x, p=P).asnumpy(), a)
    np.testing.assert_array_equal(_drop(x, p=P).asnumpy(), b)


def test_backward_uses_the_forwards_mask():
    x = _x((500,))
    x.attach_grad()
    head = np.random.RandomState(2).uniform(-1, 1, 500).astype(np.float32)
    with tmx.autograd.record():
        y = tmx.nd.Dropout(x, p=P)
    y.backward(tmx.nd.array(head, ctx=tmx.cpu()))
    mask = (y.asnumpy() != 0).astype(np.float32) / np.float32(0.5)
    np.testing.assert_array_equal(x.grad.asnumpy(), head * mask)


def _dropout_block():
    class Drop(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.Dropout(x * 2.0, p=P) + F.Dropout(x, 0.25)
    return Drop()


def test_hybridized_masks_repeat_after_a_reseed_and_match_eager():
    x = _x((2, 300))
    outs = {}
    for hybridize in (False, True):
        net = _dropout_block()
        net.initialize(ctx=tmx.cpu())
        if hybridize:
            net.hybridize()
        runs = []
        for _ in range(2):
            tmx.random.seed(5)
            x.attach_grad()
            with tmx.autograd.record():
                y = net(x)
            y.backward()
            runs.append((y.asnumpy(), x.grad.asnumpy()))
            with tmx.autograd.record():
                z = net(x)
            assert not np.array_equal(z.asnumpy(), y.asnumpy())
        np.testing.assert_array_equal(runs[0][0], runs[1][0])
        np.testing.assert_array_equal(runs[0][1], runs[1][1])
        outs[hybridize] = runs[0]
    np.testing.assert_array_equal(outs[True][0], outs[False][0])
    np.testing.assert_array_equal(outs[True][1], outs[False][1])


def _executor(batch=4):
    data = tmx.sym.var("data")
    net = tmx.sym.Dropout(tmx.sym.FullyConnected(data, num_hidden=64,
                                                 name="fc"), p=P)
    ex = net.simple_bind(ctx=tmx.cpu(), data=(batch, 8))
    rng = np.random.RandomState(3)
    ex.arg_dict["data"][:] = rng.uniform(-1, 1, (batch, 8)).astype(
        np.float32)
    ex.arg_dict["fc_weight"][:] = rng.uniform(-1, 1, (64, 8)).astype(
        np.float32)
    return ex


def test_executor_backward_replays_the_forwards_draws():
    ex = _executor()
    tmx.random.seed(9)
    (out,) = ex.forward(is_train=True)
    ex.backward()
    first = ex.grad_dict["fc_weight"].asnumpy().copy()
    ex.backward()       # its graph is gone: runs the forward again
    np.testing.assert_array_equal(ex.grad_dict["fc_weight"].asnumpy(),
                                  first)
    # the gradient is the mask's: rows of dropped units are zero
    kept = (out.asnumpy() != 0).any(axis=0)
    assert (np.abs(first[~kept]).sum() == 0) and kept.any() \
        and not kept.all()
    (again,) = ex.forward(is_train=True)
    assert not np.array_equal(again.asnumpy(), out.asnumpy())


def test_train_step_draws_one_mask_a_step():
    steps = []
    for _ in range(2):
        ex = _executor(batch=1)
        tmx.random.seed(9)
        w0 = ex.arg_dict["fc_weight"].asnumpy().copy()
        outs = []
        for _ in range(2):
            def rule(ws, gs, states, hypers):
                for w, g in zip(ws, gs):
                    w.sub_(0.1 * g)
            (o,) = ex.train_step(rule, ["fc_weight"], {"fc_weight": ()},
                                 {"fc_weight": {}})
            outs.append(o.asnumpy())
        steps.append((outs, ex.arg_dict["fc_weight"].asnumpy()))
        moved = np.abs(steps[-1][1] - w0).sum(axis=1)
        # an update touches only the units some step's mask kept
        kept = (outs[0] != 0).any(axis=0) | (outs[1] != 0).any(axis=0)
        assert (moved[~kept] == 0).all() and (moved[kept] > 0).all()
        assert not kept.all()
    assert not np.array_equal((steps[0][0][0] != 0), (steps[0][0][1] != 0))
    np.testing.assert_array_equal(steps[0][0][0], steps[1][0][0])
    np.testing.assert_array_equal(steps[0][1], steps[1][1])


def test_shape_inference_draws_nothing():
    net = tmx.sym.Dropout(tmx.sym.var("data"), p=P, mode="always")
    gen = tmx.random.generator("cpu")
    before = gen.get_state().clone()
    assert net.infer_shape(data=(3, 4))[1] == [(3, 4)]
    assert torch.equal(gen.get_state(), before)
