"""The port's custom operators against the JAX package's.

The cases of tests/test_custom_op_rtc.py that do not need Pallas or
``jax.jit`` (``make_custom_jax_fn`` has no counterpart in the port):
``nd.Custom`` forward and backward under autograd, ``sym.Custom`` with a
positional and a keyword input through the symbol executor, and a
backward that reads ``out_data``. Each case registers the same props in
both packages, runs on the same inputs, and must agree with the JAX
package within 1e-6 (float32 elementwise arithmetic). The port's
executor also takes the custom op's gradient (``Executor.backward``),
which the JAX test does not.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

TOL = 1e-6


def _register(mx):
    @mx.operator.register("scaled_square")
    class ScaledSquareProp(mx.operator.CustomOpProp):
        def __init__(self, scale=2.0):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            scale = self.scale

            class _Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * in_data[0] * scale)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                out_grad[0] * 2.0 * scale * in_data[0])
            return _Op()

    @mx.operator.register("sigmoid_outdata")
    class _SigmoidProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class _Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    self.assign(out_data[0], req[0], mx.nd.array(
                        1.0 / (1.0 + np.exp(-x)), ctx=mx.cpu()))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    y = out_data[0].asnumpy()      # reads out_data
                    g = out_grad[0].asnumpy()
                    self.assign(in_grad[0], req[0],
                                mx.nd.array(g * y * (1 - y), ctx=mx.cpu()))
            return _Op()


_register(jmx)
_register(tmx)

X3 = np.array([1.0, 2.0, -1.5], np.float32)


def _arr(mx, a):
    return mx.nd.array(a, ctx=mx.cpu())


def case_nd_forward(mx):
    return [mx.nd.Custom(_arr(mx, X3), op_type="scaled_square", scale=3.0)]


def case_nd_backward(mx):
    x = _arr(mx, X3)
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="scaled_square", scale=2.0)
        loss = (y * _arr(mx, X3[::-1].copy())).sum()
    loss.backward()
    return [y, x.grad]


def case_backward_reads_out_data(mx):
    x = _arr(mx, np.array([0.5, -1.0, 2.0], np.float32))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="sigmoid_outdata")
        y.sum().backward()
    return [y, x.grad]


def case_symbol_graph(mx):
    data = mx.sym.Variable("data")
    y = mx.sym.Custom(data, op_type="scaled_square", scale=2.0, name="sq")
    exe = y.simple_bind(ctx=mx.cpu(), data=(3,))
    exe.arg_dict["data"][:] = _arr(mx, X3)
    return [exe.forward()[0]]


def case_symbol_kwarg_input(mx):
    data = mx.sym.Variable("data")
    y = mx.sym.Custom(data=data, op_type="scaled_square", scale=3.0)
    exe = y.simple_bind(ctx=mx.cpu(), data=(2,))
    exe.arg_dict["data"][:] = _arr(mx, X3[:2])
    return [exe.forward()[0]]


CASES = [case_nd_forward, case_nd_backward, case_backward_reads_out_data,
         case_symbol_graph, case_symbol_kwarg_input]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_port_matches_jax(case):
    want = [o.asnumpy() for o in case(jmx)]
    got = [o.asnumpy() for o in case(tmx)]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_symbol_executor_takes_the_custom_gradient():
    data = tmx.sym.Variable("data")
    y = tmx.sym.Custom(data, op_type="scaled_square", scale=2.0)
    exe = y.simple_bind(ctx=tmx.cpu(), data=(3,))
    exe.arg_dict["data"][:] = _arr(tmx, X3)
    exe.forward(is_train=True)
    exe.backward(_arr(tmx, np.ones(3, np.float32)))
    np.testing.assert_allclose(exe.grad_dict["data"].asnumpy(), 4.0 * X3,
                               rtol=TOL)
    assert y.list_arguments() == ["data"]
    assert y.infer_shape(data=(5, 2))[1] == [(5, 2)]


def test_unregistered_op_type_raises():
    with pytest.raises(MXNetError, match="not registered"):
        tmx.nd.Custom(_arr(tmx, X3), op_type="no_such_op")
