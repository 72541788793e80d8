"""The port's core op surface against the JAX package's ops, on the CPU.

Every name that the JAX package registers in ``ops/{creation,elemwise,
reduce,matrix,nn}.py`` (less RNN, SyncBatchNorm and the two contrib
resizes, which are queued elsewhere) is in the port's registry, ``nd``
and ``sym``, and has one parametrised case here (an alias runs its
target's case under its own name). A case runs at three shapes (or
attribute sets), on the same numpy-seeded inputs in both packages:

* the forward: integer and index outputs bitwise and of the same type;
  float32 outputs within 1e-6 of the output's largest magnitude
  (``erfinv``, ``gamma`` and ``gammaln`` 1e-5);
* the gradient of ``sum(out * head)`` (a seeded head) with respect to
  every float input, within 1e-5 of its largest magnitude, where the
  JAX op is differentiable; where it is not, the port's outputs carry no
  gradient at all.

Inputs stay off kinks and ties where the two packages' gradients or
orders legitimately differ (ROADMAP C's caveats), except where ties are
the point (``argmax`` takes the first of equal values in both).
Dropout is held at ``p = 0`` and in predict mode here; at ``p > 0`` its
draws differ from JAX's by design, and ``test_torch_dropout.py`` holds
it to its definition.
"""
import inspect
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.ops import registry as jreg  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402
from torch_op_cases import (DISTINCT, SPECS, attrs_at, close,  # noqa: E402
                            run_case, wanted_grads)

EXCLUDED = {"RNN", "SyncBatchNorm", "_contrib_AdaptiveAvgPooling2D",
            "_contrib_BilinearResize2D"}
CORE_FILES = ("creation.py", "elemwise.py", "reduce.py", "matrix.py",
              "nn.py")
SLOW_TOL = {"erfinv": 1e-5, "gamma": 1e-5, "gammaln": 1e-5}
FWD_TOL, GRAD_TOL = 1e-6, 1e-5


def core_names():
    names = []
    for n in jreg.list_ops():
        f = os.path.basename(inspect.getsourcefile(jreg.get_op(n).fn))
        if f in CORE_FILES and n not in EXCLUDED:
            names.append(n)
    return names


def _case_name(name):
    """The name whose spec ``name`` runs: itself, or the op of the same
    JAX function (an alias)."""
    if name in SPECS:
        return name
    fn = jreg.get_op(name).fn
    for other in SPECS:
        if other in jreg._REGISTRY and jreg.get_op(other).fn is fn:
            return other
    raise KeyError(name)


@pytest.mark.parametrize("name", core_names())
def test_op_matches_jax(name):
    sp = SPECS[_case_name(name)]
    jop = jreg.get_op(name)
    diff = jop.differentiable
    for i, shape in enumerate(sp["shapes"]):
        rng = np.random.RandomState(1000 + i)
        inputs = sp["make"](rng, shape)
        attrs = attrs_at(sp, i)
        floats = [k for k, a in enumerate(inputs) if a.dtype.kind == "f"]
        wanted = wanted_grads(sp, inputs, diff)
        heads = {}
        rng_heads = np.random.RandomState(7 + i)
        j_out, j_grad, _ = run_case(jmx, name, inputs, attrs, wanted, heads,
                                    rng_heads)
        t_out, t_grad, _ = run_case(tmx, name, inputs, attrs, wanted, heads,
                                    rng_heads)
        tol = SLOW_TOL.get(name, FWD_TOL)
        assert len(t_out) == len(j_out)
        for k, (g, w) in enumerate(zip(t_out, j_out)):
            close(g, w, tol, "%s[%d] output %d" % (name, i, k))
        for k, (g, w) in enumerate(zip(t_grad or [], j_grad or [])):
            close(g, w, max(tol, GRAD_TOL),
                   "%s[%d] grad of input %d" % (name, i, wanted[k]))
        if not diff and floats:
            # a non-differentiable op's outputs carry no gradient
            arrs = [tmx.nd.array(a, ctx=tmx.cpu(), dtype=a.dtype)
                    for a in inputs]
            for k in floats:
                arrs[k].attach_grad()
            with tmx.autograd.record():
                out = tmx.nd.invoke_op(name, arrs, attrs)
            for o in (out if isinstance(out, list) else [out]):
                assert not o._data.requires_grad, name


def test_every_core_op_is_in_nd_and_sym():
    names = core_names()
    assert len(names) > 200
    missing = [n for n in names if n not in treg._REGISTRY]
    assert not missing
    assert not [n for n in names if not hasattr(tmx.nd, n)]
    assert not [n for n in names if not hasattr(tmx.sym, n)]
    for n in names:
        assert treg.get_op(n).differentiable == \
            jreg.get_op(n).differentiable, n
        assert treg.get_op(n).needs_rng == jreg.get_op(n).needs_rng, n


@pytest.mark.parametrize("name", ["_contrib_BilinearResize2D",
                                  "SyncBatchNorm",
                                  "_contrib_AdaptiveAvgPooling2D",
                                  "linalg_gemm"])
def test_excluded_ops_raise_naming_their_item(name):
    tag = {"SyncBatchNorm": "A8.3"}.get(name, "A15")
    with pytest.raises(tmx.MXNetError, match="ROADMAP %s" % tag):
        tmx.nd.invoke_op(name, [], {})


def test_topk_gradient_is_zero_as_in_jax():
    """``topk``'s values carry no gradient in either package: the
    gradient of ``topk(x) + x`` is ones."""
    src = DISTINCT(np.random.RandomState(3), (3, 5))[0]
    grads = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        x = mx.nd.array(src, ctx=mx.cpu())
        x.attach_grad()
        with mx.autograd.record():
            y = (mx.nd.topk(x, k=5, ret_typ="value") * 3.0 + x).sum()
        y.backward()
        grads[name] = x.grad.asnumpy()
    np.testing.assert_array_equal(grads["torch"], grads["jax"])
    np.testing.assert_array_equal(grads["torch"], np.ones_like(src))


def test_symbol_ops_infer_and_evaluate_like_nd():
    """New ops in a Symbol: shapes inferred on meta tensors (creation and
    Dropout included), values equal to the nd calls."""
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (2, 6, 4, 4)).astype(np.float32)
    data = tmx.sym.var("data")
    net = tmx.sym.Concat(tmx.sym.LRN(data, nsize=3),
                         tmx.sym.Dropout(data, p=0.5),
                         tmx.sym.LeakyReLU(data, act_type="elu"), dim=1)
    net = tmx.sym.topk(tmx.sym.Flatten(net), k=2, ret_typ="value") + \
        tmx.sym.sum(tmx.sym._ones(shape=(2, 2)), axis=1, keepdims=True)
    _, (out_shape,), _ = net.infer_shape(data=x.shape)
    assert out_shape == (2, 2)
    ex = net.simple_bind(ctx=tmx.cpu(), data=x.shape, grad_req="null")
    (got,) = ex.forward(is_train=False, data=x)
    nd = tmx.nd
    a = nd.array(x, ctx=tmx.cpu())
    want = nd.topk(nd.Flatten(nd.concat(nd.LRN(a, nsize=3), a,
                                        nd.LeakyReLU(a, act_type="elu"),
                                        dim=1)), k=2, ret_typ="value") + 2.0
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6)


def test_ndarray_methods_match_jax():
    """The 19 NDArray methods the port lacked, and ``tostype``."""
    src = DISTINCT(np.random.RandomState(6), (2, 3, 4))[0]
    idx = np.array([2, 0, 1], np.float32)
    calls = [
        ("argmax", dict(axis=1)), ("argmin", dict(axis=2)),
        ("argsort", dict(axis=0)), ("sort", dict(is_ascend=False)),
        ("topk", dict(k=2, ret_typ="value")), ("prod", dict(axis=2)),
        ("sign", {}), ("squeeze", {}), ("swapaxes", dict(dim1=0, dim2=2)),
        ("tile", dict(reps=(1, 2, 1))), ("repeat", dict(repeats=2,
                                                       axis=1)),
        ("broadcast_to", dict(shape=(2, 3, 4))),
        ("slice", dict(begin=(0, None, 3), end=(2, None, 0),
                       step=(1, 2, -1))),
        ("split", dict(num_outputs=3)),
        ("pad", dict(mode="constant", pad_width=(0, 0, 0, 0, 1, 1, 0, 0))),
        ("one_hot", dict(depth=4)), ("take", None), ("dot", None),
        ("broadcast_like", None), ("tostype", dict(stype="default"))]
    for meth, kw in calls:
        res = {}
        for name, mx in (("jax", jmx), ("torch", tmx)):
            a = mx.nd.array(src, ctx=mx.cpu())
            if meth == "take":
                r = a.take(mx.nd.array(idx, ctx=mx.cpu()), axis=1)
            elif meth == "dot":
                r = a.reshape((6, 4)).dot(a.reshape((6, 4)),
                                          transpose_b=True)
            elif meth == "broadcast_like":
                r = a[:, :1].broadcast_like(a)
            elif meth == "pad":
                r = a.reshape((1, 2, 3, 4)).pad(**kw)
            elif meth == "one_hot":
                r = mx.nd.array(idx, ctx=mx.cpu()).one_hot(**kw)
            else:
                r = getattr(a, meth)(**kw)
            r = r if isinstance(r, list) else [r]
            res[name] = [x.asnumpy() for x in r]
        for g, w in zip(res["torch"], res["jax"]):
            close(g, w, FWD_TOL, meth)
    with pytest.raises(tmx.MXNetError, match="A15"):
        tmx.nd.array(src, ctx=tmx.cpu()).tostype("csr")


def test_creation_helpers_and_waitall():
    want = [jmx.nd.arange(2, 9, 2).asnumpy(),
            jmx.nd.full((2, 3), 1.5).asnumpy(),
            jmx.nd.concat(jmx.nd.ones((2, 1)), jmx.nd.zeros((2, 2)),
                          dim=1).asnumpy(),
            jmx.nd.stack(jmx.nd.ones((2,)), jmx.nd.zeros((2,)),
                         axis=1).asnumpy()]
    c = tmx.cpu()
    got = [tmx.nd.arange(2, 9, 2, ctx=c).asnumpy(),
           tmx.nd.full((2, 3), 1.5, ctx=c).asnumpy(),
           tmx.nd.concat(tmx.nd.ones((2, 1), ctx=c),
                         tmx.nd.zeros((2, 2), ctx=c), dim=1).asnumpy(),
           tmx.nd.stack(tmx.nd.ones((2,), ctx=c), tmx.nd.zeros((2,), ctx=c),
                        axis=1).asnumpy()]
    for g, w in zip(got, want):
        close(g, w, 0.0, "creation")
    tmx.nd.waitall()
