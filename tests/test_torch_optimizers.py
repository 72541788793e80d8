"""The port's optimizers, fused update rules and update ops against the
JAX package, on the CPU.

* Every rule (``sgd_fused_update`` / ``_sgd_fused``, ``adam_fused_update``
  / ``_adam_fused``, ``nag_fused_update`` / ``_nag_fused``,
  ``signum_fused_update`` / ``_signum_fused``, ``adagrad_fused_update`` /
  ``_adagrad_fused``, ``rmsprop_fused_update`` / ``_rmsprop_fused`` plain
  and centered, ``adadelta_fused_update`` / ``_adadelta_fused``,
  ``ftrl_fused_update`` / ``_ftrl_fused``, ``ftml_fused_update`` /
  ``_ftml_fused``, ``adamax_fused_update`` / ``_adamax_fused``,
  ``test_fused_update`` / ``_test_fused``) through its optimizer's
  ``fused_apply`` over three tensors for three steps, with wd, an lr
  multiplier and clipping, on float32, bfloat16 and float16 weights. At
  every type the port equals the JAX package's eager rule (fed the JAX
  optimizer's hypers) bitwise, and at bf16 its jitted ``fused_apply``
  bitwise too. At float32 XLA's jit contracts multiply-adds, and at
  float16 it keeps excess precision between operations: each jitted step
  is held within JIT_ULPS ULPs of each value's scale (the largest
  magnitude among its inputs and outputs: ``w + mom`` cancels).
* Each of the 12 update ops (``nd.sgd_update`` ... ``nd.mp_sgd_mom_update``)
  writes its weight and states in place and gives the JAX op's values.
* ``Nadam``, ``DCASGD`` and ``LBSGD`` (linear warm-up with accumulation,
  and LARS) step per parameter as the JAX package's do; ``SGLD``'s noise
  is held by its mean and variance.
* Every optimizer the JAX package registers is created by name here.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import optimizer as topt  # noqa: E402
from mxnet_tpu_torch.ops.cuda import fused_update as tfu  # noqa: E402

SHAPES = [(7,), (33, 9), (4, 3, 5, 5)]
NAMES = {0: "a_weight", 1: "b_bias", 2: "c_weight"}
COMMON = dict(learning_rate=0.05, wd=1e-3, rescale_grad=1.0 / 8,
              clip_gradient=0.1)
# (id, optimizer, its own arguments)
CONFIGS = [
    ("sgd", "sgd", dict(momentum=0.9)),
    ("sgd_stateless", "sgd", {}),
    ("nag", "nag", dict(momentum=0.9)),
    ("nag_stateless", "nag", {}),
    ("signum", "signum", dict(momentum=0.9, wd_lh=0.01)),
    ("signsgd", "signum", dict(momentum=0.0)),
    ("adam", "adam", {}),
    ("adagrad", "adagrad", {}),
    ("rmsprop", "rmsprop", {}),
    ("rmsprop_centered", "rmsprop", dict(centered=True, clip_weights=0.5)),
    ("adadelta", "adadelta", {}),
    ("ftrl", "ftrl", {}),
    ("ftml", "ftml", {}),
    ("adamax", "adamax", {}),
    ("test", "test", {}),
]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
# largest found: 6 (float32, Adam) and 5 (float16, Adam)
JIT_ULPS = {"float32": 8, "float16": 8}
# the JAX update ops run jitted (contracted multiply-adds): largest
# found 2 ULPs of the scale (ftml_update)
OP_ULPS = 2
# Nadam's chained divisions by its schedule's corrections: largest 12
UNFUSED_ULPS = 16


def _opts(name, kw):
    kw = dict(COMMON, param_idx2name=NAMES, **kw)
    made = []
    for mod in (topt, jopt, jopt):
        o = mod.create(name, **kw)
        o.set_lr_mult({"c_weight": 0.5})
        made.append(o)
    return made


def _bits(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.float16:
        return a.view(np.uint16)
    return a.view(np.uint32)


def _equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(got.astype(np.float32)) & np.isnan(
        want.astype(np.float32))
    bad = (_bits(got) != _bits(want)) & ~nan
    assert not bad.any(), "%s: %d of %d values differ" % (
        what, bad.sum(), bad.size)


def _near(got, want, scale, ulps, dtype, what):
    """Within ``ulps`` ULPs (of ``dtype``) of each value's scale."""
    got, want = (np.asarray(x).astype(np.float64) for x in (got, want))
    scale = np.minimum(np.asarray(scale, np.float64), np.finfo(dtype).max / 2)
    with np.errstate(invalid="ignore"):
        spacing = np.spacing(scale.astype(dtype)).astype(np.float64)
        err = np.abs(got - want)
    ok = (got == want) | (err <= ulps * spacing) | (
        np.isnan(got) & np.isnan(want))
    assert ok.all(), "%s: %d values off, %.3g ULPs" % (
        what, (~ok).sum(), np.nanmax(np.where(ok, 0, err / spacing)))


def _steps(rng, n=3):
    return [[rng.randn(*s).astype(np.float32) for s in SHAPES]
            for _ in range(n)]


def _scale(arrays):
    """Each value's scale: the largest magnitude among ``arrays``."""
    return np.max(np.abs(np.stack([np.asarray(a, np.float32)
                                   for a in arrays])), 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cid,name,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_rule_matches_jax(cid, name, kw, dtype):
    """Three steps: the port's ``fused_apply`` (its plain version on CPU
    tensors) against the JAX eager rule over the same three steps, and
    against the JAX ``fused_apply`` step by step (each JAX step starts
    from the port's weights and states)."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(11)
    w0 = [(rng.randn(*s) * 0.1).astype(np.float32) for s in SHAPES]
    grads = _steps(rng)
    to, jo, je = _opts(name, kw)
    tw = [tmx.nd.array(w, ctx=tmx.cpu(), dtype=dtype) for w in w0]
    ts = [to.create_state(i, w) for i, w in enumerate(tw)]
    jw = [jmx.nd.array(w).astype(dtype) for w in w0]
    js = [jo.create_state(i, w) for i, w in enumerate(jw)]
    ew = [jnp.asarray(w).astype(jdt) for w in w0]
    es = [tuple(a._data for a in jopt.fused_state_arrays(
        je.create_state(i, jmx.nd.array(w).astype(dtype))))
        for i, w in enumerate(w0)]
    rule = je.fused_rule()
    for step, gs in enumerate(grads):
        before = [[w.asnumpy()] + [a.asnumpy() for a in
                                   topt.fused_state_arrays(s)]
                  for w, s in zip(tw, ts)]
        topt.fused_apply(to, [(i, w, tmx.nd.array(g, ctx=tmx.cpu(),
                                                  dtype=dtype), s)
                              for i, (w, g, s) in enumerate(zip(tw, gs, ts))])
        assert jopt.fused_apply(jo, [
            (i, w, jmx.nd.array(g).astype(dtype), s)
            for i, (w, g, s) in enumerate(zip(jw, gs, js))])
        new = [rule(w, jnp.asarray(g).astype(jdt), s, je.fused_hyper(i))
               for i, (w, g, s) in enumerate(zip(ew, gs, es))]
        ew, es = [n[0] for n in new], [tuple(n[1]) for n in new]
        for i in range(len(SHAPES)):
            got = [tw[i].asnumpy()] + [a.asnumpy() for a in
                                       topt.fused_state_arrays(ts[i])]
            jarrs = [jw[i]] + list(jopt.fused_state_arrays(js[i]))
            scale = _scale(before[i] + got)
            for k, (a, c) in enumerate(zip(got, jarrs)):
                what = "%s %s step %d tensor %d output %d vs fused_apply" % (
                    cid, dtype, step, i, k)
                c = c.asnumpy()
                if dtype == "bfloat16":
                    _equal(a, c, what)
                else:
                    _near(a, c, scale, JIT_ULPS[dtype], np.dtype(a.dtype),
                          what)
                jarrs[k]._set_data(jnp.asarray(a))   # the next step's start
    assert to._index_update_count == jo._index_update_count
    for i in range(len(SHAPES)):
        got = [tw[i].asnumpy()] + [a.asnumpy() for a in
                                   topt.fused_state_arrays(ts[i])]
        eager = [np.asarray(a) for a in (ew[i],) + es[i]]
        for k, (a, b) in enumerate(zip(got, eager)):
            what = "%s %s tensor %d output %d vs eager" % (cid, dtype, i, k)
            _equal(a, b, what)


def _op_inputs(rng, n_states, dtype=np.float32):
    w = (rng.randn(6, 5) * 0.1).astype(dtype)
    g = rng.randn(6, 5).astype(dtype)
    return w, g, [np.abs(rng.randn(6, 5) * 0.01).astype(np.float32)
                  for _ in range(n_states)]


# (op, states, attrs); the mp ops' weight is float16 beside a float32
# master (their last state)
OPS = [
    ("sgd_update", 0, dict(lr=0.1, wd=1e-3, rescale_grad=0.5)),
    ("sgd_mom_update", 1, dict(lr=0.1, momentum=0.9, wd=1e-3,
                               clip_gradient=0.3)),
    ("nag_mom_update", 1, dict(lr=0.1, momentum=0.9, wd=1e-3)),
    ("adam_update", 2, dict(lr=0.01, wd=1e-3, clip_gradient=0.3)),
    ("rmsprop_update", 1, dict(lr=0.01, gamma1=0.9, clip_weights=0.05)),
    ("rmspropalex_update", 3, dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                   wd=1e-3)),
    ("ftrl_update", 2, dict(lr=0.1, lamda1=0.001, beta=1.0, wd=1e-3)),
    ("ftml_update", 3, dict(lr=0.01, t=3, wd=1e-3, clip_grad=0.3)),
    ("signsgd_update", 0, dict(lr=0.01, wd=1e-3)),
    ("signum_update", 1, dict(lr=0.01, momentum=0.9, wd=1e-3, wd_lh=0.01)),
    ("mp_sgd_update", 1, dict(lr=0.1, wd=1e-3)),
    ("mp_sgd_mom_update", 2, dict(lr=0.1, momentum=0.9, wd=1e-3)),
]


@pytest.mark.parametrize("op,n_states,attrs", OPS, ids=[o[0] for o in OPS])
def test_update_op_matches_jax_in_place(op, n_states, attrs):
    rng = np.random.RandomState(5)
    mp = op.startswith("mp_")
    w, g, states = _op_inputs(rng, n_states,
                              np.float16 if mp else np.float32)
    if mp:
        states[-1] = w.astype(np.float32)
    out = {}
    for key, mx, kw in (("torch", tmx, {"ctx": tmx.cpu()}), ("jax", jmx, {})):
        arrs = [mx.nd.array(a, dtype=a.dtype, **kw) for a in [w, g] + states]
        ret = getattr(mx.nd, op)(*arrs, **attrs)
        assert ret is arrs[0]
        out[key] = [a.asnumpy() for a in [arrs[0]] + arrs[2:]]
    scale = _scale([w, g] + states + out["jax"])
    for k, (a, b) in enumerate(zip(out["torch"], out["jax"])):
        _near(a, b, scale, OP_ULPS, a.dtype, "%s output %d" % (op, k))
    if mp:          # the weight is its master rounded, in both
        _equal(out["torch"][0], out["torch"][-1].astype(np.float16), op)


def _updater_run(mx, name, kw, w0, grads, ctx):
    opt = mx.optimizer.create(name, param_idx2name=NAMES, **kw)
    upd = mx.optimizer.get_updater(opt)
    ws = [mx.nd.array(w, **ctx) for w in w0]
    for gs in grads:
        for i, (w, g) in enumerate(zip(ws, gs)):
            upd(i, mx.nd.array(g, **ctx), w)
    return [w.asnumpy() for w in ws]


@pytest.mark.parametrize("name,kw", [
    ("nadam", dict(learning_rate=0.01, wd=1e-3, clip_gradient=1.0)),
    ("dcasgd", dict(learning_rate=0.05, momentum=0.9, wd=1e-3)),
    ("dcasgd", dict(learning_rate=0.05)),
    ("lbsgd", dict(learning_rate=0.05, momentum=0.9, batch_scale=2,
                   warmup_epochs=1, updates_per_epoch=4)),
    ("lbsgd", dict(learning_rate=0.05, warmup_strategy="lars", wd=1e-3)),
], ids=["nadam", "dcasgd_momentum", "dcasgd", "lbsgd_linear", "lbsgd_lars"])
def test_unfused_optimizers_match_jax(name, kw):
    """No fused rule in either package: per-parameter updates through the
    Updater, four steps, float32; within UNFUSED_ULPS of the weights'
    scale."""
    rng = np.random.RandomState(9)
    w0 = [(rng.randn(*s) * 0.1).astype(np.float32) for s in SHAPES]
    grads = _steps(rng, 4)
    got = _updater_run(tmx, name, kw, w0, grads, {"ctx": tmx.cpu()})
    want = _updater_run(jmx, name, kw, w0, grads, {})
    for i, (a, b) in enumerate(zip(got, want)):
        assert not np.array_equal(a, w0[i]) or name == "lbsgd"
        _near(a, b, np.maximum(np.abs(b), np.abs(w0[i])), UNFUSED_ULPS,
              np.float32, "%s tensor %d" % (name, i))


def test_sgld_noise_mean_and_variance():
    """SGLD with a zero gradient and no wd moves each weight by its noise,
    N(0, lr) (the JAX package's draw): over 2^16 values the mean is
    within 5 standard errors of 0 and the variance within 5% of lr, in
    both packages."""
    lr, n = 0.04, 1 << 16
    for mx, ctx in ((tmx, {"ctx": tmx.cpu()}), (jmx, {})):
        mx.random.seed(3)
        opt = mx.optimizer.create("sgld", learning_rate=lr)
        w = mx.nd.array(np.zeros(n, np.float32), **ctx)
        opt.update(0, w, mx.nd.array(np.zeros(n, np.float32), **ctx), None)
        d = w.asnumpy().astype(np.float64)
        assert abs(d.mean()) <= 5 * np.sqrt(lr / n), d.mean()
        assert abs(d.var() / lr - 1) <= 0.05, d.var()


def test_every_jax_optimizer_is_created_by_name():
    assert sorted(topt.Optimizer.opt_registry) == sorted(
        jopt.Optimizer.opt_registry)
    for name in jopt.Optimizer.opt_registry:
        assert type(topt.create(name)).__name__ == type(
            jopt.create(name)).__name__
    with pytest.raises(ValueError, match="Cannot find optimizer"):
        topt.create("nonesuch")
