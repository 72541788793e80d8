"""The port's fused optimizer updates against the JAX package.

``sgd_fused_update`` and ``adam_fused_update`` of
``mxnet_tpu_torch.ops.cuda.fused_update`` take whole parameter lists
(one kernel launch on the card). Their plain PyTorch versions
(``_sgd_fused``, ``_adam_fused``), which the wrappers run for CPU
tensors, are held against the JAX package's twins (``_sgd_fused_xla``,
``_adam_fused_xla``: the optimizer's own rules) and its Pallas kernel in
interpret mode, on the same numpy-seeded inputs and hypers (Adam's from
``Adam.fused_hyper``, whose bookkeeping the port's must reproduce). The
bound is the JAX package's own for its interpreter against its twin
(tests/test_pallas_kernels.py:163) restated for cancellation: within 4
ULPs of the largest magnitude among each element's inputs and outputs
(an f32 multiply-add contracted or not changes ``mom`` by an ULP, and
``w + mom`` can cancel, so that ULP may be many ULPs of a small
result). (Against the eager XLA twin the SGD rules come out bitwise
here; Adam's sqrt and division do not.) A list must give what the
per-tensor calls give, bitwise; CPU tensors must launch nothing; bad
arguments must raise. The CUDA kernel
is held against these plain versions on the card, bitwise, by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops.pallas import fused_update as jfu  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402

from mxnet_tpu_torch import optimizer as topt  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops.cuda import _build  # noqa: E402
from mxnet_tpu_torch.ops.cuda import fused_update as tfu  # noqa: E402

SHAPES = [(7,), (1000,), (64, 3, 7, 7)]     # ragged, long, a conv weight
SGD_H = {"lr": 0.1, "wd": 1e-4, "rescale_grad": 1.0 / 32, "momentum": 0.9}


def _case(seed, shape, kind):
    rng = np.random.RandomState(seed)
    w = (rng.randn(*shape) * 0.1).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    if kind == "sgd":
        return w, g, ()
    if kind == "sgd_mom":
        return w, g, ((rng.randn(*shape) * 0.01).astype(np.float32),)
    return w, g, ((rng.randn(*shape) * 0.01).astype(np.float32),
                  (np.abs(rng.randn(*shape)) * 1e-3).astype(np.float32))


def _port(kind, w, g, state, h):
    """The port's wrapper on CPU tensors (its plain version), in place."""
    tw = torch.from_numpy(w.copy())
    ts = tuple(torch.from_numpy(s.copy()) for s in state)
    rule = tfu.adam_fused_update if kind == "adam" else tfu.sgd_fused_update
    rule([tw], [torch.from_numpy(g)], [ts], [h])
    return tw.numpy(), [s.numpy() for s in ts]


def _close(got, want, inputs):
    """Within 4 ULPs of the largest magnitude among each element's
    inputs and outputs (weight and states): the update ``w + mom``
    cancels, so an ULP of ``mom`` can be many ULPs of a small result."""
    outs = [got[0]] + list(got[1])
    refs = [np.asarray(b) for b in [want[0]] + list(want[1])]
    assert len(outs) == len(refs) == len(inputs)
    scale = np.max(np.abs(np.stack(refs + list(inputs))), axis=0)
    ulp = np.spacing(scale.astype(np.float32))
    for a, b in zip(outs, refs):
        assert np.all(np.abs(a - b) <= 4 * ulp), np.max(np.abs(a - b) / ulp)


def _adam_hypers(steps):
    """Adam.fused_hyper of index 0 after ``steps`` calls, from both
    packages' optimizers (lr bias-corrected per step)."""
    kw = dict(learning_rate=0.01, wd=1e-3, rescale_grad=1.0 / 16,
              param_idx2name={0: "fc_weight"})
    jo, to = jopt.Adam(**kw), topt.Adam(**kw)
    for _ in range(steps):
        hj, ht = jo.fused_hyper(0), to.fused_hyper(0)
    return hj, ht


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind,clip", [("sgd_mom", False), ("sgd_mom", True),
                                       ("sgd", False)])
def test_sgd_fused_plain_matches_xla_twin_and_pallas(shape, kind, clip):
    w, g, state = _case(1, shape, kind)
    h = dict(SGD_H)
    if clip:
        h["clip_gradient"] = 0.02        # clips about half of g / 32
    if kind == "sgd":
        del h["momentum"]
    got = _port(kind, w, g, state, h)
    jstate = tuple(jnp.asarray(s) for s in state)
    _close(got, jfu._sgd_fused_xla(jnp.asarray(w), jnp.asarray(g), jstate,
                                   h), (w,) + state)
    _close(got, jfu.sgd_fused_update(jnp.asarray(w), jnp.asarray(g), jstate,
                                     h, interpret=True), (w,) + state)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("steps", [1, 3])
def test_adam_fused_plain_matches_xla_twin_and_pallas(shape, steps):
    hj, ht = _adam_hypers(steps)
    assert ht == hj                     # the port's bookkeeping is JAX's
    w, g, state = _case(2, shape, "adam")
    got = _port("adam", w, g, state, ht)
    jstate = tuple(jnp.asarray(s) for s in state)
    _close(got, jfu._adam_fused_xla(jnp.asarray(w), jnp.asarray(g), jstate,
                                    hj), (w,) + state)
    _close(got, jfu.adam_fused_update(jnp.asarray(w), jnp.asarray(g),
                                      jstate, hj, interpret=True),
           (w,) + state)


def test_adam_fused_with_clip_matches_xla_twin():
    _, h = _adam_hypers(2)
    h = dict(h, clip_gradient=0.05)
    w, g, state = _case(3, (33, 9), "adam")
    got = _port("adam", w, g, state, h)
    _close(got, jfu._adam_fused_xla(jnp.asarray(w), jnp.asarray(g),
                                    tuple(jnp.asarray(s) for s in state), h),
           (w,) + state)


@pytest.mark.parametrize("kind", ["sgd_mom", "sgd", "adam"])
def test_list_equals_per_tensor_calls(kind):
    """One call over a list (the kernel's one launch on the card) is the
    per-tensor calls, bitwise, with lr and wd differing per tensor."""
    cases = [_case(10 + i, s, kind) for i, s in enumerate(SHAPES)]
    hypers = []
    for i in range(len(SHAPES)):
        if kind == "adam":
            h = dict(_adam_hypers(2)[1], lr=1e-3 * (i + 1), wd=1e-4 * i)
        else:
            h = dict(SGD_H, lr=0.05 * (i + 1), wd=1e-4 * i)
            if kind == "sgd":
                del h["momentum"]
        hypers.append(h)
    per = [_port(kind, w, g, s, h) for (w, g, s), h in zip(cases, hypers)]
    ws = [torch.from_numpy(w.copy()) for w, _, _ in cases]
    states = [tuple(torch.from_numpy(x.copy()) for x in s)
              for _, _, s in cases]
    rule = tfu.adam_fused_update if kind == "adam" else tfu.sgd_fused_update
    rule(ws, [torch.from_numpy(g) for _, g, _ in cases], states, hypers)
    for (pw, ps), w, s in zip(per, ws, states):
        assert np.array_equal(pw, w.numpy())
        for a, b in zip(ps, s):
            assert np.array_equal(a, b.numpy())


def test_cpu_tensors_route_to_plain_version_and_launch_nothing(monkeypatch):
    calls = []
    real = tfu._sgd_fused
    monkeypatch.setattr(tfu, "_sgd_fused",
                        lambda *a: calls.append(1) or real(*a))
    tfu.reset_launches()
    loaded = len(_build._loaded)
    w, g, state = _case(4, (5, 3), "sgd_mom")
    _port("sgd_mom", w, g, state, SGD_H)
    assert calls == [1]
    assert set(tfu.LAUNCHES) == set(tfu.CUDA_KERNELS)
    assert not any(tfu.LAUNCHES.values())
    assert len(_build._loaded) == loaded


def _lists(n=2, shape=(4,), dtype=torch.float32, states=1):
    ws = [torch.zeros(shape, dtype=dtype) for _ in range(n)]
    gs = [torch.ones(shape, dtype=dtype) for _ in range(n)]
    st = [tuple(torch.zeros(shape, dtype=dtype) for _ in range(states))
          for _ in range(n)]
    return ws, gs, st, [dict(SGD_H) for _ in range(n)]


@pytest.mark.parametrize("breaker,match", [
    (lambda a: a[0].__setitem__(0, a[0][0].double()), "float32"),
    (lambda a: a[1].__setitem__(1, torch.ones(5)), "shape"),
    (lambda a: a[1].__setitem__(0, torch.ones(8)[::2]), "contiguous"),
    (lambda a: a[2].__setitem__(1, ()), "one kind"),
    (lambda a: a[1].pop(), "grads"),
    (lambda a: a[1].__setitem__(0, np.ones(4, np.float32)), "not a tensor"),
])
def test_bad_arguments_raise(breaker, match):
    args = list(_lists())
    breaker(args)
    with pytest.raises(MXNetError, match=match):
        tfu.sgd_fused_update(*args)


def test_adam_needs_two_states_and_lists_need_tensors():
    with pytest.raises(MXNetError, match="expected 2"):
        tfu.adam_fused_update(*_lists(states=1))
    with pytest.raises(MXNetError, match="empty"):
        tfu.sgd_fused_update([], [], [], [])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_master_mode_takes_other_weight_types_in_sgd_only(dtype):
    """A float32 master beside a float32 or bf16 weight (what the mp_sgd
    ops pass) updates in SGD and SGD with momentum; every other rule takes
    masters beside float16 weights only."""
    for states in (0, 1):
        ws, gs, st, hs = _lists(dtype=dtype, states=states)
        st = [tuple(s.float() for s in t) for t in st]
        ms = [w.float() for w in ws]
        tfu.sgd_fused_update(ws, gs, st, hs, ms)
        assert all(torch.equal(w, m.to(dtype)) and bool((m < 0).all())
                   for w, m in zip(ws, ms))
    ws, gs, _, _ = _lists(dtype=dtype)
    st = [(torch.zeros(4), torch.zeros(4)) for _ in ws]
    hs = [dict(SGD_H, beta1=0.9, one_minus_beta1=0.1, beta2=0.999,
               one_minus_beta2=1e-3, epsilon=1e-8) for _ in ws]
    with pytest.raises(MXNetError, match="float16 weights"):
        tfu.adam_fused_update(ws, gs, st, hs, [w.float() for w in ws])


def _find_tensor(first, n, b):
    """The kernel's block-to-tensor search: the last t with first[t] <= b."""
    lo, hi = 0, n - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("numels", [[7, 5000, 0, 9000], [0, 4096, 4097],
                                    [1, 2, 3, 0]])
def test_launch_table_covers_every_chunk_once(numels):
    """The one table a launch uploads: shared scalars, per tensor its
    pointers, size, lr and wd, and the chunk prefix by which each block
    finds its tensor; every chunk of every tensor (empty ones have none)
    is one block's, once."""
    n = len(numels)
    ws = [torch.zeros(k) for k in numels]
    gs = [torch.zeros(k) for k in numels]
    st = [(torch.zeros(k),) for k in numels]
    hs = [dict(SGD_H, lr=0.1 * (i + 1), wd=1e-4 * i) for i in range(n)]
    buf, n_blocks, flags = tfu._pack("sgd_fused_update", "sgd_mom", ws, gs,
                                     st, hs)
    assert not flags
    sh, eb = tfu._SHARED_BYTES, tfu._ENTRY_BYTES
    assert buf[:sh].view(np.float32)[:3].tolist() == [
        np.float32(SGD_H["rescale_grad"]), 0.0, np.float32(0.9)]
    end = sh + eb * n
    ent = buf[sh:end].view(np.int64).reshape(n, eb // 8)
    assert ent[:, 0].tolist() == [w.data_ptr() for w in ws]
    assert ent[:, 1].tolist() == [g.data_ptr() for g in gs]
    assert ent[:, 2].tolist() == [s[0].data_ptr() for s in st]
    assert ent[:, 3:6].tolist() == [[0, 0, 0]] * n
    assert ent[:, 6].tolist() == numels
    f32 = buf[sh:end].view(np.float32).reshape(n, eb // 4)
    assert np.array_equal(f32[:, 14:16],
                          np.array([(h["lr"], h["wd"]) for h in hs],
                                   np.float32))
    assert buf[sh:end].view(np.int32).reshape(n, eb // 4)[:, 18].tolist() \
        == [0] * n                      # float32 weights, no master
    first = buf[end:].view(np.int32)
    assert len(first) == n + 1 and first[-1] == n_blocks
    seen = [(t, b - first[t]) for b in range(n_blocks)
            for t in [_find_tensor(first, n, b)]]
    want = [(t, c) for t, k in enumerate(numels)
            for c in range(-(-k // tfu.CHUNK))]
    assert seen == want


def test_knob_routes_rules_to_kernel_wrapper_or_plain(monkeypatch):
    """The rules are always the kernel wrappers (which take the plain
    version for CPU tensors only); the knob cannot pin the plain rule,
    which would run eagerly on the card: 0 raises."""
    sgd, adam = topt.SGD(momentum=0.9), topt.Adam()
    assert sgd.fused_rule() is tfu.sgd_fused_update
    assert adam.fused_rule() is tfu.adam_fused_update
    monkeypatch.setenv("MXNET_PALLAS_FUSED_UPDATE", "0")
    for opt in (sgd, adam):
        with pytest.raises(MXNetError, match="MXNET_PALLAS_FUSED_UPDATE"):
            opt.fused_rule()


def test_unfused_update_is_the_fused_rule_on_one_tensor():
    """Optimizer.update (the per-parameter path) advances the same
    bookkeeping and computes the same function as the fused rule."""
    from mxnet_tpu_torch.ndarray import NDArray
    w, g, (m,) = _case(5, (6, 4), "sgd_mom")
    o1 = topt.SGD(momentum=0.9, learning_rate=0.1, wd=1e-4,
                  param_idx2name={0: "fc_weight"})
    o2 = topt.SGD(momentum=0.9, learning_rate=0.1, wd=1e-4,
                  param_idx2name={0: "fc_weight"})
    a, am = NDArray(torch.from_numpy(w.copy())), NDArray(
        torch.from_numpy(m.copy()))
    o1.update(0, a, NDArray(torch.from_numpy(g)), am)
    got = _port("sgd_mom", w, g, (m,), o2.fused_hyper(0))
    assert np.array_equal(a.asnumpy(), got[0])
    assert np.array_equal(am.asnumpy(), got[1][0])
    assert o1._index_update_count == o2._index_update_count == {0: 1}
