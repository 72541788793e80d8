"""Faults of the port against the JAX package, held on the CPU.

* ``Trainer.learning_rate`` follows the optimizer's lr scheduler, and
  ``set_learning_rate`` is refused while a scheduler sets the rate
  (reference: ``gluon/trainer.py`` ``learning_rate`` →
  ``optimizer.py`` ``Optimizer.learning_rate``).
* ``Cast`` (``nd.cast``, ``NDArray.astype``) converts as the JAX
  package's op does: a float becomes an integer by truncation toward
  zero, saturated to the type's range, NaN to 0; int32 to a narrower
  integer wraps. The JAX package's result is the expected value.
* ``NDArray.asnumpy`` (and ``asscalar``) of a bfloat16 array returns
  what the JAX package's does: numpy's ``ml_dtypes.bfloat16``, the same
  bits.
* Slicing with a negative step (``x[::-1]``, ``x[3:0:-2]``, and
  assignment through one) gives the JAX package's values (C.5).
* ``sum`` of int32 is int32 and of uint8 uint32; ``mean`` of int32 is
  the float32 mean (C.6).
* ``BatchNorm.cast`` to float16 / bfloat16 keeps gamma, beta and the
  running statistics float32 (C.7).
* With no seed given, ``NDArrayIter``'s shuffle and the augmenters draw
  from the global ``np.random`` / ``random``, so that seeding those
  reproduces them (C.8).
* A hybridized block may pass an op's attributes positionally
  (``F.clip(x, -0.5, 0.5)``) and take ``abs()`` of a Symbol (C.9).
* ``pretrained=True`` loads ``<root>/<name>.params`` from a local
  directory, and raises ``MXNetError`` naming the path without it
  (C.10): a seeded JAX ``resnet18_v1`` saved there gives the same
  logits in both packages within 1e-5.
* ``flash_attention`` takes k and v of their own length ``s_k`` beside
  q's ``s_q``, causal as ``kpos <= qpos`` counted from 0, as the TPU
  kernel does (C.12): the forward and its gradients (dk, dv of k's
  shape) against the Pallas kernel in interpret mode through its
  ``custom_vjp``, within 1e-5.
* Integer ``%`` by zero (``a % b``, ``a % 0``, ``0 % a``) gives 0, as
  ``jnp.mod``, where torch raised (C.13).
* ``sign`` keeps NaN and the sign bit of -0.0, as ``jnp.sign`` (C.14).
* Out-of-range indices follow the JAX package: ``gather_nd`` counts a
  negative index from the end once and then clamps; ``batch_take`` and
  ``SequenceLast`` (a length of 0 reads the last step) give the fill
  value (NaN, or the least int32) for an index still out of range
  (C.15).
* The nvjpeg decoder backend takes the JAX decoder's whole domain
  (C.16): its plan resizes the short side and no longer refuses images
  smaller than the crop, 4:4:0, 4:1:1 and 4:1:0 planes convert, and
  the plain version of its kernel gives the JAX package's native
  decoder's bits for a resize below the crop.
* The model builders take ``dtype`` as the JAX builders do and build
  the same float32 graph whatever it is (C.17).
* ``asnumpy`` of a bfloat16 array on the CPU is a copy, as the JAX
  package's (C.18).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402


def _train_steps(mx, steps, scheduler=True):
    """``steps`` Trainer steps of a 2-layer Dense net on seeded data,
    base lr 0.2 halved every update when ``scheduler``; the trainer."""
    ctx = mx.cpu()
    net = mx.gluon.nn.Sequential()
    net.add(mx.gluon.nn.Dense(8, activation="relu"), mx.gluon.nn.Dense(2))
    net.initialize(ctx=ctx)
    params = {"learning_rate": 0.2}
    if scheduler:
        params["lr_scheduler"] = mx.lr_scheduler.FactorScheduler(
            step=1, factor=0.5)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", params)
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.randn(4, 5).astype(np.float32), ctx=ctx)
    for _ in range(steps):
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(4)
    return trainer


@pytest.mark.parametrize("steps", [0, 1, 4])
def test_trainer_learning_rate_follows_scheduler(steps):
    want = _train_steps(jmx, steps).learning_rate
    got = _train_steps(tmx, steps).learning_rate
    assert got == pytest.approx(want, rel=1e-12)
    if steps == 4:
        assert got == pytest.approx(0.025, rel=1e-12)


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_set_learning_rate(mx):
    trainer = _train_steps(mx, 1)
    with pytest.raises(UserWarning):
        trainer.set_learning_rate(0.1)
    with pytest.raises(UserWarning):
        trainer.optimizer.set_learning_rate(0.1)
    plain = _train_steps(mx, 1, scheduler=False)
    assert plain.learning_rate == pytest.approx(0.2)
    plain.set_learning_rate(0.05)
    assert plain.learning_rate == pytest.approx(0.05)
    assert plain.optimizer.learning_rate == pytest.approx(0.05)


CAST_FLOATS = [-1.7, 300.0, 255.5, -129.5, np.inf, -np.inf, np.nan, 0.0,
               3.9, -3.9, 127.4, -128.6, 0.5, 2.5e9, -2.5e9]
CAST_INTS = [300, -1, 128, -129, 255, 256, 70000, -70000, 0, 127]


def _cast_both(src, dtype, via):
    out = []
    for mx in (jmx, tmx):
        a = mx.nd.array(src, dtype=str(src.dtype), ctx=mx.cpu())
        r = (mx.nd.cast(a, dtype=dtype) if via == "cast"
             else a.astype(dtype))
        out.append(r.asnumpy())
    return out


@pytest.mark.parametrize("via", ["cast", "astype"])
@pytest.mark.parametrize("dtype", ["uint8", "int8", "int32"])
@pytest.mark.parametrize("value", CAST_FLOATS)
def test_cast_float32_to_int_matches_jax(value, dtype, via):
    src = np.array([value], np.float32)
    want, got = _cast_both(src, dtype, via)
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("via", ["cast", "astype"])
@pytest.mark.parametrize("dtype", ["uint8", "int8"])
def test_cast_int32_to_narrower_wraps_as_jax(dtype, via):
    src = np.array(CAST_INTS, np.int32)
    want, got = _cast_both(src, dtype, via)
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, src.astype(dtype))   # two's compl.


@pytest.mark.parametrize("dtype", ["bool", "float16", "bfloat16"])
def test_cast_float32_to_bool_and_floats_matches_jax(dtype):
    """Read back through a second cast to float32 (the port's
    ``asnumpy`` has no bfloat16)."""
    src = np.array(CAST_FLOATS, np.float32)
    out = []
    for mx in (jmx, tmx):
        a = mx.nd.array(src, ctx=mx.cpu())
        out.append(mx.nd.cast(mx.nd.cast(a, dtype=dtype),
                              dtype="float32").asnumpy())
    np.testing.assert_array_equal(out[1], out[0])


# float32 bit patterns: quiet and signalling NaNs with either sign and
# several payloads, +-0, +-inf, values that round (one a tie to even)
NAN_BITS = [0x7FC00000, 0x7F800001, 0x7FFFFFFF, 0x7FA00000, 0xFFC00000,
            0xFF800001]
CAST_BF16_BITS = NAN_BITS + [0x00000000, 0x80000000, 0x7F800000,
                             0xFF800000, 0x3F808000, 0x40490FDB,
                             0xC2F6E979, 0x3F800001]


@pytest.mark.parametrize("via", ["cast", "astype"])
def test_cast_float32_nan_to_bfloat16_matches_jax(via):
    """XLA's convert gives a NaN the quiet pattern with the input's sign
    (0x7FC0 / 0xFFC0); every other value rounds to nearest even."""
    src = np.array(CAST_BF16_BITS, np.uint32).view(np.float32)
    out = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        a = mx.nd.array(src, ctx=mx.cpu())
        r = (mx.nd.cast(a, dtype="bfloat16") if via == "cast"
             else a.astype("bfloat16"))
        out[name] = r.asnumpy().view(np.uint16).tolist()
    assert out["torch"] == out["jax"]
    assert out["torch"][:len(NAN_BITS)] == [0x7FC0] * 4 + [0xFFC0] * 2


# +-0, subnormals, +-inf, NaN, values bfloat16 holds exactly, a tie that
# rounds to even, values that round; rounded to bfloat16 once, by
# ml_dtypes, so that both packages hold the same bits (their float32 ->
# bfloat16 casts give NaN different payloads)
BF16_VALUES = [0.0, -0.0, 1e-40, -3e-39, np.inf, -np.inf, np.nan, 1.0,
               -2.5, 1.00390625, 1.0 + 3 * 2.0 ** -9, 3.14159265, 65504.0,
               -1e38, 3e38]


def _bf16_arrays():
    import jax.numpy as jnp
    import ml_dtypes
    import torch
    bits = np.array(BF16_VALUES, np.float32).astype(ml_dtypes.bfloat16)
    return bits, {
        "jax": jmx.nd.NDArray(jnp.asarray(bits)),
        "torch": tmx.nd.NDArray(torch.from_numpy(
            bits.view(np.int16).copy()).view(torch.bfloat16))}


@pytest.mark.parametrize("via", ["asnumpy", "asscalar"])
def test_asnumpy_bfloat16_matches_jax(via):
    bits, arrays = _bf16_arrays()
    out = {}
    for name, a in arrays.items():
        if via == "asnumpy":
            out[name] = a.asnumpy()
        else:
            out[name] = np.array([a[i].asscalar() for i in range(a.size)])
    want, got = out["jax"], out["torch"]
    assert str(want.dtype) == "bfloat16"
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.view(np.uint16).tolist() == want.view(np.uint16).tolist()
    assert got.view(np.uint16).tolist() == bits.view(np.uint16).tolist()
    # 1 + 2^-8 ties to 1.0; -0 keeps its sign
    assert got.view(np.uint16)[9] == 0x3F80
    assert got.view(np.uint16)[1] == 0x8000


# ---------------------------------------------------------------------------
# C.5: negative-step slicing
# ---------------------------------------------------------------------------

SLICE_KEYS = [(slice(None, None, -1),), (slice(3, 0, -2),),
              (0, slice(1, 3), slice(None, None, -1)),
              (Ellipsis, slice(None, None, -2)),
              (slice(None, None, -1), None, slice(4, None, -3)),
              (slice(0, 3, -1),)]


@pytest.mark.parametrize("key", range(len(SLICE_KEYS)))
def test_negative_step_slicing_matches_jax(key):
    key = SLICE_KEYS[key]
    src = np.arange(4 * 5 * 6, dtype=np.float32).reshape(4, 5, 6)
    got = tmx.nd.array(src, ctx=tmx.cpu())[key]
    want = jmx.nd.array(src, ctx=jmx.cpu())[key]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    # assignment through the same key
    out = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        a = mx.nd.array(src, ctx=mx.cpu())
        val = np.arange(int(np.prod(want.shape)), dtype=np.float32) \
            .reshape(want.shape) + 1000
        a[key] = mx.nd.array(val, ctx=mx.cpu())
        out[name] = a.asnumpy()
    np.testing.assert_array_equal(out["torch"], out["jax"])


def test_negative_step_slice_gradient_matches_jax():
    src = np.arange(12, dtype=np.float32).reshape(3, 4)
    grads = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        x = mx.nd.array(src, ctx=mx.cpu())
        x.attach_grad()
        with mx.autograd.record():
            y = x[::-1, 3:0:-2] * mx.nd.array(np.array([2.0, 3.0],
                                                       np.float32),
                                              ctx=mx.cpu())
        y.backward()
        grads[name] = x.grad.asnumpy()
    np.testing.assert_array_equal(grads["torch"], grads["jax"])


# ---------------------------------------------------------------------------
# C.6: the types of integer reductions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int32", "uint8", "int8", "float32"])
@pytest.mark.parametrize("op", ["sum", "mean", "prod", "method_sum"])
def test_integer_sum_and_mean_match_jax(op, dtype):
    src = (np.arange(12) % 5 + 1).reshape(3, 4).astype(dtype)
    out = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        a = mx.nd.array(src, ctx=mx.cpu(), dtype=dtype)
        if op == "method_sum":
            r = [a.sum(), a.sum(axis=1)]
        else:
            f = getattr(mx.nd, op)
            r = [f(a), f(a, axis=0, keepdims=True)]
        out[name] = [x.asnumpy() for x in r]
    for got, want in zip(out["torch"], out["jax"]):
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# C.7: BatchNorm.cast keeps its statistics float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_batchnorm_cast_keeps_float32_stats(dtype):
    src = np.random.RandomState(3).randn(4, 3, 2, 2).astype(np.float32)
    out = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        net = mx.gluon.nn.BatchNorm(in_channels=3)
        net.initialize(ctx=mx.cpu())
        net.cast(dtype)
        x = mx.nd.array(src, ctx=mx.cpu()).astype(dtype)
        with mx.autograd.record():
            y = net(x)
        y.backward()
        out[name] = {k: str(p.data().dtype) for k, p in
                     net.collect_params().items()}
        out[name]["out"] = str(y.dtype)
        out[name]["mean"] = net.running_mean.data().asnumpy()
    assert sorted(out["torch"].keys()) == sorted(out["jax"].keys())
    for k in out["jax"]:
        if k == "mean":
            np.testing.assert_allclose(out["torch"][k], out["jax"][k],
                                       rtol=1e-2, atol=1e-3)
        else:
            assert out["torch"][k] == out["jax"][k], k
    assert out["torch"]["out"] == dtype
    assert all(v == "float32" for k, v in out["torch"].items()
               if k not in ("out", "mean"))


# ---------------------------------------------------------------------------
# C.8: unseeded shuffles and augmenters follow the global generators
# ---------------------------------------------------------------------------

def _shuffled_order(mx):
    data = np.arange(16, dtype=np.float32).reshape(16, 1)
    it = mx.io.NDArrayIter(data, np.zeros(16, np.float32), batch_size=4,
                           shuffle=True)
    return np.concatenate([b.data[0].asnumpy().ravel() for b in it])


def _crops_and_lighting(mx):
    import random
    img = np.arange(20 * 24 * 3, dtype=np.uint8).reshape(20, 24, 3)
    random.seed(5)
    boxes = [mx.image.random_crop(img, (10, 8))[1] for _ in range(3)]
    np.random.seed(6)
    light = mx.image.LightingAug(0.1, np.ones(3), np.eye(3))
    shifts = [light(img.astype(np.float32)) for _ in range(2)]
    return boxes, np.stack([np.asarray(s.asnumpy() if hasattr(
        s, "asnumpy") else s) for s in shifts])


def test_global_seed_reproduces_shuffle_and_augmenters():
    orders = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        np.random.seed(3)
        first = _shuffled_order(mx)
        np.random.seed(3)
        second = _shuffled_order(mx)
        np.testing.assert_array_equal(first, second)
        orders[name] = first
    assert sorted(orders["torch"].tolist()) == list(range(16))
    boxes, light = {}, {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        b1, l1 = _crops_and_lighting(mx)
        b2, l2 = _crops_and_lighting(mx)
        assert b1 == b2
        np.testing.assert_array_equal(l1, l2)
        boxes[name], light[name] = b1, l1
    assert boxes["torch"] == boxes["jax"]
    np.testing.assert_allclose(light["torch"], light["jax"], rtol=1e-6)


# ---------------------------------------------------------------------------
# C.9: positional attributes and abs() in a hybridized block
# ---------------------------------------------------------------------------

def _clip_abs_block(mx):
    class ClipAbs(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            y = F.clip(x, -0.5, 0.5)
            return y ** 2 + abs(x)
    return ClipAbs()


@pytest.mark.parametrize("hybridize", [False, True])
def test_hybridized_positional_attrs_and_abs_match_jax(hybridize):
    src = np.random.RandomState(4).uniform(-1, 1, (3, 5)).astype(
        np.float32)
    src[np.abs(np.abs(src) - 0.5) < 0.01] = 0.25     # off clip's kinks
    out = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        net = _clip_abs_block(mx)
        net.initialize(ctx=mx.cpu())
        if hybridize:
            net.hybridize()
        x = mx.nd.array(src, ctx=mx.cpu())
        x.attach_grad()
        with mx.autograd.record():
            y = net(x)
        y.backward()
        out[name] = (y.asnumpy(), x.grad.asnumpy())
    for got, want in zip(out["torch"], out["jax"]):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_pretrained_loads_a_local_file_as_jax(tmp_path):
    """C.10: the port raised NotImplementedError for pretrained=True
    even with the file staged."""
    x = np.random.RandomState(0).uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32)
    jmx.random.seed(0)
    src = jmx.gluon.model_zoo.vision.get_model("resnet18_v1", classes=10)
    src.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    with jmx.autograd.predict_mode():
        src(jmx.nd.array(x))
    src.save_parameters(str(tmp_path / "resnet18_v1.params"))
    logits = []
    for mx in (jmx, tmx):
        net = mx.gluon.model_zoo.vision.get_model(
            "resnet18_v1", classes=10, pretrained=True, root=str(tmp_path),
            ctx=mx.cpu())
        logits.append(net(mx.nd.array(x, ctx=mx.cpu())).asnumpy())
    assert logits[0].shape == (2, 10)
    assert np.abs(logits[1] - logits[0]).max() <= 1e-5 * np.abs(
        logits[0]).max()
    empty = tmp_path / "empty"
    empty.mkdir()
    for mx in (jmx, tmx):
        with pytest.raises(mx.base.MXNetError, match="resnet18_v1.params"):
            mx.gluon.model_zoo.vision.get_model(
                "resnet18_v1", pretrained=True, root=str(empty))


# (b, heads, s_q, s_k, head_dim): shorter and longer keys than queries,
# lengths no multiple of the Pallas kernel's 8-row blocks among them
FLASH_LENGTHS = [(1, 2, 8, 16, 64), (1, 2, 16, 8, 64), (2, 3, 13, 40, 16)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_LENGTHS)
def test_flash_attention_takes_own_key_length_as_jax(shape, causal):
    """C.12: the port raised ``k has shape (1, 2, 16, 64), expected (1,
    2, 8, 64)`` where the JAX kernel returns the attention."""
    from mxnet_tpu.ops.pallas.flash_attention import (
        flash_attention as jax_flash)
    from mxnet_tpu_torch.ops.cuda.flash_attention import flash_attention
    b, h, s_q, s_k, d = shape
    rng = np.random.RandomState(12)
    q, g = (rng.randn(b, h, s_q, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, s_k, d).astype(np.float32) for _ in range(2))

    def jloss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, interpret=True)
        return jnp.sum(o * g), o

    (_, oj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ot = flash_attention(qt, kt, vt, causal=causal)
    gt = torch.autograd.grad(ot, (qt, kt, vt), torch.from_numpy(g))
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj),
                               rtol=1e-5, atol=1e-5)
    for name, a, want in zip(("dq", "dk", "dv"), gt, gj):
        assert a.shape == want.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def _both(fn):
    """``fn(mx)`` of each package, as numpy (JAX package first)."""
    return [fn(mx).asnumpy() for mx in (jmx, tmx)]


def _i32(mx, values):
    return mx.nd.array(np.asarray(values, np.int32), dtype="int32",
                       ctx=mx.cpu())


@pytest.mark.parametrize("form", ["array", "scalar", "rscalar"])
def test_integer_mod_by_zero_matches_jax(form):
    """C.13: torch.remainder raised ``ZeroDivisionError`` on an int32
    divisor of 0 where ``jnp.mod`` gives 0."""
    a, b = [7, -7, 5, -5, 0], [0, 0, 3, -3, 0]
    fns = {"array": lambda mx: _i32(mx, a) % _i32(mx, b),
           "scalar": lambda mx: _i32(mx, a) % 0,
           "rscalar": lambda mx: 7 % _i32(mx, b)}
    want, got = _both(fns[form])
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[:2] == 0).all()


def test_sign_keeps_nan_and_negative_zero_bits_as_jax():
    """C.14: torch.sign gave [0, 0, 1] for [nan, -0.0, 2]."""
    x = np.array([np.nan, -0.0, 2.0, 0.0, -3.0], np.float32)
    want, got = _both(lambda mx: mx.nd.sign(mx.nd.array(x, ctx=mx.cpu())))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isnan(got[0]) and np.signbit(got[1])


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_out_of_range_indices_match_jax(dtype):
    """C.15: gather_nd raised IndexError, SequenceLast with a length of
    0 raised, batch_take clamped 5 and -4 where the JAX package gives
    the fill value."""
    data = np.arange(12).reshape(4, 3).astype(dtype)

    def arr(mx, a):
        return mx.nd.array(a, dtype=dtype, ctx=mx.cpu())

    cases = [
        lambda mx: mx.nd.gather_nd(
            arr(mx, np.arange(4).astype(dtype)),
            _i32(mx, [[5, -1, -2, -7, 3]])),
        lambda mx: mx.nd.gather_nd(
            arr(mx, np.arange(18).reshape(2, 3, 3).astype(dtype)),
            _i32(mx, [[1, 2, -1], [5, -4, 0]])),
        lambda mx: mx.nd.batch_take(arr(mx, data), _i32(mx, [5, -1, -3,
                                                              -4])),
        lambda mx: mx.nd.SequenceLast(
            arr(mx, data), mx.nd.array(np.array([0, 5, -1], np.float32),
                                       ctx=mx.cpu()),
            use_sequence_length=True)]
    for fn in cases:
        want, got = _both(fn)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_nvjpeg_backend_takes_jax_decoders_domain():
    """C.16: the nvjpeg backend's plan raised for an image smaller than
    the crop (and its decoder for any ``resize``), and 4:4:0 / 4:1:1 /
    4:1:0 planes raised; the JAX package's decoder computes them all."""
    cv2 = pytest.importorskip("cv2")
    import mxnet_tpu.image as jimg
    from mxnet_tpu_torch import image as timg
    from mxnet_tpu_torch.ops.cuda import image_decode as idec
    dec = timg.NativeImageDecoder((3, 64, 72), resize=56, rand_crop=True,
                                  seed=2)
    plan = dec.plan(np.array([[100, 150], [40, 30], [300, 200]]))
    assert plan[:, 3:].tolist() == [[56, 84, 56, 72], [74, 56, 64, 56],
                                    [84, 56, 64, 56]]
    info = np.array([[10, 12, 3, css, 5, 12] for css in (3, 4, 5)],
                    np.int32)
    assert idec.plane_layout(info, 3)[0].tolist() == [
        idec.KINDS["440"], idec.KINDS["411"], idec.KINDS["410"]]
    rng = np.random.RandomState(5)
    bufs = [cv2.imencode(".jpg", rng.randint(0, 255, (h, w), np.uint8))[1]
            .tobytes() for h, w in ((50, 90), (120, 70), (30, 40))]
    want = jimg.NativeImageDecoder((3, 64, 72), resize=56, rand_crop=True,
                                   rand_mirror=True, seed=2).decode_batch(
                                       bufs, base=4)
    dec = timg.NativeImageDecoder((3, 64, 72), resize=56, rand_crop=True,
                                  rand_mirror=True, seed=2)
    planes = [cv2.imdecode(np.frombuffer(b, np.uint8), 0) for b in bufs]
    hw = np.array([p.shape for p in planes])
    plan = dec.plan(hw, base=4)
    offs = np.concatenate([[0], np.cumsum(hw[:, 0] * hw[:, 1])[:-1]])
    items = np.concatenate([offs[:, None], hw, plan[:, :3],
                            np.zeros((3, 3)), plan[:, 3:]], 1)
    got = idec.crop_mirror_normalize(
        torch.from_numpy(np.concatenate([p.ravel() for p in planes])),
        torch.from_numpy(items.astype(np.int64)), (3, 64, 72), [0.0] * 3,
        [1.0] * 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("net", ["alexnet", "vgg", "mobilenet",
                                 "inception_bn"])
def test_builders_take_dtype_as_jax(net):
    """C.17: the builders raised for any ``dtype`` but float32; the JAX
    builders take it and build the same float32 graph whatever it is."""
    import mxnet_tpu.models  # noqa: F401
    kw = {"vgg": {"num_layers": 11}}.get(net, {})
    t = getattr(tmx.models, net)(num_classes=10, dtype="float16", **kw)
    j = getattr(jmx.models, net)(num_classes=10, dtype="float16", **kw)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    assert t.infer_shape(data=(2, 3, 96, 96)) == j.infer_shape(
        data=(2, 3, 96, 96))


def test_bfloat16_asnumpy_is_a_copy_as_jax():
    """C.18: ``asnumpy`` of a bfloat16 array on the CPU returned a view of
    the tensor, so a later in-place update (an optimizer step) changed
    the host array; the JAX package's is a copy, as the port's of every
    other type."""
    for mx, kw in ((tmx, {"ctx": tmx.cpu()}), (jmx, {})):
        x = mx.nd.array(np.ones(4, np.float32), **kw).astype("bfloat16")
        host = x.asnumpy()
        x += 1
        assert host.astype(np.float32).tolist() == [1.0] * 4
        assert x.asnumpy().astype(np.float32).tolist() == [2.0] * 4
