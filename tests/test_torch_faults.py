"""Three faults of the port against the JAX package, held on the CPU.

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
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

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
