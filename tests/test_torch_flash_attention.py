"""The PyTorch/CUDA port's flash attention against the JAX package.

``flash_attention`` (forward, with its ``(o, lse)`` pair from
``_flash_fwd``) and ``flash_attention_bwd`` of
``mxnet_tpu_torch.ops.cuda.flash_attention``: their plain PyTorch
versions ``_flash_fwd_torch`` and ``_flash_bwd_torch`` are held against
the JAX package's XLA twin ``_flash_fwd_xla``, its Pallas kernel run by
the interpreter (``_flash_fwd`` / ``flash_attention(interpret=True)``,
which pads the sequence to its block and masks the padded keys) and
``jax.grad`` through that kernel (its ``_flash_bwd``), on the same
numpy-seeded inputs, causal and full, over shapes with s not a multiple
of 8. Float32 at rtol/atol 2e-5 for the forward (the JAX tests' own
tolerance) and 1e-4 for the gradients (sums over blocks in another
order). On CPU tensors the wrappers take the plain versions and launch
nothing; bad dtypes, shapes, layouts and mixed devices raise. The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py. The ``_contrib_flash_attention``
op through ``nd.contrib``, a bound ``sym.contrib`` Symbol and a
hybridized block's ``F.contrib``, at key lengths of their own and head
dims 80 and 128, against the JAX package's op (output and gradients
within 1e-4).
"""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402

# the package exports a function of the module's name
jfa = importlib.import_module("mxnet_tpu.ops.pallas.flash_attention")
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# (b, heads, s, head_dim): s = 13 and 200 are no multiple of 8; s = 200
# pads to two 128-key blocks in the Pallas kernel
SHAPES = [(1, 2, 13, 8), (2, 3, 32, 16), (1, 2, 200, 16)]


def _case(seed, shape):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(4))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scale(shape):
    return 1.0 / np.sqrt(shape[-1])


def _pallas_fwd(q, k, v, causal):
    """The Pallas kernel under the interpreter, outside any mesh, with
    flash_attention's block sizes: (o, lse)."""
    s = q.shape[2]
    blk = min(128, max(8, s))
    return jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal, float(_scale(q.shape)), blk, blk, True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_fwd_torch_matches_xla_twin(shape, causal):
    q, k, v, _ = _case(0, shape)
    ro, rl = jfa._flash_fwd_xla(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, _scale(shape))
    o, lse = tfa._flash_fwd_torch(_t(q), _t(k), _t(v), causal,
                                  _scale(shape))
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(rl), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_fwd_matches_pallas_interpret(shape, causal):
    q, k, v, _ = _case(1, shape)
    ro, rl = _pallas_fwd(q, k, v, causal)
    o, lse = tfa._flash_fwd(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(rl), **TOL)
    out = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_bwd_torch_matches_jax_grad(shape, causal):
    q, k, v, g = _case(2, shape)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, interpret=True)
        return jnp.sum(o * g)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o, lse = tfa._flash_fwd_torch(_t(q), _t(k), _t(v), causal,
                                  _scale(shape))
    got = tfa._flash_bwd_torch(_t(q), _t(k), _t(v), o, lse, _t(g), causal,
                               _scale(shape))
    for name, a, b in zip("qkv", got, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg="d" + name, **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_routes_cpu_to_plain_versions(monkeypatch, causal):
    q, k, v, g = (_t(a) for a in _case(3, SHAPES[1]))
    calls = []
    plain_fwd, plain_bwd = tfa._flash_fwd_torch, tfa._flash_bwd_torch

    def spy(name, fn):
        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tfa, "_flash_fwd_torch", spy("fwd", plain_fwd))
    monkeypatch.setattr(tfa, "_flash_bwd_torch", spy("bwd", plain_bwd))
    before = dict(tfa.LAUNCHES)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    o = tfa.flash_attention(qg, kg, vg, causal=causal)
    # gradient arrives non-contiguous, as it does through the model's
    # head transpose
    do = g.transpose(2, 3).contiguous().transpose(2, 3)
    dq, dk, dv = torch.autograd.grad(o, (qg, kg, vg), do)
    assert calls == ["fwd", "bwd"]
    assert tfa.LAUNCHES == before             # no kernel launched
    scale = _scale(SHAPES[1])
    ro, rl = plain_fwd(q, k, v, causal, scale)
    assert torch.equal(o.detach(), ro)
    want = plain_bwd(q, k, v, ro, rl, g, causal, scale)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)
    # the bwd entry takes the same plain path
    got = tfa.flash_attention_bwd(q, k, v, ro, rl, g, causal)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_bf16_inputs_give_bf16_outputs_and_f32_lse():
    q, k, v, g = (_t(a).bfloat16() for a in _case(4, SHAPES[1]))
    o, lse = tfa._flash_fwd(q, k, v, True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, g, True)
    assert all(t.dtype == torch.bfloat16 for t in grads)


@pytest.mark.parametrize("bad", ["dtype", "f16", "dims", "k_shape",
                                 "v_dtype", "contiguous", "device"])
def test_flash_fwd_rejects(bad):
    q, k, v, _ = (_t(a) for a in _case(5, SHAPES[1]))
    if bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "f16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "dims":
        q, k, v = q[0], k[0], v[0]
    elif bad == "k_shape":
        # k and v may be longer or shorter than q (C.12), but share its
        # batch, heads and head_dim
        k = k[..., :8].contiguous()
    elif bad == "v_dtype":
        v = v.bfloat16()
    elif bad == "contiguous":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        k = torch.empty(k.shape, device="meta")
    with pytest.raises(MXNetError):
        tfa._flash_fwd(q, k, v, True)
    with pytest.raises(MXNetError):
        tfa.flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("bad", ["lse_dtype", "lse_shape", "o_shape",
                                 "do_dtype"])
def test_flash_bwd_rejects(bad):
    q, k, v, g = (_t(a) for a in _case(6, SHAPES[1]))
    o, lse = tfa._flash_fwd(q, k, v, True)
    if bad == "lse_dtype":
        lse = lse.double()
    elif bad == "lse_shape":
        lse = lse[..., :8].contiguous()
    elif bad == "o_shape":
        o = o[:1].contiguous()
    else:
        g = g.bfloat16()
    with pytest.raises(MXNetError):
        tfa.flash_attention_bwd(q, k, v, o, lse, g, True)


# flash_route's table, (dtype, head_dim, s_q, s_k, aligned) -> route:
# bfloat16 at head_dim 32 / 64 / 128 on "wgmma" at any s_q and s_k with
# 16-byte aligned storage; float32, other head dims, unaligned storage
# and an empty side on "fma"
_BF16, _F32 = torch.bfloat16, torch.float32
ROUTE_TABLE = [
    ((_BF16, d, s_q, s_k, True), "wgmma")
    for d in (32, 64, 128)
    for s_q, s_k in ((1024, 1024), (512, 1024), (1024, 512), (100, 37))
] + [
    ((_BF16, 64, 1024, 1024, False), "fma"),    # unaligned storage
    ((_BF16, 128, 512, 1024, False), "fma"),
    ((_F32, 64, 1024, 1024, True), "fma"),      # the CLI's own dtype
    ((_F32, 128, 256, 256, True), "fma"),
    ((_F32, 32, 8, 16, True), "fma"),
    ((_BF16, 8, 33, 33, True), "fma"),          # head dims off the table
    ((_BF16, 80, 130, 70, True), "fma"),
    ((_BF16, 256, 64, 64, True), "fma"),
    ((_BF16, 96, 64, 64, True), "fma"),
    ((_BF16, 64, 0, 16, True), "fma"),          # an empty side
    ((_BF16, 64, 16, 0, True), "fma"),
]


@pytest.mark.parametrize("args,want", ROUTE_TABLE)
def test_flash_route_table(args, want):
    """Which route a CUDA flash call takes, from dtype, head_dim, the
    two lengths and alignment alone (no card needed)."""
    assert tfa.flash_route(*args) == want
    assert (args[1] in tfa.WGMMA_HEAD_DIMS) == (args[1] in (32, 64, 128))


# ---------------------------------------------------------------------------
# the _contrib_flash_attention op (nd.contrib / sym.contrib / F.contrib)
# ---------------------------------------------------------------------------

# (b, heads, s_q, s_k, head_dim), causal: key lengths of their own and
# head dims the card's "fma" route takes
CONTRIB = [((1, 2, 8, 16, 80), True), ((2, 1, 12, 5, 128), False),
           ((1, 3, 9, 9, 80), True)]


def _contrib_run(mx, route, arrays, head, causal):
    """(out, dq, dk, dv) of _contrib_flash_attention in package ``mx``,
    through ``route``: the nd op, a bound Symbol, or a hybridized
    block calling F.contrib.flash_attention."""
    ctx = mx.cpu()
    if route == "sym":
        s = mx.sym.contrib.flash_attention(
            mx.sym.var("q"), mx.sym.var("k"), mx.sym.var("v"),
            causal=causal)
        args = {n: mx.nd.array(a, ctx=ctx) for n, a in zip("qkv", arrays)}
        grads = {n: mx.nd.zeros(a.shape, ctx=ctx)
                 for n, a in zip("qkv", arrays)}
        ex = s.bind(ctx, args, args_grad=grads)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([mx.nd.array(head, ctx=ctx)])
        return (out,) + tuple(grads[n].asnumpy() for n in "qkv")
    nds = [mx.nd.array(a, ctx=ctx) for a in arrays]
    for a in nds:
        a.attach_grad()
    if route == "nd":
        def fn(q, k, v):
            return mx.nd.contrib.flash_attention(q, k, v, causal=causal)
    else:
        class Attn(mx.gluon.HybridBlock):
            def hybrid_forward(self, F, q, k, v):
                return F.contrib.flash_attention(q, k, v, causal=causal)
        fn = Attn()
        fn.hybridize()
    with mx.autograd.record():
        out = fn(*nds)
    out.backward(mx.nd.array(head, ctx=ctx))
    return (out.asnumpy(),) + tuple(a.grad.asnumpy() for a in nds)


@pytest.mark.parametrize("route", ["nd", "sym", "hybridized"])
@pytest.mark.parametrize("shape,causal", CONTRIB)
def test_contrib_flash_attention_matches_jax(route, shape, causal):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    b, h, s_q, s_k, d = shape
    rng = np.random.RandomState(s_q + s_k)
    arrays = [rng.randn(b, h, n, d).astype(np.float32)
              for n in (s_q, s_k, s_k)]
    head = rng.randn(b, h, s_q, d).astype(np.float32)
    want = _contrib_run(jmx, route, arrays, head, causal)
    got = _contrib_run(tmx, route, arrays, head, causal)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


def test_contrib_flash_attention_takes_the_tpu_tile_attrs():
    """block_q, block_k and interpret are accepted and change nothing
    on this port."""
    import mxnet_tpu_torch as tmx
    q, k, v, _ = (tmx.nd.array(a, ctx=tmx.cpu()) for a in _case(7, SHAPES[1]))
    base = tmx.nd.contrib.flash_attention(q, k, v, causal=True).asnumpy()
    tiled = tmx.nd.contrib.flash_attention(q, k, v, causal=True, block_q=8,
                                           block_k=16, interpret=True)
    np.testing.assert_array_equal(tiled.asnumpy(), base)
