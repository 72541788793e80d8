"""The PyTorch/CUDA package's kernels and engine on an NVIDIA card.

Every test here needs a CUDA device and nvcc (a CUDA kernel has no CPU
mode) and skips without one. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda

The file imports no JAX, so it runs where only PyTorch is installed.
Each kernel is held against its plain PyTorch version on the same
inputs: float32 at rtol/atol 2e-5, bfloat16 against the plain version
in float32 at 1e-2 (bf16 output rounding), pages bitwise. The serving
kernels are held on each of their routes (decode "cluster" and
"serial", prefill "mma" and "fma"), the launch counted on the route the
route function names: decode at rows of length 0 (zeros, the kernels'
result), 1, 15, 16, 17 and 256, groups 1-8, head dims 32-128 and a
second call bitwise equal to the first; prefill at every bucket of the
decode config, kv_heads = n_heads, group 16, head dims 32 and 128. A
float32 NaN cast to bfloat16 on the card gives XLA's bits. The flash
attention kernels (forward and backward) are held by relative RMS error
||got - plain|| / ||plain|| of each (batch, head) slice, the plain
backward fed the plain o and lse: o, dq, dk, dv within 1e-5 in float32
and 1e-2 in bfloat16 (one bf16 rounding is 1.7e-3 RMS; the kernels
round p and ds for the tensor cores and their outputs), lse within 1e-5
in both, and a second run of both equals the first bitwise (the backward
sums in a fixed order, no atomics); both routes likewise at key lengths
other than the queries' and head dims up to 256, each launch on the
route ``flash_route`` names, and the
``_contrib_flash_attention`` op on the card the op on the CPU. The
engine on the card must give the
CPU engine's greedy streams, with the kernels launched once per layer
per prefill and per decode step; the train step on the card must match
the CPU's in float32, and in bfloat16 its gradients through the kernels
must match those through the plain attention route; so must the MoE and
``remat`` train steps, and ``transformer_generate`` on the card the CPU's
tokens and the paged ``DecodeEngine``'s stream. The fused optimizer
update kernel must equal its plain versions bitwise (SGD with and without
momentum and clip, Adam; aligned and misaligned tensors; one launch per
list), and a 2-step ResNet ``Module.fit`` on the card must match the
same fit on the CPU, through one update launch a step: each weight's
and moving statistic's change within 1e-3 relative RMS, the outputs
within 1e-4 (float32 sums in another order, which this small network
does not amplify, with TF32 off for matmuls and convolutions alike).
The int8 kernels (``int8_matmul``, ``int8_conv_im2col``) must equal their
plain versions bitwise, the quantized FC and convolution ops on the card
the same ops on the CPU bitwise, and an int8 ResNet served on the card
runs 13 ``int8_conv_im2col`` and 1 ``int8_matmul`` launches a forward,
each of its int8 layers equal, given the layer's input on the card, to
the same layer on the CPU. The inference BatchNorm kernel must equal its
plain version, and the BatchNorm op on the card the op on the CPU,
bitwise (16-byte and scalar paths, ``fix_gamma``), and its gradients
with ``use_global_stats`` the plain version's. Kernels compiled at run
time through ``rtc.CudaModule`` (NVRTC) must equal PyTorch's result: a
template kernel through ``exports`` bitwise, a row sum over 64 KB of
dynamic shared memory within 2e-6 of the sum of |x|, a launch from a
second thread too; a compile error and a launch error raise. One Gluon
``Trainer`` step on the card must match the CPU's through one update
launch (changes within 1e-3 relative RMS). A hybridized block's CUDA
graphs must replay its Symbol's direct evaluation (predict outputs and
training outputs and running statistics bitwise, gradients within
1e-5), count the kernels they replay, keep outputs across replays,
train as the eager block does, draw new random numbers per replay, and
raise ``MXNetError`` when an op cannot be captured. The image pipeline's nvJPEG
route must match its python route (cv2) within 4 uint8 levels, 0.1 on
average (the inverse DCTs round differently), at 4:2:0, 4:2:2, 4:4:4
and grayscale, with the ``crop_mirror_normalize`` kernel bitwise equal
to its plain version; batches staged by ``ImageRecordIter(
prefetch_buffer=2)`` must equal synchronous copies of the same records
and reach ``Module.fit`` without an executor copy.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops.cuda import batch_norm as tbn
from mxnet_tpu_torch.ops.cuda import flash_attention as tfa
from mxnet_tpu_torch.ops.cuda import fused_update as tfu
from mxnet_tpu_torch.ops.cuda import int8_matmul as ti8
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.parallel import transformer as T
from mxnet_tpu_torch.serve import DecodeConfig, DecodeEngine
from mxnet_tpu_torch import telemetry as tm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (CUDA kernels have no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False      # float32 convolutions
    return torch.device("cuda", 0)


def _tols(dtype):
    return 2e-5 if dtype == "float32" else 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths,kvh,g,hd,ps,pps", [
    ([37, 256, 1, 100, 17, 64, 200, 5], 4, 4, 64, 16, 16),   # full width
    ([0, 1, 15, 16, 17, 256], 4, 1, 64, 16, 16),            # edges, MHA
    ([0, 1, 15, 16, 17, 256], 4, 2, 64, 16, 16),
    ([0, 1, 15, 16, 17, 256], 4, 8, 64, 16, 16),
    ([0, 1, 17, 256], 1, 16, 64, 16, 16),                   # 2 head blocks
    ([0, 1, 15, 16, 17, 256], 4, 4, 32, 16, 16),
    ([0, 1, 15, 16, 17, 256], 4, 4, 128, 16, 16),
    ([3, 40, 0], 3, 2, 32, 8, 5),                           # 3 kv heads
    ([0, 1, 17, 256], 4, 4, 12, 16, 16),                    # bf16 serial
    ([0, 1, 17, 256], 4, 4, 6, 16, 16),                     # serial
])
def test_paged_decode_kernel_matches_plain(card, dtype, lengths, kvh, g, hd,
                                           ps, pps):
    """Each route against the plain version (a row of length 0 against
    zeros, the kernels' result), the launch counted on the route
    ``decode_route`` names, and a second call bitwise equal."""
    rng = np.random.RandomState(6)
    b = len(lengths)
    num_pages = b * pps + 1
    q = torch.from_numpy(rng.randn(b, kvh, g, hd).astype(np.float32))
    kp = torch.from_numpy(rng.randn(num_pages, ps, kvh, hd).astype(
        np.float32))
    vp = torch.from_numpy(rng.randn(num_pages, ps, kvh, hd).astype(
        np.float32))
    bt = torch.from_numpy((rng.permutation(num_pages - 1) + 1).reshape(
        b, pps).astype(np.int32)).to(card)
    ln = torch.tensor(lengths, dtype=torch.int32, device=card)
    dt = getattr(torch, dtype)
    q, kp, vp = (t.to(card, dt) for t in (q, kp, vp))
    route, _ = tfa.decode_route(dt, hd, pps)
    n0 = tfa.LAUNCHES["paged_decode_attention"]
    r0 = dict(tfa.ROUTES["paged_decode_attention"])
    got = tfa.paged_decode_attention(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["paged_decode_attention"] == n0 + 1
    assert tfa.ROUTES["paged_decode_attention"][route] == r0[route] + 1
    ref = tfa._paged_decode_torch(q.float(), kp.float(), vp.float(), bt, ln,
                                  1.0 / hd ** 0.5)
    ref[ln == 0] = 0.0
    tol = _tols(dtype)
    torch.testing.assert_close(got.float(), ref, rtol=tol, atol=tol)
    assert torch.equal(tfa.paged_decode_attention(q, kp, vp, bt, ln), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nh,kvh,hd,ps", [
    (1, 16, 16, 4, 64, 16),      # the decode config's buckets
    (1, 32, 16, 4, 64, 16),
    (1, 64, 16, 4, 64, 16),
    (1, 128, 16, 4, 64, 16),
    (1, 256, 16, 4, 64, 16),
    (1, 128, 16, 16, 64, 16),    # kv_heads = n_heads
    (1, 64, 16, 1, 64, 16),      # group 16
    (1, 64, 8, 2, 32, 16),       # head dims
    (1, 64, 8, 2, 128, 16),
    (2, 40, 6, 3, 64, 8),        # 3 kv heads, a ragged last q tile
])
def test_flash_prefill_kernel_matches_plain(card, dtype, b, s, nh, kvh, hd,
                                            ps):
    rng = np.random.RandomState(7)
    n_pb = s // ps
    num_pages = b * n_pb + 3
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            card, dt)

    q, kg, vg = rnd(b, s, nh, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd)
    kp, vp = rnd(num_pages, ps, kvh, hd), rnd(num_pages, ps, kvh, hd)
    bt = (torch.arange(b * n_pb, dtype=torch.int32) + 1).reshape(
        b, n_pb).to(card)
    kp_ref, vp_ref = kp.clone(), vp.clone()
    route = tfa.prefill_route(dt, hd, nh, kvh)
    assert route == ("mma" if dtype == "bfloat16" else "fma")
    n0 = tfa.LAUNCHES["flash_prefill_paged"]
    r0 = tfa.ROUTES["flash_prefill_paged"][route]
    o, kp2, _ = tfa.flash_prefill_paged(q, kg, vg, kp, vp, bt)
    torch.cuda.synchronize()
    assert kp2 is kp
    assert tfa.LAUNCHES["flash_prefill_paged"] == n0 + 1
    assert tfa.ROUTES["flash_prefill_paged"][route] == r0 + 1
    ro, _, _ = tfa._flash_prefill_torch(q.float(), kg.float(), vg.float(),
                                        kp_ref.float(), vp_ref.float(), bt)
    tfa._flash_prefill_torch(q, kg, vg, kp_ref, vp_ref, bt)
    tol = _tols(dtype)
    torch.testing.assert_close(o.float(), ro, rtol=tol, atol=tol)
    assert torch.equal(kp, kp_ref) and torch.equal(vp, vp_ref)


@pytest.mark.parametrize("via", ["cast", "astype"])
def test_cast_float32_nan_to_bfloat16_on_card(card, via):
    """XLA's bits on the card too: a NaN becomes 0x7FC0 / 0xFFC0 by its
    sign, every other value rounds to nearest even (ml_dtypes' cast)."""
    import ml_dtypes
    bits = np.array([0x7FC00000, 0x7F800001, 0x7FFFFFFF, 0x7FA00000,
                     0xFFC00000, 0xFF800001, 0x00000000, 0x80000000,
                     0x7F800000, 0xFF800000, 0x3F808000, 0x40490FDB],
                    np.uint32)
    src = bits.view(np.float32)
    a = tmx.nd.array(src, ctx=tmx.gpu(0))
    r = (tmx.nd.cast(a, dtype="bfloat16") if via == "cast"
         else a.astype("bfloat16"))
    got = r.asnumpy().view(np.uint16).tolist()
    with np.errstate(invalid="ignore"):
        want = src.astype(ml_dtypes.bfloat16).view(np.uint16).tolist()
    assert got == want
    assert got[:6] == [0x7FC0] * 4 + [0xFFC0] * 2


def test_engine_on_card_matches_cpu_engine(card):
    cfg = T.TransformerConfig(vocab_size=64, d_model=64, n_heads=4,
                              n_kv_heads=2, n_layers=2, d_ff=128,
                              pos_type="rope")
    dcfg = dict(slots=4, page_size=4, num_pages=64, max_context=32,
                queue_depth=8, max_new_tokens=16)
    rng = np.random.RandomState(3)
    reqs = [([int(t) for t in rng.randint(0, 64, (pl,))], mn)
            for pl, mn in [(3, 6), (7, 10), (12, 4), (5, 12), (16, 8)]]
    outs = {}
    for dev in ("cpu", card):
        params = T.init_transformer_params_np(cfg, seed=4, device=dev)
        eng = DecodeEngine(params, cfg, DecodeConfig(**dcfg),
                           device=dev).start().warmup()
        try:
            steps0 = tm.snapshot().get("decode/step_seconds",
                                       {"count": 0})["count"]
            tfa.reset_launches()
            outs[str(dev)] = [s.result() for s in
                              [eng.submit(p, mn) for p, mn in reqs]]
            steps = tm.snapshot()["decode/step_seconds"]["count"] - steps0
            launches = dict(tfa.LAUNCHES)
        finally:
            eng.close(drain=False)
    assert launches["flash_prefill_paged"] == cfg.n_layers * len(reqs)
    assert launches["paged_decode_attention"] == cfg.n_layers * steps
    assert outs["cpu"] == outs[str(card)]


def _rel_err(got, ref):
    """Largest relative RMS error over the (batch, head) slices."""
    d = (got.float() - ref.float()).flatten(2).flatten(0, 1)
    r = ref.float().flatten(2).flatten(0, 1)
    return float((d.norm(dim=1) / r.norm(dim=1)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [
    (2, 16, 256, 64),            # the train path's heads and head_dim
    (1, 3, 200, 32),             # head_dim 32, a ragged last tile
    (2, 3, 200, 64),             # a ragged last tile in every head
])
def test_flash_attention_kernels_match_plain(card, dtype, causal, shape):
    rng = np.random.RandomState(8)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(
        np.float32)).to(card, dt) for _ in range(4))
    scale = 1.0 / shape[3] ** 0.5
    n0 = dict(tfa.LAUNCHES)
    o, lse = tfa._flash_fwd(q, k, v, causal)
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == n0["flash_attention"] + 1
    assert (tfa.LAUNCHES["flash_attention_bwd"]
            == n0["flash_attention_bwd"] + 1)
    f = [t.float() for t in (q, k, v, do)]
    ro, rl = tfa._flash_fwd_torch(f[0], f[1], f[2], causal, scale)
    rg = tfa._flash_bwd_torch(f[0], f[1], f[2], ro.to(dt).float(), rl,
                              f[3], causal, scale)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for name, got, ref in zip(("o", "lse", "dq", "dk", "dv"),
                              (o, lse) + tuple(grads), (ro, rl) + tuple(rg)):
        assert got.dtype == (torch.float32 if got is lse else dt)
        assert _rel_err(got, ref) <= (1e-5 if got is lse else tol), name
    # a second run on the same inputs is bitwise the first (no atomics)
    o2, lse2 = tfa._flash_fwd(q, k, v, causal)
    grads2 = tfa.flash_attention_bwd(q, k, v, o2, lse2, do, causal)
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"),
                          (o, lse) + tuple(grads), (o2, lse2) + tuple(grads2)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,s_q,s_k,hd", [
    (1, 2, 8, 16, 64),           # keys longer than queries
    (1, 2, 16, 8, 64),           # and shorter
    (2, 3, 100, 37, 32),         # ragged tiles both ways
    (1, 4, 64, 64, 128),         # one length, head_dim 128
    (2, 2, 40, 72, 80),
    (1, 1, 24, 24, 256),         # the largest head_dim
    (1, 2, 33, 33, 8),
    (1, 2, 130, 70, 128),        # head_dim 128, ragged, s_q > s_k
    (1, 2, 70, 200, 128),        # and s_q < s_k
    (2, 4, 256, 512, 64),        # several key tiles a query tile
])
def test_flash_attention_fma_route_matches_plain(card, dtype, causal, b, h,
                                                 s_q, s_k, hd):
    """Both routes at every shape the TPU kernel takes: bfloat16 at head
    dims 32 / 64 / 128 on "wgmma" at any s_q and s_k, every other call on
    "fma"; o, lse, dq, dk, dv against the plain versions (the limits of
    test_flash_attention_kernels_match_plain), each launch on the route
    flash_route names, and a second run bitwise equal."""
    rng = np.random.RandomState(hd + s_k)
    dt = getattr(torch, dtype)
    q, do = (torch.from_numpy(rng.randn(b, h, s_q, hd).astype(
        np.float32)).to(card, dt) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, h, s_k, hd).astype(
        np.float32)).to(card, dt) for _ in range(2))
    route = tfa.flash_route(dt, hd, s_q, s_k)
    assert route == ("wgmma" if dtype == "bfloat16"
                     and hd in (32, 64, 128) else "fma")
    other = "fma" if route == "wgmma" else "wgmma"
    r0 = {n: dict(tfa.ROUTES[n]) for n in ("flash_attention",
                                           "flash_attention_bwd")}
    o, lse = tfa._flash_fwd(q, k, v, causal)
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for n in r0:
        assert tfa.ROUTES[n][route] == r0[n][route] + 1, n
        assert tfa.ROUTES[n][other] == r0[n][other], n
    scale = 1.0 / hd ** 0.5
    f = [t.float() for t in (q, k, v, do)]
    ro, rl = tfa._flash_fwd_torch(f[0], f[1], f[2], causal, scale)
    rg = tfa._flash_bwd_torch(f[0], f[1], f[2], ro.to(dt).float(), rl,
                              f[3], causal, scale)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for name, got, ref in zip(("o", "lse", "dq", "dk", "dv"),
                              (o, lse) + tuple(grads), (ro, rl) + tuple(rg)):
        assert got.shape == ref.shape, name
        assert _rel_err(got, ref) <= (1e-5 if got is lse else tol), name
    o2, lse2 = tfa._flash_fwd(q, k, v, causal)
    grads2 = tfa.flash_attention_bwd(q, k, v, o2, lse2, do, causal)
    for name, a, b_ in zip(("o", "lse", "dq", "dk", "dv"),
                           (o, lse) + tuple(grads),
                           (o2, lse2) + tuple(grads2)):
        assert torch.equal(a, b_), name


def test_flash_attention_rejects_head_dim_without_kernel(card):
    """Every head_dim up to 256 has a route on the card; above it the
    call raises naming the ROADMAP item."""
    q = torch.zeros(1, 1, 16, 264, device=card)
    with pytest.raises(tfa.MXNetError, match="head_dim.*B.5"):
        tfa.flash_attention(q, q, q)


def test_contrib_flash_attention_on_card_matches_cpu(card):
    rng = np.random.RandomState(4)
    arrays = [rng.randn(2, 2, n, 128).astype(np.float32)
              for n in (24, 40, 40)]
    head = rng.randn(2, 2, 24, 128).astype(np.float32)
    out = {}
    for ctx in (tmx.cpu(), tmx.gpu(0)):
        nds = [tmx.nd.array(a, ctx=ctx) for a in arrays]
        for a in nds:
            a.attach_grad()
        n0 = tfa.LAUNCHES["flash_attention"]
        with tmx.autograd.record():
            o = tmx.nd.contrib.flash_attention(*nds, causal=True)
        o.backward(tmx.nd.array(head, ctx=ctx))
        out[str(ctx)] = ([o.asnumpy()] + [a.grad.asnumpy() for a in nds],
                         tfa.LAUNCHES["flash_attention"] - n0)
    (cpu, n_cpu), (gpu, n_gpu) = out["cpu(0)"], out["gpu(0)"]
    assert n_cpu == 0 and n_gpu == 1
    for name, g, c in zip(("out", "dq", "dk", "dv"), gpu, cpu):
        np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("remat,num_experts", [(True, 0), (False, 4)])
def test_moe_and_remat_train_steps_on_card_match_cpu(card, remat,
                                                     num_experts):
    cfg = T.TransformerConfig(vocab_size=128, d_model=128, n_heads=2,
                              n_layers=2, d_ff=256, max_len=96,
                              remat=remat, num_experts=num_experts,
                              capacity_factor=1.0)
    rng = np.random.RandomState(9)
    tok = torch.from_numpy(rng.randint(0, 128, (2, 2, 96)))
    tgt = torch.from_numpy(rng.randint(0, 128, (2, 2, 96)))
    step = T.make_transformer_train_step(cfg, lr=0.1)
    runs = {}
    for dev in ("cpu", card):
        params = T.init_transformer_params_np(cfg, seed=5, device=dev,
                                              trainable=True)
        tfa.reset_launches()
        losses = [float(step(params, tok[i], tgt[i])[1]) for i in range(2)]
        runs[str(dev)] = (losses, params, dict(tfa.LAUNCHES))
    (l_cpu, p_cpu, _), (l_gpu, p_gpu, launches) = runs["cpu"], runs[
        str(card)]
    fwd = 2 if remat else 1
    assert launches["flash_attention"] == 2 * fwd * cfg.n_layers
    assert launches["flash_attention_bwd"] == 2 * cfg.n_layers
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5, atol=1e-5)
    for (name, a), (_, b) in zip(p_gpu.named_parameters(),
                                 p_cpu.named_parameters()):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(), atol=1e-5,
                                   err_msg=name)


def test_moe_ffn_queues_no_host_sync(card):
    """The MoE layer's routing, dispatch by index and combine, forward
    and backward, with tokens dropped (capacity 0.5), never wait for the
    card: each sync would stall the host that queues the step. Its
    output and gradients equal the CPU's within 1e-4 of each tensor's
    largest magnitude (float32 sums in other orders)."""
    from mxnet_tpu_torch.parallel.moe import moe_ffn
    gen = torch.Generator().manual_seed(11)
    shapes = (((256, 64), 1.0), ((64, 8), 0.5), ((8, 64, 128), 0.125),
              ((8, 128, 64), 0.088))
    cpu = [(torch.randn(*shape, generator=gen) * sd).requires_grad_()
           for shape, sd in shapes]
    head = torch.randn(256, 64, generator=gen)
    dev = [t.detach().to(card).requires_grad_() for t in cpu]
    head_d = head.to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe_ffn(*dev, capacity_factor=0.5)
        ((out * head_d).sum() + aux).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out_c, aux_c = moe_ffn(*cpu, capacity_factor=0.5)
    ((out_c * head).sum() + aux_c).backward()
    pairs = [("out", out.detach(), out_c.detach()),
             ("aux", aux.detach(), aux_c.detach())] + [
        ("grad%d" % i, d.grad, c.grad) for i, (d, c) in
        enumerate(zip(dev, cpu))]
    for name, d, c in pairs:
        c = c.numpy()
        err = float(np.abs(d.cpu().numpy() - c).max())
        assert err <= 1e-4 * max(float(np.abs(c).max()), 1.0), (name, err)


@pytest.mark.parametrize("num_experts", [0, 4])
def test_generate_on_card_matches_cpu_and_paged_engine(card, num_experts):
    cfg = T.TransformerConfig(vocab_size=128, d_model=128, n_heads=4,
                              n_kv_heads=2, n_layers=2, d_ff=256,
                              max_len=64, pos_type="rope",
                              num_experts=num_experts)
    prompt = torch.from_numpy(np.random.RandomState(2).randint(
        0, 128, (1, 12)).astype(np.int32))
    gen = {}
    for dev in ("cpu", card):
        params = T.init_transformer_params_np(cfg, seed=4, device=dev)
        gen[str(dev)] = T.transformer_generate(params, prompt.to(dev), 10,
                                               cfg).cpu()
    assert torch.equal(gen["cpu"], gen[str(card)])
    eng = DecodeEngine(params, cfg, DecodeConfig(
        slots=4, page_size=16, num_pages=32, max_context=64)).start()
    try:
        tfa.reset_launches()
        out = eng.submit(prompt[0].tolist(), max_new_tokens=10).result()
    finally:
        eng.close(drain=False)
    assert out == gen["cpu"][0].tolist()
    assert tfa.LAUNCHES["flash_prefill_paged"] == cfg.n_layers
    assert tfa.LAUNCHES["paged_decode_attention"] == 9 * cfg.n_layers


def test_train_step_on_card_matches_cpu(card):
    cfg = T.TransformerConfig(vocab_size=128, d_model=128, n_heads=2,
                              n_kv_heads=1, n_layers=2, d_ff=256,
                              max_len=96, pos_type="rope")
    rng = np.random.RandomState(9)
    tok = torch.from_numpy(rng.randint(0, 128, (2, 2, 96)))
    tgt = torch.from_numpy(rng.randint(0, 128, (2, 2, 96)))
    step = T.make_transformer_train_step(cfg, lr=0.1)
    runs = {}
    for dev in ("cpu", card):
        params = T.init_transformer_params_np(cfg, seed=5, device=dev,
                                              trainable=True)
        tfa.reset_launches()
        losses = [float(step(params, tok[i], tgt[i])[1]) for i in range(2)]
        runs[str(dev)] = (losses, params, dict(tfa.LAUNCHES))
    (l_cpu, p_cpu, _), (l_gpu, p_gpu, launches) = runs["cpu"], runs[
        str(card)]
    assert launches["flash_attention"] == 2 * cfg.n_layers
    assert launches["flash_attention_bwd"] == 2 * cfg.n_layers
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5, atol=1e-5)
    for (name, a), (_, b) in zip(p_gpu.named_parameters(),
                                 p_cpu.named_parameters()):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(), atol=1e-5,
                                   err_msg=name)


def test_bf16_train_gradients_match_plain_attention_route(card):
    cfg = T.TransformerConfig(vocab_size=256, d_model=256, n_heads=4,
                              n_layers=2, d_ff=512, max_len=128,
                              dtype=torch.bfloat16)
    params = T.init_transformer_params_np(cfg, seed=6, device=card,
                                          trainable=True)
    rng = np.random.RandomState(10)
    tok, tgt = (torch.from_numpy(rng.randint(0, 256, (2, 128))).to(card)
                for _ in range(2))
    leaves = list(params.parameters())
    runs = {}
    for impl in ("auto", "einsum"):
        tfa.reset_launches()
        loss = T._lm_local_loss(params, tok, tgt, cfg, attn_impl=impl)
        grads = torch.autograd.grad(loss, leaves)
        runs[impl] = (float(loss.detach()), grads, dict(tfa.LAUNCHES))
    assert runs["auto"][2]["flash_attention_bwd"] == cfg.n_layers
    assert runs["einsum"][2]["flash_attention"] == 0
    # one bf16 ulp of the summed token losses (256 of them, ~5.5 each)
    assert abs(runs["auto"][0] - runs["einsum"][0]) <= 8.0 / 256
    for (name, _), g, r in zip(params.named_parameters(), runs["auto"][1],
                               runs["einsum"][1]):
        assert _rel_err(g[None, None], r[None, None]) <= 2e-2, name


def _update_lists(card, kind, shapes, misaligned, seed):
    """Weights, grads, states and per-tensor hypers on the card; with
    ``misaligned`` every tensor starts one float past a 16-byte boundary
    (the kernel's scalar path)."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(shape, scale=1.0):
        n = int(np.prod(shape))
        buf = (torch.randn(n + 1, generator=gen) * scale).to(card)
        return (buf[1:] if misaligned else buf[:n]).view(shape)

    ws = [rnd(s, 0.1) for s in shapes]
    gs = [rnd(s) for s in shapes]
    n_state = {"sgd": 0, "sgd_mom": 1, "adam": 2}[kind]
    states = [tuple(rnd(s, 0.01).abs() for _ in range(n_state))
              for s in shapes]
    hypers = []
    for i in range(len(shapes)):
        h = {"lr": 0.05 * (i + 1), "wd": 1e-4 * i, "rescale_grad": 0.25,
             "clip_gradient": 0.3}
        if kind == "sgd_mom":
            h["momentum"] = 0.9
        elif kind == "adam":
            h.update(beta1=0.9, beta2=0.999, one_minus_beta1=0.1,
                     one_minus_beta2=1.0 - 0.999, epsilon=1e-8)
        hypers.append(h)
    return ws, gs, states, hypers


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("kind", ["sgd_mom", "sgd", "adam"])
def test_fused_update_kernel_matches_plain_bitwise(card, kind, misaligned):
    shapes = [(7,), (1000,), (64, 3, 7, 7), (4097,), (2048, 1000)]
    ws, gs, states, hypers = _update_lists(card, kind, shapes, misaligned,
                                           12)
    if misaligned:
        assert ws[0].data_ptr() % 16 != 0
    ref_w = [w.clone() for w in ws]
    ref_s = [tuple(x.clone() for x in st) for st in states]
    kernel = tfu.adam_fused_update if kind == "adam" \
        else tfu.sgd_fused_update
    plain = tfu._adam_fused if kind == "adam" else tfu._sgd_fused
    n0 = dict(tfu.LAUNCHES)
    kernel(ws, gs, states, hypers)
    plain(ref_w, gs, ref_s, hypers)
    torch.cuda.synchronize()
    name = "adam_fused_update" if kind == "adam" else "sgd_fused_update"
    assert tfu.LAUNCHES[name] == n0[name] + 1       # one launch per list
    for a, b in zip(ws, ref_w):
        assert torch.equal(a, b)
    for sa, sb in zip(states, ref_s):
        for a, b in zip(sa, sb):
            assert torch.equal(a, b)


# each rule's hypers beside lr, wd and rescale_grad, and its state counts
_RULE_HYPERS = {
    "sgd": (dict(momentum=0.9), (0, 1)),
    "nag": (dict(momentum=0.9), (0, 1)),
    "signum": (dict(momentum=0.9, one_minus_momentum=0.1, wdlh_coef=0.999,
                    lr_wd=1e-5), (0, 1)),
    "adam": (dict(beta1=0.9, beta2=0.999, one_minus_beta1=0.1,
                  one_minus_beta2=1 - 0.999, epsilon=1e-8), (2,)),
    "adagrad": (dict(eps=1e-7), (1,)),
    "rmsprop": (dict(gamma1=0.9, one_minus_gamma1=0.1, epsilon=1e-8,
                     clip_weights=0.5), (1, 3)),
    "adadelta": (dict(rho=0.9, one_minus_rho=0.1, epsilon=1e-5), (2,)),
    "ftrl": (dict(lamda1=0.01, beta=1.0), (2,)),
    "ftml": (dict(beta1=0.6, one_minus_beta1=0.4, beta2=0.999,
                  one_minus_beta2=1 - 0.999, epsilon=1e-8, d_coef=4.0,
                  v_coef=1 - 0.999), (3,)),
    "adamax": (dict(beta1=0.9, one_minus_beta1=0.1, beta2=0.999), (2,)),
    "test": ({}, (1,)),
}
_RULE_CASES = [(r, d, m) for r in sorted(_RULE_HYPERS)
               for d in ("float32", "bfloat16", "float16")
               for m in ((False, True) if d == "float16" else (False,))]


def _same_bits(a, b):
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return bool(((a.view(ints) == b.view(ints))
                 | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("rule,dtype,master", _RULE_CASES)
def test_fused_update_rules_match_plain_bitwise(card, rule, dtype, master):
    """Every rule of fused_update.cu, each state count, with and without
    clipping, on float32 / bf16 / float16 weights (float16 also in the
    master mode: float32 states and master), one launch a call, bitwise
    equal to the plain version; a bf16 or float16 list with a float32
    tensor in it (a cast net's BatchNorm; beside float16 tensors on
    masters, a float32 one without) takes the same one launch."""
    extra, counts = _RULE_HYPERS[rule]
    dt = getattr(torch, dtype)
    sdt = torch.float32 if master else dt
    shapes = [(7,), (1000,), (64, 3, 7, 7), (4097,), (300, 100)]
    gen = torch.Generator().manual_seed(31)
    name = "%s_fused_update" % rule
    for n_state in counts:
        for clip in (False, True):
            def rnd(shape, scale, t):
                return (torch.randn(shape, generator=gen) * scale).to(card, t)
            types = [dt] * len(shapes)
            if dtype != "float32":
                types[1] = torch.float32
            ws = [rnd(s, 0.05, t) for s, t in zip(shapes, types)]
            gs = [rnd(s, 1.0, t) for s, t in zip(shapes, types)]
            st = [tuple(rnd(s, 0.01, sdt if master else t).abs()
                        for _ in range(n_state))
                  for s, t in zip(shapes, types)]
            ms = [None if w.dtype == torch.float32 else w.float()
                  for w in ws] if master else None
            hs = []
            for i in range(len(shapes)):
                h = dict(lr=0.1 * (i + 1), wd=1e-4 * i, rescale_grad=0.125,
                         **extra)
                if n_state == 3 and rule == "rmsprop":
                    h["gamma2"] = 0.9
                if clip and rule != "test":
                    h["clip_gradient"] = 0.02
                hs.append(h)
            runs = []
            for fn in (getattr(tfu, name), getattr(tfu, "_%s_fused" % rule)):
                w = [x.clone() for x in ws]
                s = [tuple(x.clone() for x in t) for t in st]
                m = [x if x is None else x.clone()
                     for x in ms] if master else None
                n0 = tfu.LAUNCHES[name]
                fn(w, gs, s, hs, m)
                torch.cuda.synchronize()
                runs.append((w, s, m, tfu.LAUNCHES[name] - n0))
            (kw, ks, km, launched), (pw, ps, pm, plain) = runs
            assert (launched, plain) == (1, 0)
            assert all(_same_bits(a, b) for a, b in zip(kw, pw))
            assert all(_same_bits(a, b) for x, y in zip(ks, ps)
                       for a, b in zip(x, y))
            if master:
                pairs = [(w, a, b) for w, a, b in zip(kw, km, pm)
                         if a is not None]
                assert all(_same_bits(a, b) for _, a, b in pairs)
                # the weight is its master rounded (NaN where the master
                # is: centered RMSProp's random states give n < g_acc^2)
                assert all(_same_bits(w, a.to(dt)) for w, a, _ in pairs)


def test_resnet_fit_on_card_matches_cpu(card):
    sym = tmx.models.resnet(num_classes=10, num_layers=8,
                            image_shape=(3, 16, 16), bottle_neck=True)
    rng = np.random.RandomState(13)
    x = rng.uniform(-1, 1, (8, 3, 16, 16)).astype(np.float32)
    y = rng.randint(0, 10, (8,)).astype(np.float32)
    init = tmx.mod.Module(sym, context=tmx.cpu())
    init.bind(data_shapes=[("data", (4, 3, 16, 16))],
              label_shapes=[("softmax_label", (4,))])
    tmx.random.seed(0)
    init.init_params(tmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                     magnitude=2))
    arg0, aux0 = init.get_params()
    runs = {}
    for dev in ("cpu", card):
        mod = tmx.mod.Module(sym, context=dev)
        tfu.reset_launches()
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
                optimizer="sgd", arg_params=arg0, aux_params=aux0,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-4})
        a, s = mod.get_params()
        runs[str(dev)] = ({k: v.asnumpy() for k, v in a.items()},
                          {k: v.asnumpy() for k, v in s.items()},
                          mod.get_outputs()[0].asnumpy(),
                          tfu.LAUNCHES["sgd_fused_update"])
    (ac, sc, oc, _), (ag, sg, og, n) = runs["cpu"], runs[str(card)]
    assert n == 2

    for got, want, start in ((ag, ac, arg0), (sg, sc, aux0)):
        for k in start:
            dg = got[k] - start[k].asnumpy()
            dc = want[k] - start[k].asnumpy()
            assert np.linalg.norm(dg - dc) <= 1e-3 * np.linalg.norm(dc), k
    assert np.linalg.norm(og - oc) <= 1e-4 * np.linalg.norm(oc)


def _i8(rng, *shape):
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("m,k,n", [(1, 8, 4), (5, 37, 11), (16, 256, 64),
                                   (1, 2048, 1000), (32, 2048, 1000),
                                   (200, 147, 70)])
def test_int8_matmul_kernel_matches_plain_bitwise(card, m, k, n):
    rng = np.random.RandomState(m + k)
    x, w = _i8(rng, m, k).to(card), _i8(rng, n, k).to(card)
    s = torch.from_numpy(rng.rand(n).astype(np.float32) * 0.1).to(card)
    s[0] = 0.0                                  # a zero-scale channel
    n0 = ti8.LAUNCHES["int8_matmul"]
    got = ti8.int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert ti8.LAUNCHES["int8_matmul"] == n0 + 1
    assert torch.equal(got, ti8._int8_matmul_plain(x, w, s))


@pytest.mark.parametrize("shape", [
    (2, 3, 33, 31, 64, 1, 7, 7, (2, 2), (1, 1), (3, 3)),   # the stem
    (2, 64, 14, 14, 64, 1, 3, 3, (1, 1), (1, 1), (1, 1)),
    (2, 256, 13, 15, 512, 1, 1, 1, (2, 2), (1, 1), (0, 0)),
    (3, 8, 9, 11, 12, 2, 3, 3, (2, 1), (2, 2), (2, 1)),    # groups, dilate
    (2, 64, 10, 10, 64, 32, 3, 3, (1, 1), (1, 1), (1, 1)),
])
def test_int8_conv_kernel_matches_plain_bitwise(card, shape):
    b, c, h, w, co, g, kh, kw, st, dl, pd = shape
    rng = np.random.RandomState(c + co)
    q, wq = _i8(rng, b, c, h, w).to(card), _i8(rng, co, c // g, kh,
                                                kw).to(card)
    s = torch.from_numpy(rng.rand(co).astype(np.float32) * 0.1).to(card)
    n0 = ti8.LAUNCHES["int8_conv_im2col"]
    got = ti8.int8_conv_im2col(q, wq, s, st, dl, pd, g)
    torch.cuda.synchronize()
    assert ti8.LAUNCHES["int8_conv_im2col"] == n0 + 1
    assert torch.equal(got, ti8._int8_conv_plain(q, wq, s, st, dl, pd, g))


@pytest.mark.parametrize("shape", [
    (2, 64, 14, 14, 64, 1, 3, 3, (1, 1), (1, 1), (1, 1)),
    (2, 256, 13, 15, 512, 1, 1, 1, (2, 2), (1, 1), (0, 0)),
    (3, 96, 17, 23, 40, 1, 5, 3, (2, 3), (1, 1), (2, 1)),
    (2, 64, 15, 13, 32, 2, 3, 3, (1, 1), (2, 2), (2, 2)),
    (1, 32, 1, 1, 16, 1, 3, 3, (1, 1), (1, 1), (1, 1)),
    (3, 128, 5, 5, 200, 1, 3, 3, (2, 2), (1, 1), (1, 1)),
])
def test_int8_conv_wgmma_route_matches_plain_bitwise(card, shape):
    """Channels-last operands take the wgmma route where its shape holds
    (64- and 32-channel chunks, odd tails, dilation, groups, one position
    an image, a channel count off the 64-row tiles)."""
    b, c, h, w, co, g, kh, kw, st, dl, pd = shape
    rng = np.random.RandomState(c + co)
    cl = torch.channels_last
    q = _i8(rng, b, c, h, w).to(card).contiguous(memory_format=cl)
    wq = _i8(rng, co, c // g, kh, kw).to(card).contiguous(memory_format=cl)
    s = torch.from_numpy(rng.rand(co).astype(np.float32) * 0.1).to(card)
    ti8.reset_launches()
    got = ti8.int8_conv_im2col(q, wq, s, st, dl, pd, g)
    torch.cuda.synchronize()
    assert ti8.ROUTES["int8_conv_im2col"] == {"wgmma": 1, "mma_sync": 0}
    assert ti8.CONVERSIONS["int8_conv_im2col"] == 0
    assert torch.equal(got, ti8._int8_conv_plain(q, wq, s, st, dl, pd, g))


@pytest.mark.parametrize("m", [1, 7, 32, 300])
def test_int8_matmul_wgmma_route_repeats_bitwise(card, m):
    """The split-K FC (and a large m, one slice) on the wgmma route, twice:
    the same bits, the workspace left zero between launches."""
    rng = np.random.RandomState(m)
    x, w = _i8(rng, m, 2048).to(card), _i8(rng, 1000, 2048).to(card)
    s = torch.from_numpy(rng.rand(1000).astype(np.float32) * 0.1).to(card)
    ti8.reset_launches()
    first, second = ti8.int8_matmul(x, w, s), ti8.int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert ti8.ROUTES["int8_matmul"] == {"wgmma": 2, "mma_sync": 0}
    assert torch.equal(first, second)
    assert torch.equal(first, ti8._int8_matmul_plain(x, w, s))
    assert all(int(ws.abs().max()) == 0 for ws in ti8._workspaces.values())


@pytest.mark.parametrize("op,nd", [("_contrib_quantized_fc_int8", 0),
                                   ("_contrib_quantized_conv_int8", 1),
                                   ("_contrib_quantized_conv_int8", 2),
                                   ("_contrib_quantized_conv_int8", 3)])
def test_quantized_ops_on_card_match_cpu_bitwise(card, op, nd):
    rng = np.random.RandomState(nd)
    if nd == 0:
        arrays = [rng.randn(6, 48).astype(np.float32),
                  rng.randint(-127, 128, (10, 48)).astype(np.int8)]
        attrs = {"num_hidden": 10}
    else:
        space = {1: (13,), 2: (9, 11), 3: (5, 6, 7)}[nd]
        arrays = [rng.randn(2, 4, *space).astype(np.float32),
                  rng.randint(-127, 128, (10, 2) + (3,) * nd).astype(
                      np.int8)]
        attrs = {"kernel": (3,) * nd, "stride": (2,) + (1,) * (nd - 1),
                 "pad": (1,) * nd, "num_filter": 10, "num_group": 2}
    arrays += [rng.rand(10).astype(np.float32) * 0.1,
               rng.randn(10).astype(np.float32)]
    attrs["act_scale"] = 127.0 / 2.71
    fn = treg.get_op(op).fn
    cpu = fn(*[torch.from_numpy(a) for a in arrays], **attrs)
    ti8.reset_launches()
    got = fn(*[torch.from_numpy(a).to(card) for a in arrays], **attrs)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cpu)
    kernel = "int8_matmul" if nd == 0 else "int8_conv_im2col"
    assert ti8.LAUNCHES[kernel] == (1 if nd in (0, 2) else 0)


def test_int8_resnet_served_on_card_matches_cpu(card, tmp_path):
    shape = (3, 16, 16)
    sym = tmx.models.resnet(num_classes=10, num_layers=8, image_shape=shape,
                            bottle_neck=True)
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (4,) + shape)],
             label_shapes=[("softmax_label", (4,))])
    tmx.random.seed(0)
    mod.init_params(tmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    prefix = str(tmp_path / "r8")
    tmx.model.save_checkpoint(prefix, 0, sym, *mod.get_params())
    x = np.random.RandomState(1).uniform(-1, 1, (8,) + shape).astype(
        np.float32)
    qp = tmx.quantize.quantize_checkpoint(prefix, [x], calib_mode="naive",
                                          ctx=card)
    pred = tmx.serving.Predictor(qp.symbol_json, qp.param_bytes(),
                                 input_shapes={"data": (8,) + shape})
    ti8.reset_launches()
    tbn.reset_launches()
    pred.set_input("data", x.tobytes())
    pred.forward()
    out = np.frombuffer(pred.get_output(0), np.float32)
    assert dict(ti8.LAUNCHES) == {"int8_conv_im2col": 13, "int8_matmul": 1}
    from mxnet_tpu_torch.symbol.symbol import _topo
    assert tbn.LAUNCHES["batch_norm_inference"] == sum(
        n.op == "BatchNorm" for n in _topo(qp.symbol._entries))
    assert out.shape == (80,) and np.isfinite(out).all()
    # each int8 layer on the card, given its input there, equals the same
    # layer on the CPU given that input
    internals = qp.symbol.get_internals()
    exe = internals.simple_bind(ctx=card, grad_req="null",
                                type_dict={k: v.dtype for k, v in
                                           qp.arg_params.items()},
                                data=(8,) + shape)
    exe.copy_params_from(qp.arg_params, qp.aux_params,
                         allow_extra_params=True)
    vals = dict(zip(internals.list_outputs(),
                    exe.forward(is_train=False, data=x)))
    layers = [n for n in _topo(qp.symbol._entries)
              if n.op and n.op.startswith("_contrib_quantized")]
    assert len(layers) == 14
    for node in layers:
        src = node.inputs[0][0]
        data = vals[src.name if src.is_var else src.name + "_output"]
        args = [qp.arg_params[n.name]._data for n, _ in node.inputs[1:]]
        attrs = {k: v for k, v in node.attrs.items()
                 if not k.startswith("__")}
        cpu = treg.get_op(node.op).fn(data._data.cpu(), *args, **attrs)
        assert torch.equal(vals[node.name + "_output"]._data.cpu(), cpu), \
            node.name


@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("shape,offset", [
    ((32, 64, 56, 56), 0),      # 16-byte path
    ((32, 2048, 7, 7), 0),      # a plane of 49 floats: scalar path
    ((3, 5, 4, 4), 1),          # misaligned: scalar path
    ((7, 10), 0),               # 2-D
])
def test_batch_norm_kernel_matches_plain_and_cpu_bitwise(card, shape, offset,
                                                         fix_gamma):
    rng = np.random.RandomState(21)
    c = shape[1]
    x = rng.randn(*shape).astype(np.float32) * 3 + 1
    params = [rng.rand(c).astype(np.float32) + 0.5,
              rng.randn(c).astype(np.float32),
              rng.randn(c).astype(np.float32),
              rng.rand(c).astype(np.float32) * 2 + 0.1]
    buf = torch.zeros(x.size + offset, device=card)
    xd = buf[offset:].view(shape)
    xd.copy_(torch.from_numpy(x))
    pd = [torch.from_numpy(p).to(card) for p in params]
    tbn.reset_launches()
    got = tbn.batch_norm_inference(xd, *pd, 1e-3, fix_gamma)
    torch.cuda.synchronize()
    assert tbn.LAUNCHES == {"batch_norm_inference": 1}
    assert torch.equal(got, tbn._batch_norm_inference_plain(
        xd, *pd, 1e-3, fix_gamma))
    attrs = {"fix_gamma": fix_gamma, "use_global_stats": True}
    cpu = treg.get_op("BatchNorm").fn(
        *map(torch.from_numpy, [x] + params), **attrs)
    assert torch.equal(treg.get_op("BatchNorm").fn(xd, *pd, **attrs).cpu(),
                       cpu)


def test_batch_norm_kernel_gradients_are_the_plain_versions(card):
    rng = np.random.RandomState(22)
    arrays = [rng.randn(4, 6, 5, 5).astype(np.float32),
              rng.rand(6).astype(np.float32) + 0.5,
              rng.randn(6).astype(np.float32), rng.randn(6).astype(np.float32),
              rng.rand(6).astype(np.float32) + 0.1]
    dy = torch.from_numpy(rng.randn(4, 6, 5, 5).astype(np.float32)).to(card)
    grads = {}
    for route in ("kernel", "plain"):
        ts = [torch.from_numpy(a).to(card).requires_grad_(i < 3)
              for i, a in enumerate(arrays)]
        tbn.reset_launches()
        fn = tbn.batch_norm_inference if route == "kernel" \
            else tbn._batch_norm_inference_plain
        out = fn(*ts, 1e-3)
        grads[route] = torch.autograd.grad(out, ts[:3], dy)
        assert tbn.LAUNCHES["batch_norm_inference"] == (route == "kernel")
    for a, b in zip(grads["kernel"], grads["plain"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# rtc: runtime-compiled CUDA kernels, and a Gluon step on the card
# ---------------------------------------------------------------------------

RTC_SRC = r'''
template <typename T>
__global__ void scale_t(const T *x, T *y, T s, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = x[i] * s;
}
extern "C" __global__ void row_sum(const float *x, float *y, int cols) {
    extern __shared__ float row[];
    const float *src = x + (size_t)blockIdx.x * cols;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) row[c] = src[c];
    __syncthreads();
    for (int c = threadIdx.x + blockDim.x; c < cols; c += blockDim.x)
        row[threadIdx.x] += row[c];
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w /= 2) {
        if (threadIdx.x < w) row[threadIdx.x] += row[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) y[blockIdx.x] = row[0];
}
'''


@pytest.fixture
def rtc_mod(card):
    return tmx.rtc.CudaModule(RTC_SRC, exports=["scale_t<float>",
                                                "scale_t<double>"])


def test_rtc_template_kernels_through_exports(card, rtc_mod):
    """A template kernel found by its exported name, in two types,
    bitwise against PyTorch's multiply."""
    for name, dt in (("float", torch.float32), ("double", torch.float64)):
        k = rtc_mod.get_kernel("scale_t<%s>" % name, "const %s *x, %s *y, "
                               "%s s, int n" % (name, name, name))
        x = tmx.nd.NDArray(torch.randn(1000, dtype=dt, device=card))
        y = tmx.nd.NDArray(torch.empty_like(x._data))
        k.launch([x, y, 0.75, 1000], card, (4, 1, 1), (256, 1, 1))
        torch.cuda.synchronize()
        assert torch.equal(y._data, x._data * 0.75)


def test_rtc_dynamic_shared_memory_above_48kb(card, rtc_mod):
    """64 KB of dynamic shared memory a block (cuFuncSetAttribute), the
    row sums within 2e-6 of the sum of |x| (another summation order)."""
    cols = 16384
    k = rtc_mod.get_kernel("row_sum", "const float *x, float *y, int cols")
    x = tmx.nd.NDArray(torch.randn(5, cols, device=card))
    y = tmx.nd.NDArray(torch.empty(5, device=card))
    k.launch([x, y, cols], card, (5, 1, 1), (256, 1, 1), shared_mem=4 * cols)
    torch.cuda.synchronize()
    err = (y._data - x._data.sum(dim=1)).abs().max()
    assert err <= 2e-6 * x._data.abs().sum(dim=1).max()


def test_rtc_launch_from_a_second_thread(card, rtc_mod):
    """A thread that never touched CUDA: the launcher makes the device's
    primary context current, and the kernel runs on PyTorch's stream."""
    import threading
    k = rtc_mod.get_kernel("scale_t<float>", "const float *x, float *y, "
                           "float s, int n")
    x = tmx.nd.NDArray(torch.randn(4096, device=card))
    y = tmx.nd.NDArray(torch.zeros(4096, device=card))
    errors = []

    def run():
        try:
            k.launch([x, y, 2.0, 4096], card, (16, 1, 1), (256, 1, 1))
        except Exception as e:          # reported by the assert below
            errors.append(e)

    th = threading.Thread(target=run)
    th.start()
    th.join()
    torch.cuda.synchronize()
    assert not errors
    assert torch.equal(y._data, x._data * 2.0)


def test_rtc_compile_and_launch_errors_raise(card, rtc_mod):
    with pytest.raises(tmx.MXNetError, match="undeclared_name"):
        tmx.rtc.CudaModule('extern "C" __global__ void f(float *y) '
                           '{ y[0] = undeclared_name; }')
    k = rtc_mod.get_kernel("row_sum", "const float *x, float *y, int cols")
    x = tmx.nd.NDArray(torch.randn(2, 8, device=card))
    y = tmx.nd.NDArray(torch.empty(2, device=card))
    with pytest.raises(tmx.MXNetError, match="cuLaunchKernel"):
        k.launch([x, y, 8], card, (2, 1, 1), (2048, 1, 1))


def test_gluon_step_on_card_matches_cpu(card):
    """One Trainer step of a small Gluon net (conv, BatchNorm, dense) on
    the card and on the CPU from one state: one sgd_fused_update launch,
    the weights' and running statistics' changes within 1e-3 relative
    RMS of the CPU's (float32 sums in another order; TF32 off)."""
    def build():
        net = tmx.gluon.nn.HybridSequential(prefix="cs_")
        with net.name_scope():
            net.add(tmx.gluon.nn.Conv2D(8, 3, padding=1, use_bias=False),
                    tmx.gluon.nn.BatchNorm(), tmx.gluon.nn.Activation("relu"),
                    tmx.gluon.nn.GlobalAvgPool2D(), tmx.gluon.nn.Dense(5))
        return net

    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (4, 3, 8, 8)).astype(np.float32)
    y = rng.randint(0, 5, (4,)).astype(np.float32)
    ref = build()
    ref.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    ref(tmx.nd.array(x, ctx=tmx.cpu()))
    state = tmx.convert.gluon_params_to_numpy(ref)
    runs = {}
    for dev in (tmx.cpu(), card):
        net = build()
        tmx.convert.gluon_params_from_jax(state, net, ctx=dev)
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1, "momentum": 0.9})
        tfu.reset_launches()
        with tmx.autograd.record():
            loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(
                net(tmx.nd.array(x, ctx=dev)), tmx.nd.array(y, ctx=dev))
        loss.backward()
        trainer.step(4)
        runs[dev.type] = (tmx.convert.gluon_params_to_numpy(net),
                          tfu.LAUNCHES["sgd_fused_update"])
    assert runs["cuda"][1] == 1
    for k, v in state.items():
        dg, dc = runs["cuda"][0][k] - v, runs["cpu"][0][k] - v
        assert np.linalg.norm(dg - dc) <= 1e-3 * np.linalg.norm(dc), k


# ---------------------------------------------------------------------------
# hybridize: the traced Symbol replayed as CUDA graphs
# ---------------------------------------------------------------------------

def _hyb_net(prefix="hy_"):
    nn = tmx.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, use_bias=False), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2), nn.Conv2D(8, 3),
                nn.BatchNorm(), nn.Activation("relu"), nn.GlobalAvgPool2D(),
                nn.Flatten(), nn.Dense(5))
    return net


def _hyb_pair(card, seed=8):
    """(hybridized net, eager twin) on the card from one state."""
    rng = np.random.RandomState(seed)
    ref = _hyb_net()
    ref.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    ref(tmx.nd.array(rng.uniform(-1, 1, (2, 3, 12, 12)), ctx=tmx.cpu()))
    state = tmx.convert.gluon_params_to_numpy(ref)
    nets = []
    for _ in range(2):
        net = _hyb_net()
        tmx.convert.gluon_params_from_jax(state, net, ctx=card)
        nets.append(net)
    nets[0].hybridize()
    return nets


def _hyb_x(card, seed, n=4):
    rng = np.random.RandomState(seed)
    return tmx.nd.array(rng.uniform(-1, 1, (n, 3, 12, 12)), ctx=card)


def test_graph_replay_equals_symbol_evaluation_bitwise(card):
    """The CachedOp's replay against its direct evaluation of the same
    Symbol on the card: predict-mode outputs bitwise; a recorded
    training call's outputs and running statistics bitwise, its
    gradients within 1e-5 relative (cuDNN's backward may sum in another
    order)."""
    net, _ = _hyb_pair(card)
    x = _hyb_x(card, 1)
    with tmx.autograd.predict_mode():
        got = net(x)
        op = net._cached_op
        want = op.eager(x)
    assert torch.equal(got._data, want._data)
    assert op.runner.captures == 1
    params = net.collect_params()
    runs = []
    for graphed in (True, False):
        before = {k: p.data()._data.clone() for k, p in params.items()}
        with tmx.autograd.record():
            out = net(x) if graphed else op.eager(x)
            loss = (out * out).sum()
        loss.backward()
        runs.append((out._data.clone(),
                     {k: p.data()._data.clone() for k, p in params.items()},
                     {k: p.grad()._data.clone() for k, p in params.items()
                      if p.grad_req != "null"}))
        for k, p in params.items():        # the same start for both
            p.data()._data.detach().copy_(before[k])
    (o1, p1, g1), (o2, p2, g2) = runs
    assert torch.equal(o1, o2)
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    for k in g1:
        assert torch.norm(g1[k] - g2[k]) <= 1e-5 * torch.norm(g2[k]), k
    assert op.runner.captures == 2


def test_graph_replays_count_their_kernel_launches(card):
    """Predict mode: each replay adds one batch_norm_inference launch a
    BatchNorm node, as the eager forward does; the capture adds none."""
    net, twin = _hyb_pair(card)
    x = _hyb_x(card, 2)
    with tmx.autograd.predict_mode():
        tbn.reset_launches()
        twin(x)
        eager = tbn.LAUNCHES["batch_norm_inference"]
        net(x)                               # warm-up, capture, replay
        assert tbn.LAUNCHES["batch_norm_inference"] == 3 * eager
        tbn.reset_launches()
        for _ in range(3):
            net(x)
    assert eager == 2 and tbn.LAUNCHES["batch_norm_inference"] == 3 * eager


def test_graph_outputs_survive_later_replays(card):
    net, twin = _hyb_pair(card)
    x1, x2 = _hyb_x(card, 3), _hyb_x(card, 4)
    with tmx.autograd.predict_mode():
        a = net(x1)
        held = a._data.clone()
        b = net(x2)
        assert torch.equal(a._data, held)
        assert not torch.equal(a._data, b._data)
        assert torch.equal(b._data, twin(x2)._data)


def test_graph_training_matches_eager_on_card(card):
    """Three Trainer steps hybridized and eager from one state: the same
    losses and weights within 1e-5 relative, one sgd_fused_update launch
    a step; gradients handed to the parameters alias no static buffer;
    two recorded forwards before one backward keep their own
    activations; a second backward without retain_graph raises; new
    parameter storage takes a new capture."""
    net, twin = _hyb_pair(card)
    y = tmx.nd.array(np.arange(4) % 5, ctx=card)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    res = []
    for n in (net, twin):
        trainer = tmx.gluon.Trainer(n.collect_params(), "sgd",
                                    {"learning_rate": 0.1, "momentum": 0.9})
        tfu.reset_launches()
        losses, first_grad = [], None
        for step in range(3):
            with tmx.autograd.record():
                loss = loss_fn(n(_hyb_x(card, 10 + step)), y)
            loss.backward()
            if step == 0:
                g = n.collect_params()["hy_dense0_weight"].grad()._data
                first_grad = (g, g.clone())
            trainer.step(4)
            losses.append(loss._data.clone())
        assert tfu.LAUNCHES["sgd_fused_update"] == 3
        assert torch.equal(first_grad[0], first_grad[1])
        res.append((torch.stack(losses), {
            k: p.data()._data.clone() for k, p in n.collect_params().items()}))
    assert torch.norm(res[0][0] - res[1][0]) <= 1e-5 * torch.norm(res[1][0])
    for k, v in res[1][1].items():
        assert torch.norm(res[0][1][k] - v) <= 1e-5 * torch.norm(v), k
    # two forwards, one backward: each keeps its activations
    for n in (net, twin):
        n.collect_params().zero_grad()
        with tmx.autograd.record(train_mode=False):
            loss = (n(_hyb_x(card, 20)) * n(_hyb_x(card, 21))).sum()
        loss.backward()
    for k, p in net.collect_params().items():
        if p.grad_req != "null":
            want = twin.collect_params()[k].grad()._data
            assert torch.norm(p.grad()._data - want) <= \
                1e-5 * torch.norm(want), k
    with pytest.raises(tmx.base.MXNetError, match="retain_graph"):
        loss.backward()
    captures = net._cached_op.runner.captures
    net.collect_params()["hy_dense0_weight"].initialize(
        ctx=card, force_reinit=True)
    with tmx.autograd.predict_mode():
        got = net(_hyb_x(card, 5))
    assert net._cached_op.runner.captures == captures + 1
    twin.collect_params()["hy_dense0_weight"].set_data(
        net.collect_params()["hy_dense0_weight"].data())
    with tmx.autograd.predict_mode():
        assert torch.equal(got._data, twin(_hyb_x(card, 5))._data)


def test_graph_capture_failure_raises_and_runs_nothing_in_its_place(card):
    """An op that reads a value back to the host (``.item()``) cannot be
    captured: the call raises MXNetError naming the block and the
    capture, returns nothing, and the card keeps working."""
    net, twin = _hyb_pair(card)
    act = treg.get_op("Activation")
    sound = act.fn

    def syncing(data, act_type="relu"):
        data.sum().item()           # reads a value back to the host
        return sound(data, act_type)

    act.fn = syncing
    try:
        with tmx.autograd.predict_mode():
            with pytest.raises(tmx.base.MXNetError,
                               match="hy.*capture of its forward failed"):
                net(_hyb_x(card, 6))
    finally:
        act.fn = sound
    torch.cuda.synchronize()
    with tmx.autograd.predict_mode():
        assert torch.equal(net(_hyb_x(card, 6))._data,
                           twin(_hyb_x(card, 6))._data)


def _register_noise():
    if "hybridize_noise" in tmx.operator._CUSTOM_REGISTRY:
        return

    @tmx.operator.register("hybridize_noise")
    class _NoiseProp(tmx.operator.CustomOpProp):
        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class _Op(tmx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    u = tmx.nd.random.uniform(0, 1, in_data[0].shape,
                                              ctx=in_data[0].context)
                    self.assign(out_data[0], req[0], in_data[0] * u)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0])
            return _Op()


def test_graph_replays_draw_new_random_numbers(card):
    """A HybridBlock drawing from the port's generator (``nd.random``,
    inside a custom op) draws new numbers on every replay: the graphs
    register the generator."""
    _register_noise()
    net = tmx.gluon.nn.HybridLambda(
        lambda F, x: F.Custom(x, op_type="hybridize_noise"))
    net.hybridize()
    x = tmx.nd.ones((1000,), ctx=card)
    tmx.random.seed(3)
    draws = [net(x)._data.clone() for _ in range(3)]
    assert net._cached_op.runner.captures == 1
    for d in draws:
        assert float(d.min()) >= 0 and float(d.max()) < 1
    assert not torch.equal(draws[1], draws[2])
    assert not torch.equal(draws[0], draws[1])


def test_graph_replays_draw_new_dropout_masks(card):
    """``F.Dropout`` in a hybridized block on the card: each replay of
    the captured training graph draws a new mask from the port's
    generator (registered with the graph), the backward replay uses the
    forward's mask, and ``random.seed`` repeats the masks."""
    net = tmx.gluon.nn.HybridLambda(lambda F, x: F.Dropout(x, p=0.5))
    net.hybridize()
    x = tmx.nd.ones((4096,), ctx=card)
    x.attach_grad()

    def run():
        outs = []
        for _ in range(3):
            with tmx.autograd.record():
                y = net(x)
            y.backward()
            outs.append((y._data.clone(), x.grad._data.clone()))
        return outs

    tmx.random.seed(3)
    first = run()
    assert net._cached_op.runner.captures == 1
    for y, g in first:
        kept = y != 0
        assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
        assert torch.equal(g, y)            # d(x * mask / 0.5) / dx
        assert abs(float(kept.float().mean()) - 0.5) < 4 * (0.25 / 4096) \
            ** 0.5
    assert not torch.equal(first[0][0], first[1][0])
    assert not torch.equal(first[1][0], first[2][0])
    tmx.random.seed(3)
    again = run()
    for (a, _), (b, _) in zip(first, again):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the data path: nvJPEG decode, crop_mirror_normalize, staged batches
# ---------------------------------------------------------------------------

_CLI_MEAN = np.array([123.68, 116.779, 103.939], np.float32)
_CLI_STD = np.array([58.393, 57.12, 57.375], np.float32)


def _jpeg_records(tmp_path, n=24, sampling=None, gray=False):
    import cv2
    from mxnet_tpu_torch import recordio
    rng = np.random.RandomState(2)
    path = str(tmp_path / "r.rec")
    w = recordio.MXIndexedRecordIO(str(tmp_path / "r.idx"), path, "w")
    bufs = []
    for i in range(n):
        h, wd = 60 + i % 7, 70 + 3 * (i % 5)
        grid = rng.uniform(0, 255, (3, 4, 3)).astype(np.float32)
        img = np.clip(cv2.resize(grid, (wd, h)) + rng.randint(
            -20, 21, (h, wd, 3)), 0, 255).astype(np.uint8)
        params = [cv2.IMWRITE_JPEG_QUALITY, 95]
        if sampling is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
        ok, b = cv2.imencode(".jpg", img[..., 0] if gray else img, params)
        bufs.append(b.tobytes())
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                                     bufs[-1]))
    w.close()
    return path, bufs


@pytest.mark.parametrize("sampling,gray", [
    (None, False), (0x111111, False), (0x211111, False), (None, True),
    (0x121111, False), (0x411111, False)],
    ids=["420", "444", "422", "gray", "440", "411"])
def test_nvjpeg_route_matches_python_route(card, tmp_path, sampling, gray):
    """The native route (nvJPEG planes, crop_mirror_normalize) against
    the python route (cv2, Augmenters) on the same records: within 4
    uint8 levels, 0.1 on average (the inverse DCTs' rounding); the
    kernel against its plain version bitwise, on the card and the CPU."""
    from mxnet_tpu_torch import image as timg
    from mxnet_tpu_torch.ops.cuda import image_decode as idec
    path, bufs = _jpeg_records(tmp_path, sampling=sampling, gray=gray)
    kw = dict(path_imgrec=path, mean=_CLI_MEAN, std=_CLI_STD)
    nat = timg.ImageIter(24, (3, 56, 64), preprocess_threads=3, ctx=card,
                         **kw)
    assert nat.route == "native" and nat._native.backend == "nvjpeg"
    a = nat.next().data[0]._data
    b = timg.ImageIter(24, (3, 56, 64), **kw).next().data[0]._data
    lv = (a.cpu().double() - b.double()).abs() * torch.from_numpy(
        _CLI_STD).double().reshape(1, 3, 1, 1)
    assert float(lv.max()) <= 4 and float(lv.mean()) <= 0.1
    dec = timg.NativeImageDecoder((3, 56, 64), rand_crop=True,
                                  rand_mirror=True, mean=_CLI_MEAN,
                                  std=_CLI_STD, backend="nvjpeg")
    src, items = dec.decode_planes(bufs, base=7)
    tidx = idec.LAUNCHES["crop_mirror_normalize"]
    got = idec.crop_mirror_normalize(src, items, (3, 56, 64), _CLI_MEAN,
                                     _CLI_STD)
    assert idec.LAUNCHES["crop_mirror_normalize"] == tidx + 1
    for ref in (idec._crop_mirror_normalize_plain(
            src, items, (3, 56, 64), _CLI_MEAN, _CLI_STD),
            idec._crop_mirror_normalize_plain(
                src.cpu(), items, (3, 56, 64), _CLI_MEAN, _CLI_STD)):
        assert torch.equal(got.cpu(), ref.cpu())
    with pytest.raises(tmx.MXNetError, match="decode"):
        dec.decode_batch([bufs[0], b"\xff\xd8 not a jpeg"])


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("resize,shape", [
    (0, (48, 56)), (96, (48, 56)), (40, (48, 56)), (24, (16, 20))],
    ids=["crop", "resize", "below_crop", "downscale"])
def test_crop_mirror_normalize_every_kind_and_path(card, resize, shape,
                                                   channels):
    """crop_mirror_normalize against its plain version bitwise on random
    planes of every kind (4:1:0 included), sizes 9-300 and one of 900 x
    700: the crop alone and resized to the output where the image is
    smaller (resize 0), the short side resized (96), resized below the
    crop (40: two launches) and far down (24: taps spread past the dense
    window)."""
    from mxnet_tpu_torch import image as timg
    from mxnet_tpu_torch.ops.cuda import image_decode as idec
    rng = np.random.RandomState(resize + channels)
    shapes = [(k, int(rng.randint(9, 300)), int(rng.randint(9, 300)))
              for k in range(7) for _ in range(2)] + [(6, 900, 700)]
    parts, rows, off = [], [], 0
    for kind, h, w in shapes:
        hs, vs = idec._SUBSAMPLING.get(kind, (1, 1))
        ch, cw = (-(-h // vs), -(-w // hs)) if kind else (0, 0)
        parts.append(rng.randint(0, 256, h * w + 2 * ch * cw).astype(
            np.uint8))
        rows.append((off, h, w, kind, ch, cw))
        off += len(parts[-1])
    full = (channels,) + shape
    dec = timg.NativeImageDecoder(full, resize=resize, rand_crop=True,
                                  rand_mirror=True, seed=resize,
                                  backend="nvjpeg", ctx=card)
    plan = dec.plan(np.array([r[1:3] for r in rows], np.int32))
    items = torch.tensor(
        [[r[0], r[1], r[2]] + p[:3] + [r[3], r[4], r[5]] + p[3:]
         for r, p in zip(rows, plan.tolist())], dtype=torch.int64)
    both = ((items[:, 9] != items[:, 1]) | (items[:, 10] != items[:, 2])) \
        & ((items[:, 11] != shape[0]) | (items[:, 12] != shape[1]))
    mean, std = _CLI_MEAN[:channels], _CLI_STD[:channels]
    src = torch.from_numpy(np.concatenate(parts)).to(card)
    before = idec.LAUNCHES["crop_mirror_normalize"]
    got = idec.crop_mirror_normalize(src, items, full, mean, std)
    assert idec.LAUNCHES["crop_mirror_normalize"] - before == \
        1 + int(bool(both.any()))
    want = idec._crop_mirror_normalize_plain(src.cpu(), items, full, mean,
                                             std)
    assert torch.equal(got.cpu(), want)


def test_staged_batches_equal_synchronous_copies(card, tmp_path):
    """ImageRecordIter(prefetch_buffer=2) on the card: batches staged
    through the pinned ring (python route) and decoded on the card
    (native route) equal synchronous copies of the same records, over
    more batches than the ring has slots; they arrive on the card and
    the executor binds them without a copy."""
    from mxnet_tpu_torch import executor
    path, _ = _jpeg_records(tmp_path, n=40)
    for extra in ({}, {"preprocess_threads": 3}):
        args = dict(path_imgrec=path, data_shape=(3, 48, 48), batch_size=6,
                    shuffle=True, rand_crop=True, rand_mirror=True,
                    mean_r=123.68, std_r=58.4, **extra)
        staged = tmx.io.ImageRecordIter(prefetch_buffer=2, ctx=card, **args)
        direct = tmx.io.ImageRecordIter(
            ctx=card if extra else torch.device("cpu"), **args)
        for _ in range(7):
            sb, db = staged.next(), direct.next()
            assert sb.pad == db.pad
            for x, y in zip(sb.data + sb.label, db.data + db.label):
                assert x._data.device.type == "cuda"
                assert torch.equal(x._data, y._data.to(card))
        staged.close()
    sym = tmx.models.mlp(num_classes=40)         # labels 0-39
    mod = tmx.mod.Module(sym, context=card)
    it = tmx.io.ImageRecordIter(prefetch_buffer=2, ctx=card, **args)
    executor.INPUT_COPIES["count"] = 0
    mod.fit(tmx.io.ResizeIter(it, 3), num_epoch=1, optimizer="sgd",
            initializer=tmx.init.Xavier())
    assert executor.INPUT_COPIES["count"] == 0


def _sharded_resnet():
    return tmx.models.resnet(num_classes=10, num_layers=20,
                             image_shape=(3, 28, 28))


def test_sharded_run_steps_graph_matches_eager_steps(card):
    """``ShardedTrainer.run_steps`` (k steps as one CUDA graph) against k
    eager ``step`` calls from the same state, a CIFAR ResNet-20 in
    float32 under deterministic cuDNN: the last loss, every parameter,
    momentum and moving statistic within rtol 1e-5 / atol 1e-6 (the JAX
    package's test of its scan), twice, the second time over new
    batches that ``stage_many`` writes into the same static stack; one
    capture."""
    k, batch = 3, 8
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tmx.random.seed(9)
        tr = tmx.parallel.ShardedTrainer(_sharded_resnet(),
                                         tmx.parallel.make_mesh(), lr=0.05,
                                         momentum=0.9, wd=1e-4)
        graph = list(tr.init((batch, 3, 28, 28), (batch,)))
        eager = [{n: t.clone() for n, t in d.items()} for d in graph]
        rng = np.random.RandomState(9)
        for _ in range(2):
            x = rng.randn(k, batch, 3, 28, 28).astype(np.float32)
            y = rng.randint(0, 10, (k, batch)).astype(np.float32)
            d, lab = tr.stage_many(x, y)
            assert d.device.type == "cuda" and d.dtype == torch.float32
            *graph[:3], loss_g = tr.run_steps(*graph, d, lab)
            for i in range(k):
                *eager[:3], loss_e = tr.step(*eager, x[i], y[i])
            assert abs(float(loss_g) - float(loss_e)) <= 1e-6
            for got, want in zip(graph, eager):
                for n in want:
                    torch.testing.assert_close(got[n], want[n], rtol=1e-5,
                                               atol=1e-6, msg=n)
        assert tr.captures == 1
    finally:
        torch.backends.cudnn.deterministic = det


def _dropout_sym():
    x = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=64,
                               name="fc1")
    x = tmx.sym.Dropout(tmx.sym.Activation(x, act_type="relu"), p=0.5)
    x = tmx.sym.FullyConnected(x, num_hidden=10, name="fc2")
    return tmx.sym.SoftmaxOutput(x, name="softmax")


def test_sharded_run_steps_graph_draws_anew_each_replay(card):
    """A graph that draws (Dropout): an int key gives the same update
    from the same state on every replay and another key another update;
    a generator key advances, so two replays from the same state
    differ."""
    tr = tmx.parallel.ShardedTrainer(_dropout_sym(),
                                     tmx.parallel.make_mesh(), lr=0.1)
    tmx.random.seed(10)
    start = tr.init((16, 32), (16,))
    rng = np.random.RandomState(10)
    d, lab = tr.stage_many(rng.randn(4, 16, 32).astype(np.float32),
                           rng.randint(0, 10, (4, 16)).astype(np.float32))

    kept = [{n: t.clone() for n, t in s.items()} for s in start]

    def run(key):
        # the graph reads the storage it was captured over: the start
        # state is copied into it
        for s, t in zip(kept, start):
            for n in s:
                s[n].copy_(t[n])
        tr.run_steps(*kept, d, lab, key=key)
        return kept[0]["fc1_weight"].clone()

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator(device=card).manual_seed(3)
    e, f = run(gen), run(gen)
    assert not torch.equal(e, f)
    assert tr.captures == 2         # one a key mode


def test_data_pipeline_stages_on_the_card(card):
    """``DataPipeline`` with 2 workers staged on the card: every batch a
    CUDA tensor equal to the host pipeline's, bitwise, over 2 epochs; the
    executor binds the batches without a copy."""
    from mxnet_tpu_torch import executor

    def src():
        return tmx.io.ArrayBatchSource(
            np.random.RandomState(11).randn(70, 12).astype(np.float32),
            np.arange(70, dtype=np.float32) % 10, batch_size=8,
            shuffle=True, seed=11)
    host = tmx.io.DataPipeline(src(), num_workers=0, ctx=tmx.cpu())
    with tmx.io.DataPipeline(src(), num_workers=2, prefetch=2) as p:
        assert p.staged_device.type == "cuda"
        n = 0
        for _ in range(2):
            for a, b in zip(p, host):
                for x, y in zip(a.data + a.label, b.data + b.label):
                    assert x._data.device.type == "cuda"
                    assert torch.equal(x._data.cpu(), y._data)
                n += 1
            p.reset()
            host.reset()
        assert n == 18
        sym = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
            tmx.sym.Variable("data"), num_hidden=10), name="softmax")
        executor.INPUT_COPIES["count"] = 0
        tmx.mod.Module(sym, context=card).fit(p, num_epoch=1)
        assert executor.INPUT_COPIES["count"] == 0
    host.close()
