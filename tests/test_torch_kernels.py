"""The PyTorch/CUDA port's attention kernels against the JAX package.

``paged_decode_attention`` and ``flash_prefill_paged`` of
``mxnet_tpu_torch.ops.cuda.flash_attention``: their plain PyTorch
versions (``_paged_decode_torch``, ``_flash_prefill_torch``) are held
against the JAX package's XLA twins (``_paged_decode_xla``,
``_flash_prefill_xla``) and its Pallas kernels in interpret mode, on the
same numpy-seeded inputs, in float32 at the JAX tests' own tolerance
(rtol/atol 2e-5); pages are compared bitwise. On CPU tensors each
wrapper must route to its plain version and launch nothing; bad dtypes,
shapes and non-contiguous inputs must raise. The route functions and
the decode split plan are pure Python and are held here too: every live
page covered once, no split past the cluster, the head_dim rules; and
the cluster route's arithmetic (per-split (m, l, acc) combined in rank
order, in plain float32) against the XLA twin. The CUDA kernels
themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _decode_case(seed, b, kvh, g, hd, ps, pps, num_pages, lengths):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, kvh, g, hd).astype(np.float32)
    kp = rng.randn(num_pages, ps, kvh, hd).astype(np.float32)
    vp = rng.randn(num_pages, ps, kvh, hd).astype(np.float32)
    bt = (rng.permutation(num_pages - 1)[:b * pps] + 1).reshape(
        b, pps).astype(np.int32)
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


DECODE_CASES = [
    # b, kvh, g, hd, ps, pps, num_pages, lengths (off page multiples)
    (2, 2, 2, 16, 4, 3, 10, [5, 11]),        # GQA
    (3, 4, 1, 8, 4, 4, 16, [1, 7, 16]),      # MHA
    (2, 3, 2, 8, 8, 2, 8, [9, 13]),          # 3 kv heads
]


@pytest.mark.parametrize("b,kvh,g,hd,ps,pps,num_pages,lengths",
                         DECODE_CASES)
def test_paged_decode_torch_matches_xla_twin(b, kvh, g, hd, ps, pps,
                                             num_pages, lengths):
    q, kp, vp, bt, ln = _decode_case(0, b, kvh, g, hd, ps, pps, num_pages,
                                     lengths)
    scale = 1.0 / np.sqrt(hd)
    ref = jfa._paged_decode_xla(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(bt),
                                jnp.asarray(ln), scale)
    got = tfa._paged_decode_torch(_t(q), _t(kp), _t(vp), _t(bt), _t(ln),
                                  scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("b,kvh,g,hd,ps,pps,num_pages,lengths",
                         DECODE_CASES)
def test_paged_decode_torch_matches_pallas_interpret(b, kvh, g, hd, ps, pps,
                                                     num_pages, lengths):
    q, kp, vp, bt, ln = _decode_case(1, b, kvh, g, hd, ps, pps, num_pages,
                                     lengths)
    ref = jfa.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp),
                                     jnp.asarray(vp), jnp.asarray(bt),
                                     jnp.asarray(ln), interpret=True)
    got = tfa.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(ln))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_paged_decode_wrapper_routes_cpu_to_plain(monkeypatch):
    q, kp, vp, bt, ln = _decode_case(2, *DECODE_CASES[0])
    calls = []
    plain = tfa._paged_decode_torch

    def spy(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(tfa, "_paged_decode_torch", spy)
    before = dict(tfa.LAUNCHES)
    routes = {k: dict(v) for k, v in tfa.ROUTES.items()}
    got = tfa.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(ln))
    assert len(calls) == 1
    assert tfa.LAUNCHES == before            # no kernel launched
    assert tfa.ROUTES == routes
    ref = plain(_t(q), _t(kp), _t(vp), _t(bt), _t(ln), 1.0 / np.sqrt(16))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("bad", ["dtype", "bt_dtype", "shape", "pages",
                                 "lengths", "contiguous"])
def test_paged_decode_wrapper_rejects(bad):
    q, kp, vp, bt, ln = (_t(a) for a in _decode_case(3, *DECODE_CASES[0]))
    if bad == "dtype":
        q = q.double()
    elif bad == "bt_dtype":
        bt = bt.long()
    elif bad == "shape":
        q = q[0]
    elif bad == "pages":
        kp = kp[..., :8].contiguous()
    elif bad == "lengths":
        ln = ln[:1]
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(MXNetError):
        tfa.paged_decode_attention(q, kp, vp, bt, ln)


# ---------------------------------------------------------------------------
# paged flash prefill
# ---------------------------------------------------------------------------

def _prefill_case(seed, b, s, nh, kvh, hd, ps, num_pages, bt=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, nh, hd).astype(np.float32)
    kg = rng.randn(b, s, kvh, hd).astype(np.float32)
    vg = rng.randn(b, s, kvh, hd).astype(np.float32)
    kp = rng.randn(num_pages, ps, kvh, hd).astype(np.float32)
    vp = rng.randn(num_pages, ps, kvh, hd).astype(np.float32)
    if bt is None:
        n_pb = s // ps
        bt = np.arange(b * n_pb, dtype=np.int32).reshape(b, n_pb)
    return q, kg, vg, kp, vp, bt


PREFILL_CASES = [
    # b, s, nh, kvh, hd, ps (the JAX package's own parity cases)
    (2, 32, 4, 2, 16, 8),    # GQA, 4 pages/row
    (1, 16, 2, 2, 8, 16),    # MHA, single page/row
    (2, 24, 6, 3, 8, 8),     # 3 kv heads, non-pow2 bucket
]


def _run_prefill_both(args, jax_fn):
    q, kg, vg, kp, vp, bt = args
    jo, jkp, jvp = jax_fn(*(jnp.asarray(a) for a in args))
    tkp, tvp = _t(kp.copy()), _t(vp.copy())
    to, tkp2, tvp2 = tfa.flash_prefill_paged(_t(q), _t(kg), _t(vg), tkp,
                                             tvp, _t(bt))
    assert tkp2 is tkp and tvp2 is tvp       # the pool updates in place
    return (np.asarray(jo), np.asarray(jkp), np.asarray(jvp),
            to.numpy(), tkp.numpy(), tvp.numpy())


@pytest.mark.parametrize("b,s,nh,kvh,hd,ps", PREFILL_CASES)
def test_flash_prefill_torch_matches_xla_twin(b, s, nh, kvh, hd, ps):
    num_pages = 2 * b * (s // ps) + 3
    args = _prefill_case(1, b, s, nh, kvh, hd, ps, num_pages)
    jo, jkp, jvp, to, tkp, tvp = _run_prefill_both(args,
                                                   jfa._flash_prefill_xla)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_array_equal(tkp, jkp)  # pages are copied, bitwise
    np.testing.assert_array_equal(tvp, jvp)
    untouched = sorted(set(range(num_pages)) - set(args[5].ravel()))
    np.testing.assert_array_equal(tkp[untouched], args[3][untouched])


@pytest.mark.parametrize("b,s,nh,kvh,hd,ps", PREFILL_CASES)
def test_flash_prefill_torch_matches_pallas_interpret(b, s, nh, kvh, hd, ps):
    num_pages = 2 * b * (s // ps) + 3
    args = _prefill_case(2, b, s, nh, kvh, hd, ps, num_pages)
    jo, jkp, jvp, to, tkp, tvp = _run_prefill_both(
        args, lambda *a: jfa.flash_prefill_paged(*a, interpret=True))
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_array_equal(tkp, jkp)
    np.testing.assert_array_equal(tvp, jvp)


def test_flash_prefill_torch_null_page_rows():
    """Warmup rows map every page slot to the null page 0: the output
    and every other page agree; page 0's surviving write is left out."""
    b, s, nh, kvh, hd, ps = 1, 32, 4, 2, 16, 8
    args = _prefill_case(3, b, s, nh, kvh, hd, ps, 6,
                         bt=np.zeros((b, s // ps), np.int32))
    jo, jkp, jvp, to, tkp, tvp = _run_prefill_both(
        args, lambda *a: jfa.flash_prefill_paged(*a, interpret=True))
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_array_equal(tkp[1:], jkp[1:])
    np.testing.assert_array_equal(tvp[1:], args[4][1:])


def test_flash_prefill_wrapper_routes_cpu_to_plain(monkeypatch):
    args = _prefill_case(4, *PREFILL_CASES[0], num_pages=11)
    calls = []
    plain = tfa._flash_prefill_torch

    def spy(*a):
        calls.append(a)
        return plain(*a)

    monkeypatch.setattr(tfa, "_flash_prefill_torch", spy)
    before = dict(tfa.LAUNCHES)
    routes = {k: dict(v) for k, v in tfa.ROUTES.items()}
    q, kg, vg, kp, vp, bt = (_t(a) for a in args)
    o, _, _ = tfa.flash_prefill_paged(q, kg, vg, kp, vp, bt)
    assert len(calls) == 1
    assert tfa.LAUNCHES == before
    assert tfa.ROUTES == routes
    ro, _, _ = plain(q, kg, vg, _t(args[3]), _t(args[4]), bt)
    assert torch.equal(o, ro)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "bt_dtype",
                                 "heads", "pages", "contiguous", "bucket",
                                 "table"])
def test_flash_prefill_wrapper_rejects(bad):
    q, kg, vg, kp, vp, bt = (_t(a) for a in _prefill_case(
        5, *PREFILL_CASES[0], num_pages=11))
    if bad == "dtype":
        q, kg, vg, kp, vp = (t.double() for t in (q, kg, vg, kp, vp))
    elif bad == "mixed_dtype":
        kp = kp.to(torch.bfloat16)
    elif bad == "bt_dtype":
        bt = bt.long()
    elif bad == "heads":
        q = q[:, :, :3].contiguous()                 # 3 heads over 2 kv
    elif bad == "pages":
        vp = vp[:-1].contiguous()
    elif bad == "contiguous":
        kg = kg.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "bucket":
        q, kg, vg = q[:, :12], kg[:, :12], vg[:, :12]
        q, kg, vg = q.contiguous(), kg.contiguous(), vg.contiguous()
    else:
        bt = bt[:, :1].contiguous()
    with pytest.raises((MXNetError, ValueError)):
        tfa.flash_prefill_paged(q, kg, vg, kp, vp, bt)


# ---------------------------------------------------------------------------
# the serving kernels' routes and the decode split (pure Python; the
# kernels themselves run on the card only)
# ---------------------------------------------------------------------------

# the decode config's serving shapes: slot buckets 1-8, 4 kv heads x
# group 4, head_dim 64, 16-token pages, 16 pages a row (256 keys)
SERVE_PS, SERVE_PPS = 16, 16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_decode_split_covers_every_live_page_once(b, dtype):
    route, splits = tfa.decode_route(dtype, 64, SERVE_PPS)
    assert route == "cluster"
    assert 1 <= splits <= tfa.DECODE_CLUSTER
    # every length a row of the serving shape can hold, b rows at a time
    for start in range(0, SERVE_PS * SERVE_PPS + 1, b):
        for length in range(start, min(start + b, 257)):
            n_live = tfa.live_pages(length, SERVE_PS, SERVE_PPS)
            assert n_live == -(-length // SERVE_PS)
            ranges = tfa.decode_split_pages(n_live, splits)
            assert len(ranges) == splits     # one range a cluster rank
            covered = [p for p0, p1 in ranges for p in range(p0, p1)]
            assert covered == list(range(n_live))
            assert all(p1 - p0 <= -(-SERVE_PPS // splits)
                       for p0, p1 in ranges)


@pytest.mark.parametrize("dtype,vec", [(torch.bfloat16, 8),
                                       (torch.float32, 4)])
def test_decode_route_follows_the_head_dim_rule(dtype, vec):
    for hd in range(1, 300):
        route, splits = tfa.decode_route(dtype, hd, SERVE_PPS)
        want = hd <= 256 and hd % vec == 0
        assert route == ("cluster" if want else "serial"), hd
        assert (splits is not None) == want
        assert tfa.decode_route(dtype, hd, SERVE_PPS, False) == ("serial",
                                                                 None)
    for pps in (1, 3, 8, 9, 64):
        assert tfa.decode_route(dtype, 64, pps) == (
            "cluster", min(pps, tfa.DECODE_CLUSTER))


def test_prefill_route_follows_its_rule():
    bf16, f32 = torch.bfloat16, torch.float32
    for hd in (8, 16, 32, 48, 64, 96, 128, 256):
        want = "mma" if hd in tfa.PREFILL_HEAD_DIMS else "fma"
        assert tfa.prefill_route(bf16, hd, 16, 4) == want
        assert tfa.prefill_route(f32, hd, 16, 4) == "fma"
    assert tfa.prefill_route(bf16, 64, 16, 16) == "mma"       # group 1
    assert tfa.prefill_route(bf16, 64, 16, 1) == "mma"        # group 16
    assert tfa.prefill_route(bf16, 64, 32, 1) == "fma"        # group 32
    assert tfa.prefill_route(bf16, 64, 16, 4, False) == "fma"


def _decode_by_splits(q, kp, vp, bt, ln, scale, splits):
    """The cluster route's arithmetic in plain float32: each rank's (m,
    l, acc) over the keys of its own pages (m = -1e30, l = 0 where it has
    none), combined in rank order; l == 0 normalises by 1."""
    b, kvh, g, hd = q.shape
    num_pages, ps = kp.shape[:2]
    out = torch.zeros(b, kvh, g, hd)
    for r in range(b):
        length = max(int(ln[r]), 0)
        n_live = tfa.live_pages(length, ps, bt.shape[1])
        parts = []
        for p0, p1 in tfa.decode_split_pages(n_live, splits):
            m = torch.full((kvh, g), tfa.NEG_INF)
            l = torch.zeros(kvh, g)
            acc = torch.zeros(kvh, g, hd)
            n = min(p1 * ps, length) - p0 * ps
            if n > 0:
                pages = bt[r, p0:p1].long().clamp(0, num_pages - 1)
                k = kp[pages].reshape(-1, kvh, hd)[:n]
                v = vp[pages].reshape(-1, kvh, hd)[:n]
                sc = torch.einsum("kgd,nkd->kgn", q[r] * scale, k)
                m = sc.amax(-1)
                p = torch.exp(sc - m[..., None])
                l = p.sum(-1)
                acc = torch.einsum("kgn,nkd->kgd", p, v)
            parts.append((m, l, acc))
        m, l, acc = parts[0]
        for m2, l2, acc2 in parts[1:]:
            mn = torch.maximum(m, m2)
            a1, a2 = torch.exp(m - mn), torch.exp(m2 - mn)
            l = l * a1 + l2 * a2
            acc = acc * a1[..., None] + acc2 * a2[..., None]
            m = mn
        out[r] = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out


SPLIT_CASES = [
    # b, kvh, g, hd, ps, pps, num_pages, lengths: rows of length 0, one
    # key, a page edge, past it, the whole table; with 8 splits most
    # ranks of the short rows hold no live key
    (6, 2, 4, 16, 4, 8, 60, [0, 1, 4, 5, 17, 32]),
    (3, 3, 2, 8, 8, 3, 12, [9, 0, 24]),
]


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_decode_split_combine_matches_xla_twin(case, splits):
    b, kvh, g, hd, ps, pps, num_pages, lengths = SPLIT_CASES[case]
    q, kp, vp, bt, ln = _decode_case(7, b, kvh, g, hd, ps, pps, num_pages,
                                     lengths)
    scale = 1.0 / np.sqrt(hd)
    got = _decode_by_splits(_t(q), _t(kp), _t(vp), _t(bt), _t(ln), scale,
                            splits).numpy()
    ref = np.asarray(jfa._paged_decode_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ln), scale))
    live = ln > 0
    np.testing.assert_allclose(got[live], ref[live], rtol=1e-6, atol=1e-6)
    # a row of length 0: zeros, the TPU kernel's result (the XLA twin
    # averages V over the row's pages instead)
    kern = np.asarray(jfa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ln), interpret=True))
    assert not got[~live].any() and not kern[~live].any()
