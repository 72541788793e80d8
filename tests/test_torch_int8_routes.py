"""The host side of the int8 kernels' two routes, held on the CPU.

``int8_matmul`` and ``int8_conv_im2col`` each pick a route before the
launch, from shapes, memory formats and alignment alone:
``matmul_route`` and ``conv_route`` are pure functions, checked here at
every ResNet-50 convolution at batch 1, 16 and 32, at the FC with m from
1 to 32, and at the ragged, grouped and dilated cases the card is held
at; the wgmma route exactly where its preconditions (stated here again,
independently) hold, and a split-K grid of at least 128 CTAs at the FC.

Channels-last operands (the memory format of the wgmma conv route) give
the JAX package's results bitwise: through ``int8_conv_im2col`` (its
plain version on CPU tensors) against the JAX ``int8_conv_im2col``
(Pallas, interpreted) and ``_int8_conv_xla``, and through
``_contrib_quantized_conv_int8`` against the jitted JAX op. The
activation quantizer's channels-last output equals its contiguous one
and the JAX quantizer's, value for value. An int8 ``Predictor`` binds
the conv weights that the wgmma route takes in channels-last memory,
and the others as they were, and serves what the executor computes on
the artifact's contiguous weights, bitwise (the JAX Predictor's output
is held against the port's in test_torch_quantize.py).
"""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.models  # noqa: E402,F401
from mxnet_tpu.ops import registry as jreg  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402
from mxnet_tpu_torch.ops.cuda import int8_matmul as tk  # noqa: E402
from mxnet_tpu_torch.ops.quantization_ops import _quantize_act  # noqa: E402

jk = importlib.import_module("mxnet_tpu.ops.pallas.int8_matmul")
jq = importlib.import_module("mxnet_tpu.ops.quantization_ops")

CL = torch.channels_last


def _conv_layers(mx, batch, sym, image):
    """(data shape, weight shape, stride, dilate, pad, groups) of every
    Convolution of ``sym`` at ``batch``, from the port's shape
    inference."""
    from mxnet_tpu_torch.symbol.symbol import _topo
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=(batch,) + image)
    shapes = dict(zip(internals.list_outputs(), outs))
    args = dict(zip(sym.list_arguments(),
                    sym.infer_shape(data=(batch,) + image)[0]))
    layers = []
    for node in _topo(sym._entries):
        if node.op != "Convolution":
            continue
        src = node.inputs[0][0]
        a = node.attrs
        layers.append((
            tuple(shapes[src.name if src.is_var else src.name + "_output"]),
            tuple(args[node.inputs[1][0].name]),
            tuple(a.get("stride") or (1, 1)),
            tuple(a.get("dilate") or (1, 1)),
            tuple(a.get("pad") or (0, 0)), int(a.get("num_group", 1))))
    return layers


def _resnet50_convs(batch):
    sym = tmx.models.resnet(num_classes=1000, num_layers=50,
                            image_shape=(3, 224, 224))
    return _conv_layers(tmx, batch, sym, (3, 224, 224))


def _wgmma_preconditions(wshape, stride, dilate, pad, groups):
    """The wgmma conv route's preconditions, written out: channel chunks
    of 32 within a group, and the im2col map's limits (traversal stride
    1..8, window corners -pad and pad - (k - 1) * dilate in [-128,
    127])."""
    cout, cin_g, kh, kw = wshape
    if cin_g % 32:
        return False
    return all(1 <= s <= 8 and -128 <= -p and p - (k - 1) * d <= 127
               and p - (k - 1) * d >= -128
               for k, s, d, p in zip((kh, kw), stride, dilate, pad))


# phase 15's extra cases: groups 2 and 32, dilated, odd tails, a 1 x 1
# input, 8 and 200 output channels
CARD_CASES = [
    ((2, 64, 14, 14), (64, 32, 3, 3), (1, 1), (1, 1), (1, 1), 2),
    ((2, 64, 10, 10), (64, 2, 3, 3), (1, 1), (1, 1), (1, 1), 32),
    ((2, 64, 15, 13), (32, 64, 3, 3), (1, 1), (2, 2), (2, 2), 1),
    ((3, 24, 17, 23), (40, 24, 5, 3), (2, 3), (1, 1), (2, 1), 1),
    ((3, 96, 17, 23), (40, 96, 5, 3), (2, 3), (1, 1), (2, 1), 1),
    ((1, 32, 1, 1), (16, 32, 3, 3), (1, 1), (1, 1), (1, 1), 1),
    ((2, 64, 3, 2), (8, 64, 1, 1), (1, 1), (1, 1), (0, 0), 1),
    ((3, 128, 5, 5), (200, 128, 3, 3), (2, 2), (1, 1), (1, 1), 1),
]


@pytest.mark.parametrize("batch", [1, 16, 32])
def test_resnet50_convs_take_wgmma_but_the_stem(batch):
    layers = _resnet50_convs(batch)
    assert len(layers) == 53
    routes = []
    for q, w, st, dl, pd, g in layers:
        route = tk.conv_route(q, w, st, dl, pd, g)
        assert (route[0] == "wgmma") == _wgmma_preconditions(w, st, dl, pd,
                                                             g)
        routes.append(route[0])
        if route[0] == "wgmma":
            assert route[1] == (64 if w[1] % 64 == 0 else 32)
            assert route[2] in (64, 128)
            assert route[2] == 64 or w[0] // g > 64
        # a contiguous input or a misaligned operand: the mma.sync route
        assert tk.conv_route(q, w, st, dl, pd, g,
                             channels_last=False)[0] == "mma_sync"
        assert tk.conv_route(q, w, st, dl, pd, g,
                             aligned=False)[0] == "mma_sync"
    assert routes[0] == "mma_sync" and layers[0][1][1] == 3    # the stem
    assert routes.count("wgmma") == 52


@pytest.mark.parametrize("case", CARD_CASES,
                         ids=lambda c: "x".join(map(str, c[1])) + "g%d"
                         % c[5])
def test_card_cases_route_where_preconditions_hold(case):
    q, w, st, dl, pd, g = case
    route = tk.conv_route(q, w, st, dl, pd, g)
    assert (route[0] == "wgmma") == _wgmma_preconditions(w, st, dl, pd, g)
    assert route[0] == ("mma_sync" if w[1] in (2, 24) else "wgmma")


@pytest.mark.parametrize("m", range(1, 33))
def test_fc_takes_split_k_wgmma_with_a_full_grid(m):
    route, bn, splits = tk.matmul_route(m, 1000, 2048)
    assert route == "wgmma"
    assert bn >= m and bn == min(b for b in (8, 16, 32) if b >= m)
    ctas = -(-1000 // tk.WG_ROWS) * -(-m // bn) * splits
    assert ctas >= 128
    assert splits & (splits - 1) == 0          # a power of two
    assert 2048 // tk.WG_BK % splits == 0      # whole 128-byte chunks
    assert tk.matmul_route(m, 1000, 2048, aligned=False)[0] == "mma_sync"


@pytest.mark.parametrize("m,k,n,route", [
    (1, 8, 4, "mma_sync"), (5, 37, 11, "mma_sync"), (33, 147, 130,
                                                     "mma_sync"),
    (16, 256, 64, "wgmma"), (200, 512, 130, "wgmma"),
    (4096, 2048, 1000, "wgmma")])
def test_matmul_route_of_ragged_and_large_shapes(m, k, n, route):
    got = tk.matmul_route(m, n, k)
    assert got[0] == route
    if route == "wgmma":
        bn, splits = got[1:]
        assert bn == (128 if m > 64 else min(b for b in (8, 16, 32, 64)
                                              if b >= m))
        chunks = -(-k // tk.WG_BK)
        assert 1 <= splits <= chunks
        tiles = -(-n // tk.WG_ROWS) * -(-m // bn)
        # split only while the grid is short of MIN_CTAS
        assert splits == 1 or tiles * splits // 2 < tk.MIN_CTAS
        assert tk.matmul_workspace_ints(m, n, bn) == tiles * (64 * bn + 1)


# ---------------------------------------------------------------------------
# channels-last operands against the JAX package
# ---------------------------------------------------------------------------

def _i8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("case", [
    ((2, 64, 9, 7), (48, 64, 3, 3), (1, 1), (1, 1), (1, 1), 1),
    ((1, 64, 8, 8), (32, 32, 1, 1), (2, 2), (1, 1), (0, 0), 2),
    ((2, 32, 11, 9), (16, 32, 3, 3), (2, 1), (2, 2), (2, 1), 1)],
    ids=["3x3", "1x1s2g2", "dilated"])
def test_channels_last_conv_equals_jax_bitwise(case):
    (b, c, h, w), wshape, st, dl, pd, g = case
    rng = np.random.RandomState(c + h)
    q, wq = _i8(rng, b, c, h, w), _i8(rng, *wshape)
    s = (rng.rand(wshape[0]).astype(np.float32) * 0.1 + 1e-3)
    tq = torch.from_numpy(q).contiguous(memory_format=CL)
    tw = torch.from_numpy(wq).contiguous(memory_format=CL)
    assert tq.is_contiguous(memory_format=CL) and not tq.is_contiguous()
    got = tk.int8_conv_im2col(tq, tw, torch.from_numpy(s), st, dl, pd, g)
    assert got.is_contiguous()
    args = (jnp.asarray(q), jnp.asarray(wq), jnp.asarray(s), st, dl, pd, g)
    for want in (jk._int8_conv_xla(*args),
                 jk.int8_conv_im2col(*args, interpret=True)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        assert got.numpy().tobytes() == want.tobytes()
    assert tk.LAUNCHES["int8_conv_im2col"] == 0


@pytest.mark.parametrize("bias", [False, True])
def test_quantized_conv_int8_with_channels_last_weights_equals_jax(bias):
    rng = np.random.RandomState(7)
    data = rng.randn(2, 64, 6, 5).astype(np.float32) * 2
    weight = _i8(rng, 32, 64, 3, 3)
    scale = (rng.rand(32).astype(np.float32) * 0.01 + 1e-4)
    attrs = {"kernel": (3, 3), "stride": (1, 1), "pad": (1, 1),
             "num_filter": 32, "act_scale": 37.25, "no_bias": not bias}
    arrays = [data, weight, scale]
    if bias:
        arrays.append(rng.randn(32).astype(np.float32))
    fn = jreg.get_op("_contrib_quantized_conv_int8").fn
    want = np.asarray(jax.jit(lambda *a: fn(*a, **attrs))(
        *map(jnp.asarray, arrays)))
    ins = [torch.from_numpy(a) for a in arrays]
    ins[1] = ins[1].contiguous(memory_format=CL)
    got = treg.get_op("_contrib_quantized_conv_int8").fn(*ins, **attrs)
    got = got.numpy()
    if not bias:
        assert got.tobytes() == want.tobytes()
    else:
        # XLA on the CPU may fuse the rescale and the bias add; the port
        # rounds the product first (as the op reads)
        prod = treg.get_op("_contrib_quantized_conv_int8").fn(
            *ins[:3], **dict(attrs, no_bias=True)).numpy()
        assert (np.abs(got - want) <= np.spacing(np.abs(prod))
                + np.spacing(np.abs(want))).all()


@pytest.mark.parametrize("act_scale", [1.0, 12.3456789, 127.0 / 3.7e-3])
def test_channels_last_quantizer_equals_contiguous_and_jax(act_scale):
    rng = np.random.RandomState(3)
    x = np.concatenate([rng.randn(2, 40, 7, 6).astype(np.float32) * 4,
                        np.full((1, 40, 7, 6), 0.5 / act_scale,
                                np.float32)])
    x[0, 0, 0, :4] = [np.inf, -np.inf, 1e30, -1e30]
    t = torch.from_numpy(x)
    cl = _quantize_act(t, act_scale, CL)
    flat = _quantize_act(t, act_scale)
    assert cl.dtype == flat.dtype == torch.int8
    assert cl.is_contiguous(memory_format=CL) and not cl.is_contiguous()
    assert flat.is_contiguous()
    assert torch.equal(cl, flat)
    want = np.asarray(jq._quantize_act(jnp.asarray(x), act_scale))
    assert want.dtype == np.int8
    assert cl.contiguous().numpy().tobytes() == want.tobytes()


def test_quantized_conv_op_writes_its_activations_channels_last(
        monkeypatch):
    """The op quantizes into channels-last memory exactly where the
    wgmma route takes the shape, and hands the kernel's wrapper the
    weights in the memory format they came in."""
    seen = []
    real = tk.int8_conv_im2col
    monkeypatch.setattr(tk, "int8_conv_im2col", lambda q, wq, *a: seen.append(
        (q.is_contiguous(memory_format=CL), wq.is_contiguous(
            memory_format=CL))) or real(q, wq, *a))
    op = treg.get_op("_contrib_quantized_conv_int8").fn
    rng = np.random.RandomState(1)
    for cin, fmt in ((64, CL), (3, torch.contiguous_format)):
        data = torch.from_numpy(rng.randn(1, cin, 5, 5).astype(np.float32))
        w = torch.from_numpy(_i8(rng, 8, cin, 3, 3)).contiguous(
            memory_format=fmt)
        op(data, w, torch.ones(8), kernel=(3, 3), pad=(1, 1), num_filter=8,
           act_scale=10.0, no_bias=True)
    assert seen == [(True, True), (False, False)]


# ---------------------------------------------------------------------------
# the Predictor binds the wgmma route's weights channels-last
# ---------------------------------------------------------------------------

SHAPE = (3, 16, 16)


def _ohwi_strides(shape):
    """Strides of a (cout, cin, kh, kw) tensor in channels-last memory
    (a 1x1 weight's memory is the same in both formats, and PyTorch then
    keeps the contiguous strides)."""
    co, ci, kh, kw = shape
    if kh * kw == 1:
        return _oihw_strides(shape)
    return (ci * kh * kw, 1, kw * ci, ci)


def _oihw_strides(shape):
    co, ci, kh, kw = shape
    return (ci * kh * kw, kh * kw, kw, 1)


def _net(mx):
    """A 3-channel stem (the mma.sync route), a 3x3 and a strided 1x1
    conv of 32 and 64 channels (the wgmma route), pooling and an FC."""
    x = mx.sym.Variable("data")
    for name, nf, k, st, pd in (("stem", 32, 3, 1, 1), ("c3", 64, 3, 1, 1),
                                ("c1", 64, 1, 2, 0)):
        x = mx.sym.Convolution(x, num_filter=nf, kernel=(k, k),
                               stride=(st, st), pad=(pd, pd), name=name)
        x = mx.sym.Activation(x, act_type="relu", name=name + "_relu")
    x = mx.sym.Pooling(x, global_pool=True, kernel=(1, 1), pool_type="avg",
                       name="pool")
    x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=10, name="fc")
    return mx.sym.SoftmaxOutput(x, name="softmax")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The port's int8 artifact of ``_net`` with seeded Xavier weights,
    calibrated on 8 images."""
    prefix = str(tmp_path_factory.mktemp("routes") / "net")
    sym = _net(tmx)
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (4,) + SHAPE)],
             label_shapes=[("softmax_label", (4,))], for_training=False)
    tmx.random.seed(0)
    mod.init_params(tmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg, aux = mod.get_params()
    tmx.model.save_checkpoint(prefix, 0, sym, arg, aux)
    x = np.random.RandomState(5).uniform(-1, 1, (8,) + SHAPE).astype(
        np.float32)
    qp = tmx.quantize.quantize_checkpoint(prefix, [x], calib_mode="naive",
                                          ctx=tmx.cpu())
    return qp, x


def test_predictor_binds_wgmma_conv_weights_channels_last(artifact):
    from mxnet_tpu_torch.symbol.symbol import _topo
    qp, x = artifact
    pred = tmx.serving.Predictor(qp.symbol_json, qp.param_bytes(),
                                 dev_type=1,
                                 input_shapes={"data": (4,) + SHAPE})
    formats = {}
    for node in _topo(qp.symbol._entries):
        if node.op != "_contrib_quantized_conv_int8":
            continue
        name = node.inputs[1][0].name
        t = pred._exe.arg_dict[name]._data
        a = node.attrs
        ok = tk.conv_wgmma_shape_ok(tuple(t.shape), a.get("stride") or (1, 1),
                                    a.get("dilate") or (1, 1),
                                    a.get("pad") or (0, 0),
                                    a.get("num_group", 1))
        assert ok == _wgmma_preconditions(
            tuple(t.shape), a.get("stride") or (1, 1),
            a.get("dilate") or (1, 1), a.get("pad") or (0, 0),
            a.get("num_group", 1))
        assert t.stride() == (_ohwi_strides(t.shape) if ok
                              else _oihw_strides(t.shape))
        formats[name] = ok
    assert formats == {"stem_weight_q": False, "c3_weight_q": True,
                       "c1_weight_q": True}
    # a bucket of the same predictor shares them, still channels-last
    other = pred.reshape({"data": (2,) + SHAPE})
    for name, ok in formats.items():
        t = other._exe.arg_dict[name]._data
        assert t.stride() == (_ohwi_strides(t.shape) if ok
                              else _oihw_strides(t.shape))
    # served output: what the executor computes on contiguous weights
    pred.set_input("data", x[:4].tobytes())
    pred.forward()
    got = np.frombuffer(pred.get_output(0), np.float32)
    exe = qp.symbol.simple_bind(ctx=tmx.cpu(), grad_req="null", type_dict={
        k: v.dtype for k, v in qp.arg_params.items()}, data=(4,) + SHAPE)
    exe.copy_params_from(qp.arg_params, qp.aux_params,
                         allow_extra_params=True)
    want = exe.forward(is_train=False, data=x[:4])[0].asnumpy()
    assert got.tobytes() == want.astype(np.float32).tobytes()
