"""The port's image pipeline (``mxnet_tpu_torch.image``) against the JAX
package's ``image.py``.

* Every augmenter and ``CreateAugmenter`` chain gives the JAX package's
  bits when the port's generators are seeded as the JAX package's global
  ones (``random.Random(s)`` for ``random.seed(s)``, a ``RandomState``
  for ``np.random.seed``); so do ``imdecode`` and the crop and resize
  functions.
* ``NativeImageDecoder`` on its ``opencv`` backend is bitwise equal to the JAX package's for the same
  (seed, stream position) and any thread count; a corrupt buffer
  raises.
* The ``nvjpeg`` backend's host half: its resize / crop / mirror plan
  (``imgdec_plan``) and the plain version of its kernel,
  ``_crop_mirror_normalize_plain`` (the ``crop_mirror_normalize``
  kernel's), applied to the python route's decode, equal the JAX
  package's native decoder bitwise, with and without ``resize`` and for
  images smaller than the crop; so does its cubic resize of RGB images
  (PNG inputs, which decode exactly).
* ``ImageIter`` picks its route before the first batch and counts it;
  a backend that is missing raises.

The card's half (the nvJPEG decode, the kernel) is in
``tests/test_torch_cuda.py``.
"""
import random

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

import mxnet_tpu.image as jimg  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import image as timg  # noqa: E402
from mxnet_tpu_torch.ops.cuda import image_decode as idec  # noqa: E402

MEAN = np.array([123.68, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


def _jpegs(n, hw=96, seed=0, quality=95):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        im = rng.randint(0, 255, (hw + i, hw + 8 - i, 3), dtype=np.uint8)
        ok, b = cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ok
        out.append(b.tobytes())
    return out


def _image(seed=0, shape=(70, 90, 3)):
    return np.random.RandomState(seed).randint(0, 255, shape,
                                               dtype=np.uint8)


def _run_jax(augs, img, seed):
    random.seed(seed)
    np.random.seed(seed)
    for a in augs:
        img = a(img)
    return np.asarray(jimg._to_np(img))


def _run_port(augs, img):
    for a in augs:
        img = a(img)
    return np.asarray(timg._to_np(img))


AUGS = {
    "resize": lambda m, r, n: [m.ResizeAug(50)],
    "force_resize": lambda m, r, n: [m.ForceResizeAug((40, 30))],
    "random_crop": lambda m, r, n: [m.RandomCropAug((48, 40), **r)],
    "center_crop": lambda m, r, n: [m.CenterCropAug((48, 40))],
    "random_sized_crop": lambda m, r, n: [m.RandomSizedCropAug(
        (48, 40), (0.08, 1.0), (3. / 4., 4. / 3.), **r)],
    "flip": lambda m, r, n: [m.HorizontalFlipAug(0.5, **r)] * 3,
    "cast": lambda m, r, n: [m.CastAug()],
    "normalize": lambda m, r, n: [m.CastAug(), m.ColorNormalizeAug(
        MEAN, STD)],
    "brightness": lambda m, r, n: [m.CastAug(), m.BrightnessJitterAug(
        0.4, **r)],
    "contrast": lambda m, r, n: [m.CastAug(), m.ContrastJitterAug(
        0.4, **r)],
    "saturation": lambda m, r, n: [m.CastAug(), m.SaturationJitterAug(
        0.4, **r)],
    "lighting": lambda m, r, n: [m.CastAug(), m.LightingAug(
        0.1, np.array([55.46, 4.794, 1.148]),
        np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]]), **n)],
    "color_jitter": lambda m, r, n: [m.CastAug(), m.ColorJitterAug(
        0.4, 0.4, 0.4, **r)],
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmenter_matches_jax_bitwise(name):
    img = _image(3)
    for seed in (0, 7, 11):
        want = _run_jax(AUGS[name](jimg, {}, {}), img, seed)
        got = _run_port(AUGS[name](timg, {"rng": random.Random(seed)},
                                   {"np_rng": np.random.RandomState(seed)}),
                        img)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


CHAINS = [
    dict(),
    dict(resize=80, rand_crop=True, rand_mirror=True, mean=True, std=True),
    dict(rand_crop=True, rand_resize=True, rand_mirror=True,
         brightness=0.4, contrast=0.4, saturation=0.4, pca_noise=0.1,
         mean=MEAN, std=STD),
    dict(resize=64, rand_crop=True, inter_method=1, mean=True),
]


@pytest.mark.parametrize("kw", CHAINS, ids=range(len(CHAINS)))
def test_create_augmenter_chain_matches_jax_bitwise(kw):
    shape = (3, 48, 56)
    imgs = [_image(s, (60 + s, 75 - s, 3)) for s in range(4)]
    random.seed(5)
    np.random.seed(5)
    jaugs = jimg.CreateAugmenter(shape, **kw)
    taugs = timg.CreateAugmenter(shape, rng=random.Random(5),
                                 np_rng=np.random.RandomState(5), **kw)
    assert [type(a).__name__ for a in taugs] == \
        [type(a).__name__ for a in jaugs]
    for img in imgs:        # one generator across images, as a stream
        want, got = img, img
        for a in jaugs:
            want = a(want)
        for a in taugs:
            got = a(got)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_functions_match_jax():
    buf = _jpegs(1)[0]
    t = timg.imdecode(buf)
    j = jimg.imdecode(buf)
    assert t.context.type == "cpu" and t.dtype == np.uint8
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(timg.imdecode(buf, 0, to_ndarray=False),
                                  jimg.imdecode(buf, 0, to_ndarray=False))
    img = _image(1)
    for f, args in (("resize_short", (40,)), ("imresize", (30, 20, 2)),
                    ("center_crop", ((50, 40),)),
                    ("fixed_crop", (3, 4, 20, 30, (16, 16)))):
        got = getattr(timg, f)(img, *args)
        want = getattr(jimg, f)(img, *args)
        if isinstance(want, tuple):
            assert got[1] == want[1]
            got, want = got[0], want[0]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    random.seed(2)
    want = jimg.random_crop(img, (30, 30))
    got = timg.random_crop(img, (30, 30), rng=random.Random(2))
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    random.seed(4)
    want = jimg.random_size_crop(img, (30, 30), 0.3, (0.75, 1.33))
    got = timg.random_size_crop(img, (30, 30), 0.3, (0.75, 1.33),
                                rng=random.Random(4))
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(
        timg.color_normalize(img, MEAN, STD),
        jimg.color_normalize(img, MEAN, STD))
    with pytest.raises(tmx.MXNetError, match="decode"):
        timg.imdecode(b"not an image")


def test_backends_in_order_and_missing_ones_raise():
    from mxnet_tpu_torch import _native
    want = (["opencv"] if _native.opencv_include() else []) + (
        ["nvjpeg"] if idec.nvjpeg_available() else [])
    assert timg.decoder_backends() == want
    with pytest.raises(tmx.MXNetError, match="unknown decoder backend"):
        timg.NativeImageDecoder((3, 32, 32), backend="libjpeg")
    if "nvjpeg" not in timg.decoder_backends():
        with pytest.raises(tmx.MXNetError, match="not on this machine"):
            timg.NativeImageDecoder((3, 32, 32), backend="nvjpeg")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(rand_crop=True, rand_mirror=True),
    dict(resize=112, rand_crop=True, rand_mirror=True, mean=MEAN, std=STD),
    dict(resize=100, mean=True, std=True),
], ids=range(4))
def test_native_decoder_matches_jax_any_threads(kw):
    bufs = _jpegs(12, hw=128)
    want = jimg.NativeImageDecoder((3, 96, 96), num_threads=2, seed=5,
                                   **kw).decode_batch(bufs, base=40)
    for threads in (1, 3, 8):
        dec = timg.NativeImageDecoder((3, 96, 96), num_threads=threads,
                                      seed=5, **kw)
        assert dec.backend == "opencv"
        np.testing.assert_array_equal(dec.decode_batch(bufs, base=40), want)
        if kw.get("rand_crop"):
            assert not np.array_equal(dec.decode_batch(bufs, base=41), want)
        dec.close()


def test_native_decoder_grayscale_and_corrupt_buffer():
    bufs = _jpegs(3)
    got = timg.NativeImageDecoder((1, 64, 64), mean=[100.0],
                                  std=[50.0]).decode_batch(bufs)
    want = jimg.NativeImageDecoder((1, 64, 64), mean=[100.0],
                                   std=[50.0]).decode_batch(bufs)
    np.testing.assert_array_equal(got, want)
    dec = timg.NativeImageDecoder((3, 32, 32))
    with pytest.raises(tmx.MXNetError, match="decode"):
        dec.decode_batch([bufs[0], b"\xff\xd8 not a real jpeg"])
    dec.decode_batch(bufs)          # the pool survives a failed batch
    with pytest.raises(tmx.MXNetError, match="1 or 3 channels"):
        timg.NativeImageDecoder((2, 32, 32))


def _gray_jpegs(n, hw=80, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        im = rng.randint(0, 255, (hw + i, hw + 6 - i), dtype=np.uint8)
        out.append(cv2.imencode(".jpg", im)[1].tobytes())
    return out


def _y_items(bufs, dec, base, kind):
    """The Y planes of ``bufs`` (what libjpeg's grayscale decode gives:
    component 0, unconverted) as one flat tensor and their items."""
    planes = [timg.imdecode(b, 0, to_ndarray=False)[..., 0] for b in bufs]
    hw = np.array([p.shape for p in planes], np.int32)
    sizes = hw[:, 0].astype(np.int64) * hw[:, 1]
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    plan = dec.plan(hw, base=base)
    items = np.concatenate([offs[:, None], hw, plan[:, :3],
                            np.full((len(bufs), 1), kind),
                            np.zeros((len(bufs), 2)), plan[:, 3:]],
                           1).astype(np.int64)
    src = torch.from_numpy(np.concatenate([p.ravel() for p in planes]))
    return src, torch.from_numpy(items)


@pytest.fixture
def one_thread():
    """The plain resizes' tensors are small: torch's intra-op threads
    only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_jpegs(n, gray, seed=3):
    """JPEGs of 40-120 px a side, most smaller than a 64 x 72 crop."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        h, w = rng.randint(40, 121, 2)
        im = rng.randint(0, 255, (h, w) if gray else (h, w, 3),
                         dtype=np.uint8)
        out.append(cv2.imencode(".jpg", im)[1].tobytes())
    return out


@pytest.mark.parametrize("kw,small", [
    (dict(), False), (dict(rand_crop=True), False),
    (dict(rand_crop=True, rand_mirror=True), False),
    (dict(rand_mirror=True, mean=MEAN, std=STD), False),
    (dict(resize=160, rand_crop=True, rand_mirror=True), False),
    (dict(resize=256, mean=MEAN, std=STD), False),
    (dict(rand_crop=True, rand_mirror=True), True),
    (dict(resize=56, rand_crop=True, rand_mirror=True), True),
], ids=range(8))
def test_nvjpeg_plan_and_plain_kernel_match_jax_decoder(kw, small,
                                                        one_thread):
    """The nvjpeg backend's host plan and the plain version of its
    kernel (crop_mirror_normalize's _crop_mirror_normalize_plain), fed
    the Y planes libjpeg decodes, equal the JAX package's native decoder
    bitwise: one output channel from colour JPEGs, and three from
    grayscale JPEGs (R = G = B = Y); with the short side resized up
    (160, 256) or below the crop (56), and for images smaller than the
    crop, which are resized to it."""
    for channels, kind in ((1, "420"), (3, "gray")):
        if small:
            bufs = _small_jpegs(6, gray=channels == 3)
        else:
            # the resize cases take 6 images: the plain resize is slow
            n = 6 if "resize" in kw else 8
            bufs = _jpegs(n, hw=80) if channels == 1 else _gray_jpegs(n)
        shape = (channels, 64, 72)
        m = dict(kw)
        if channels == 1 and "mean" in m:
            m["mean"], m["std"] = MEAN[:1], STD[:1]
        want = jimg.NativeImageDecoder(shape, seed=9, num_threads=2,
                                       **m).decode_batch(bufs, base=3)
        dec = timg.NativeImageDecoder(shape, seed=9, **m)
        src, items = _y_items(bufs, dec, 3, idec.KINDS[kind])
        if small:
            assert (items[:, 11:] < torch.tensor([64, 72])).any()
        for fn in (idec.crop_mirror_normalize,
                   idec._crop_mirror_normalize_plain):
            got = fn(src, items, shape, dec._mean, dec._std)
            np.testing.assert_array_equal(got.numpy(), want)
    assert idec.LAUNCHES["crop_mirror_normalize"] == 0      # CPU: plain


@pytest.mark.parametrize("resize", [0, 160, 256, 48])
def test_plain_resize_matches_jax_decoder_on_rgb(resize, one_thread):
    """_resize_cubic_plain on RGB images (through _augment_plain: resize,
    crop, the crop's resize, mirror) equals the JAX package's native
    decoder on the same images as PNGs (whose decode is exact), OpenCV's
    INTER_CUBIC bit for bit, crops larger than the image included."""
    rng = np.random.RandomState(resize)
    imgs, bufs = [], []
    for _ in range(5):
        h, w = rng.randint(30, 140, 2)
        im = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        imgs.append(im)
        bufs.append(cv2.imencode(".png", im[..., ::-1])[1].tobytes())
    shape = (3, 56, 64)
    kw = dict(resize=resize, rand_crop=True, rand_mirror=True, mean=MEAN,
              std=STD)
    want = jimg.NativeImageDecoder(shape, seed=4, num_threads=2,
                                   **kw).decode_batch(bufs, base=11)
    dec = timg.NativeImageDecoder(shape, seed=4, **kw)
    plan = dec.plan(np.array([im.shape[:2] for im in imgs]), base=11)
    for im, row, w in zip(imgs, plan.tolist(), want):
        item = [0, 0, 0] + row[:3] + [0, 0, 0] + row[3:]
        crop = idec._augment_plain(torch.from_numpy(im), item, 56, 64)
        got = (crop.permute(2, 0, 1).float() - torch.from_numpy(MEAN)[
            :, None, None]) / torch.from_numpy(STD)[:, None, None]
        np.testing.assert_array_equal(got.numpy(), w)


def _libjpeg_upsample(c, kind, h, w):
    """libjpeg-turbo's jdsample.c loops, transliterated: h2v1 / h2v2
    "fancy" upsampling with its special first and last columns, h1v2
    fancy upsampling, the rows above and below replicated at the edges
    (jdmainct.c); box replication where an h2 plane is at most 2
    samples wide, and int_upsample (4:1:1, 4:1:0)."""
    c = c.astype(np.int64)
    ch, cw = c.shape
    if kind == "444":
        return c
    if kind in ("411", "410"):
        # int_upsample: each sample h_expand x v_expand times
        v_expand = 2 if kind == "410" else 1
        rows = []
        for r in range(ch):
            out = []
            for k in range(cw):
                out += [c[r, k]] * 4
            rows += [out] * v_expand
        return np.array(rows, dtype=np.int64)[:h, :w]
    rows = []
    for r in range(h if kind == "422" else 2 * ch):
        if kind == "422":
            src = c[r]
            scale, lo, hi = 1, None, None
        else:
            near = c[r >> 1]
            far = c[min(max((r >> 1) + (1 if r & 1 else -1), 0), ch - 1)]
            src = near * 3 + far
        out = []
        if kind == "440":
            # h1v2_fancy_upsample: v = 0 takes the row above (bias 1),
            # v = 1 the row below (bias 2)
            out = [(src[k] + (2 if r & 1 else 1)) >> 2 for k in range(cw)]
        elif cw <= 2:
            base = c[r] if kind == "422" else c[r >> 1]
            out = [base[k >> 1] for k in range(2 * cw)]
        elif kind == "422":
            out += [src[0], (src[0] * 3 + src[1] + 2) >> 2]
            for k in range(1, cw - 1):
                out += [(src[k] * 3 + src[k - 1] + 1) >> 2,
                        (src[k] * 3 + src[k + 1] + 2) >> 2]
            out += [(src[-1] * 3 + src[-2] + 1) >> 2, src[-1]]
        else:
            out += [(src[0] * 4 + 8) >> 4, (src[0] * 3 + src[1] + 7) >> 4]
            for k in range(1, cw - 1):
                out += [(src[k] * 3 + src[k - 1] + 8) >> 4,
                        (src[k] * 3 + src[k + 1] + 7) >> 4]
            out += [(src[-1] * 3 + src[-2] + 8) >> 4, (src[-1] * 4 + 7) >> 4]
        rows.append(out)
    return np.array(rows, dtype=np.int64)[:h, :w]


def _libjpeg_rgb(y, cb, cr):
    """jdcolor.c: build_ycc_rgb_table and ycc_rgb_convert."""
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    x = np.arange(256) - 128
    cr_r = (fix(1.40200) * x + 32768) >> 16
    cb_b = (fix(1.77200) * x + 32768) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + 32768
    y = y.astype(np.int64)
    return np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                     y + cb_b[cb]], -1).clip(0, 255)


@pytest.mark.parametrize("kind", ["444", "422", "420", "440", "411", "410"])
@pytest.mark.parametrize("h,w", [(7, 9), (8, 8), (13, 4), (5, 3), (2, 2)])
def test_plain_kernel_converts_planes_as_libjpeg(kind, h, w):
    """_crop_mirror_normalize_plain (the crop_mirror_normalize kernel's
    plain version) turns random planes into libjpeg-turbo's RGB, held
    against a transliteration of its C loops, odd sizes and planes of 1
    and 2 samples included; then crops, mirrors and normalises."""
    rng = np.random.RandomState(h * 31 + w)
    hs, vs = idec._SUBSAMPLING[idec.KINDS[kind]]
    ch, cw = -(-h // vs), -(-w // hs)
    y = rng.randint(0, 256, (h, w)).astype(np.uint8)
    cb = rng.randint(0, 256, (ch, cw)).astype(np.uint8)
    cr = rng.randint(0, 256, (ch, cw)).astype(np.uint8)
    rgb = _libjpeg_rgb(y, _libjpeg_upsample(cb, kind, h, w),
                       _libjpeg_upsample(cr, kind, h, w))
    src = torch.from_numpy(np.concatenate([[7, 7, 7], y.ravel(), cb.ravel(),
                                           cr.ravel()]).astype(np.uint8))
    oh, ow = max(1, h - 1), max(1, w - 2)
    for x0, y0, mirror in ((0, 0, 0), (w - ow, h - oh, 1)):
        items = torch.tensor([[3, h, w, x0, y0, mirror, idec.KINDS[kind],
                               ch, cw, h, w, oh, ow]])
        got = idec._crop_mirror_normalize_plain(src, items, (3, oh, ow),
                                                MEAN, STD)
        crop = rgb[y0:y0 + oh, x0:x0 + ow]
        if mirror:
            crop = crop[:, ::-1]
        want = (crop.transpose(2, 0, 1).astype(np.float32)
                - MEAN[:, None, None]) / STD[:, None, None]
        np.testing.assert_array_equal(got.numpy()[0], want)


def test_plane_layout_and_nvjpeg_plan_refusals():
    info = np.array([[10, 12, 3, 2, 5, 6], [10, 12, 1, 6, 0, 0],
                     [10, 12, 3, 0, 10, 12], [10, 12, 3, 1, 10, 6],
                     [10, 12, 3, 3, 5, 12], [10, 12, 3, 4, 10, 3],
                     [10, 12, 3, 5, 5, 3]], np.int32)
    kinds, nbytes = idec.plane_layout(info, 3)
    assert kinds.tolist() == [3, 0, 1, 2, 4, 5, 6]
    assert nbytes.tolist() == [120 + 60, 120, 120 + 240, 120 + 120,
                               120 + 120, 120 + 60, 120 + 30]
    assert idec.plane_layout(info, 1)[1].tolist() == [120] * 7
    with pytest.raises(tmx.MXNetError, match="4:1:0 vertical|A8.1b"):
        idec.plane_layout(np.array([[10, 12, 3, 7, 5, 6]], np.int32), 3)
    with pytest.raises(tmx.MXNetError, match="A8.1b"):
        idec.plane_layout(np.array([[10, 12, 4, 0, 10, 12]], np.int32), 3)


def test_nvjpeg_plan_refuses_resize_and_kernel_checks():
    with pytest.raises(tmx.MXNetError, match="CMYK.*A8.1b"):
        idec.plane_layout(np.array([[100, 100, 3, 7, 50, 50],
                                    [100, 100, 4, 0, 100, 100]], np.int32), 3)
    src = torch.zeros(100 * 100 * 2, dtype=torch.uint8)
    items = torch.tensor([[0, 100, 100, 0, 0, 0, 3, 50, 50, 100, 100, 8, 8]])
    with pytest.raises(tmx.MXNetError, match="channels"):
        idec.crop_mirror_normalize(src, items, (2, 8, 8), [0, 0], [1, 1])
    # a crop wider than the output: the kernel would write past its slot
    wide = items.clone()
    wide[0, 12] = 9
    with pytest.raises(tmx.MXNetError, match="reaches outside"):
        idec.crop_mirror_normalize(src, wide, (3, 8, 8), [0] * 3, [1] * 3)
    with pytest.raises(tmx.MXNetError, match="int64"):
        idec.crop_mirror_normalize(src, items[:, :6], (3, 8, 8), [0] * 3,
                                   [1] * 3)
    with pytest.raises(tmx.MXNetError, match="3 values"):
        idec.crop_mirror_normalize(src, items, (3, 8, 8), [0], [1])


def test_image_iter_route_picked_and_counted(tmp_path):
    from mxnet_tpu_torch import recordio
    rec = str(tmp_path / "r.rec")
    w = recordio.MXIndexedRecordIO(str(tmp_path / "r.idx"), rec, "w")
    for i, b in enumerate(_jpegs(6, hw=40)):
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                                     b))
    w.close()
    timg.reset_routes()
    cases = [({"preprocess_threads": 2}, "native"),
             ({"preprocess_threads": 2, "brightness": 0.2}, "python"),
             ({"preprocess_threads": 2, "inter_method": 1}, "python"),
             ({}, "python")]
    for kw, route in cases:
        it = timg.ImageIter(4, (3, 32, 32), path_imgrec=rec, **kw)
        assert it.route == route
        b = it.next()
        assert b.data[0].context.type == "cpu"
        assert b.data[0].shape == (4, 3, 32, 32)
    assert timg.ROUTES == {"native": 1, "python": 3}
    assert timg.BACKENDS == {"opencv": 1, "nvjpeg": 0}
