"""Image decode, augmentation and ``ImageIter`` (the classification half
of the JAX package's ``image.py``; reference: python/mxnet/image/image.py
and src/io/image_aug_default.cc).

Decoded images are HWC **RGB** uint8, on the host: numpy, or a host
NDArray. Augmenters run in numpy and return the container they were
given (NDArray in, host NDArray out). Random draws come from generators
the caller passes (``rng``: a :class:`random.Random`; ``np_rng``: a
:class:`numpy.random.RandomState`) or that are made from a seed, never
from the global ``random`` / ``np.random``; a ``random.Random(s)`` gives
the draws the JAX package's augmenters take from ``random`` after
``random.seed(s)``, in the same order.

:class:`ImageIter` picks its route before the first batch and counts
every batch by route in :data:`ROUTES`:

* ``native``: when ``preprocess_threads`` > 0 and the augmentations are
  the native decoder's (:data:`_NATIVE_AUG_KEYS`: resize, random or
  center crop, mirror, mean / std, cubic interpolation):
  :class:`NativeImageDecoder` decodes and augments a whole batch in one
  call. Its backend is the first of :func:`decoder_backends` the machine
  has, counted by batch in :data:`BACKENDS`: ``opencv`` (OpenCV's C++
  API on host threads, ``native/imagedec.cc``; the JAX package's
  decoder) or ``nvjpeg`` (the CUDA toolkit's nvJPEG on the card, then
  one ``crop_mirror_normalize`` kernel; the batch stays on the card; no
  resize yet, ROADMAP A8.1b). A backend that is missing or cannot build
  raises.
* ``python``: every other augmentation: one image at a time through the
  Augmenter list, as in the reference.

The detection half (``ImageDetIter`` and its augmenters) waits for the
detection ops (ROADMAP A15).
"""
from __future__ import annotations

import json
import os
import random as _pyrandom

import numpy as np
import torch

from .base import MXNetError
from .io import DataIter
from .ndarray.ndarray import NDArray

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "random_size_crop",
           "color_normalize", "Augmenter", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "CenterCropAug", "RandomSizedCropAug",
           "HorizontalFlipAug", "CastAug", "ColorNormalizeAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "LightingAug", "ColorJitterAug", "CreateAugmenter",
           "NativeImageDecoder", "ImageIter", "decoder_backends", "ROUTES",
           "BACKENDS"]

# ImageIter batches by route since the last reset_routes()
ROUTES = {"native": 0, "python": 0}
# native-route batches by decoder backend
BACKENDS = {"opencv": 0, "nvjpeg": 0}

# the ImageNet mean / std that ``mean=True`` / ``std=True`` stand for
_IMAGENET_MEAN = np.array([123.68, 116.28, 103.53])
_IMAGENET_STD = np.array([58.395, 57.12, 57.375])


def reset_routes():
    """Set every route and backend count to 0."""
    for d in (ROUTES, BACKENDS):
        for k in d:
            d[k] = 0


def _cv2():
    import cv2
    return cv2


def _host(arr):
    """A host NDArray over numpy ``arr`` (no copy when contiguous)."""
    return NDArray(torch.from_numpy(np.ascontiguousarray(arr)))


def _to_np(img):
    if isinstance(img, NDArray):
        return img.asnumpy()
    return np.asarray(img)


def _wrap_like(src, out):
    """``out`` in ``src``'s container: a host NDArray for an NDArray,
    contiguous numpy for numpy."""
    if isinstance(src, NDArray):
        return _host(out)
    return np.ascontiguousarray(out)


def _rng(rng):
    return rng if rng is not None else _pyrandom.Random()


def imdecode(buf, flag=1, to_rgb=True, out=None, to_ndarray=True):
    """Decode image bytes to HWC uint8, RGB for ``flag`` 1 (reference:
    image.py imdecode over ``cv2.imdecode``): a host NDArray, or numpy
    with ``to_ndarray=False``."""
    cv2 = _cv2()
    if isinstance(buf, (bytes, bytearray)):
        buf = np.frombuffer(buf, dtype=np.uint8)
    img = cv2.imdecode(buf, cv2.IMREAD_COLOR if flag else
                       cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise MXNetError("cannot decode image")
    if flag and to_rgb:
        img = img[..., ::-1]
    if not flag:
        img = img[..., None]
    img = np.ascontiguousarray(img)
    return _host(img) if to_ndarray else img


def imread(filename, flag=1, to_rgb=True):
    """Reference: image.py imread."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def imresize(src, w, h, interp=1):
    """Resize an HWC image to (h, w) (reference: image.py imresize)."""
    cv2 = _cv2()
    interp_map = {0: cv2.INTER_NEAREST, 1: cv2.INTER_LINEAR,
                  2: cv2.INTER_CUBIC, 3: cv2.INTER_AREA,
                  4: cv2.INTER_LANCZOS4}
    out = cv2.resize(_to_np(src), (w, h),
                     interpolation=interp_map.get(interp, 1))
    if out.ndim == 2:
        out = out[..., None]
    return _wrap_like(src, out)


def resize_short(src, size, interp=2):
    """Resize so that the shorter edge is ``size`` (reference: image.py
    resize_short)."""
    h, w = _to_np(src).shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop a region, resized to ``size`` when given (reference:
    image.py fixed_crop)."""
    out = _to_np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return _wrap_like(src, _to_np(imresize(out, size[0], size[1],
                                               interp)))
    return _wrap_like(src, out)


def center_crop(src, size, interp=2):
    """(cropped image, (x0, y0, w, h)) (reference: image.py
    center_crop)."""
    h, w = _to_np(src).shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2, rng=None):
    """(cropped image, (x0, y0, w, h)) at a random origin drawn from
    ``rng`` (reference: image.py random_crop)."""
    rng = _rng(rng)
    h, w = _to_np(src).shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = rng.randint(0, w - new_w)
    y0 = rng.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2, rng=None):
    """A crop of random area and aspect ratio, resized to ``size``; the
    center crop after 10 misses (reference: image.py
    random_size_crop)."""
    rng = _rng(rng)
    h, w = _to_np(src).shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = rng.uniform(area[0], area[1]) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        new_w = int(round((target_area * aspect) ** 0.5))
        new_h = int(round((target_area / aspect) ** 0.5))
        if new_w <= w and new_h <= h:
            x0 = rng.randint(0, w - new_w)
            y0 = rng.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """``(src - mean) / std`` in float32 (reference: image.py
    color_normalize)."""
    img = _to_np(src).astype(np.float32)
    img = img - np.asarray(_to_np(mean), dtype=np.float32)
    if std is not None:
        img = img / np.asarray(_to_np(std), dtype=np.float32)
    return _wrap_like(src, img)


class Augmenter(object):
    """Base augmenter (reference: image.py Augmenter). ``rng`` is the
    :class:`random.Random` a random augmenter draws from."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2, rng=None):
        super().__init__(size=size, interp=interp)
        self.size, self.interp, self.rng = size, interp, _rng(rng)

    def __call__(self, src):
        return random_crop(src, self.size, self.interp, self.rng)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2, rng=None):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = \
            size, area, ratio, interp
        self.rng = _rng(rng)

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp, self.rng)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p, rng=None):
        super().__init__(p=p)
        self.p, self.rng = p, _rng(rng)

    def __call__(self, src):
        if self.rng.random() < self.p:
            return _wrap_like(src, _to_np(src)[:, ::-1])
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean, self.std = mean, std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness, rng=None):
        super().__init__(brightness=brightness)
        self.brightness, self.rng = brightness, _rng(rng)

    def __call__(self, src):
        alpha = 1.0 + self.rng.uniform(-self.brightness, self.brightness)
        return _wrap_like(src, _to_np(src).astype(np.float32) * alpha)


_GRAY = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast, rng=None):
        super().__init__(contrast=contrast)
        self.contrast, self.rng = contrast, _rng(rng)

    def __call__(self, src):
        alpha = 1.0 + self.rng.uniform(-self.contrast, self.contrast)
        img = _to_np(src).astype(np.float32)
        gray = (img * _GRAY).sum() * 3.0 / img.size
        return _wrap_like(src, img * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation, rng=None):
        super().__init__(saturation=saturation)
        self.saturation, self.rng = saturation, _rng(rng)

    def __call__(self, src):
        alpha = 1.0 + self.rng.uniform(-self.saturation, self.saturation)
        img = _to_np(src).astype(np.float32)
        gray = (img * _GRAY).sum(axis=2, keepdims=True)
        return _wrap_like(src, img * alpha + gray * (1.0 - alpha))


class LightingAug(Augmenter):
    """PCA lighting noise; ``np_rng`` is the
    :class:`numpy.random.RandomState` it draws from."""

    def __init__(self, alphastd, eigval, eigvec, np_rng=None):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, dtype=np.float32)
        self.eigvec = np.asarray(eigvec, dtype=np.float32)
        self.np_rng = np_rng if np_rng is not None \
            else np.random.RandomState()

    def __call__(self, src):
        alpha = self.np_rng.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return _wrap_like(src, _to_np(src).astype(np.float32) + rgb)


class ColorJitterAug(Augmenter):
    def __init__(self, brightness=0, contrast=0, saturation=0, rng=None):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self.rng = _rng(rng)
        self.augs = []
        if brightness:
            self.augs.append(BrightnessJitterAug(brightness, self.rng))
        if contrast:
            self.augs.append(ContrastJitterAug(contrast, self.rng))
        if saturation:
            self.augs.append(SaturationJitterAug(saturation, self.rng))

    def __call__(self, src):
        augs = list(self.augs)
        self.rng.shuffle(augs)
        for aug in augs:
            src = aug(src)
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2,
                    rng=None, np_rng=None):
    """The standard augmenter list (reference: image.py CreateAugmenter).
    Every random augmenter draws from the one ``rng`` (and the lighting
    noise from ``np_rng``), in the order the list applies them."""
    rng = _rng(rng)
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        if not rand_crop:
            raise MXNetError("rand_resize needs rand_crop")
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3. / 4., 4. / 3.), inter_method,
                                          rng))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method, rng))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5, rng))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation, rng))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec, np_rng))
    if mean is True:
        mean = _IMAGENET_MEAN
    if std is True:
        std = _IMAGENET_STD
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


def decoder_backends():
    """The native decoder's backends this machine has, in the order the
    route takes them: ``opencv`` (OpenCV's C++ headers), ``nvjpeg`` (the
    CUDA toolkit's nvJPEG)."""
    from . import _native
    from .ops.cuda import image_decode
    out = []
    if _native.opencv_include() is not None:
        out.append("opencv")
    if image_decode.nvjpeg_available():
        out.append("nvjpeg")
    return out


class NativeImageDecoder(object):
    """Decode and augment a whole batch of JPEG buffers in one call
    (reference: the OMP decode of src/io/iter_image_recordio_2.cc:78
    ParseChunk): resize of the short side (cubic), random or center
    crop, mirror, ``(x - mean) / std``, float32 CHW.

    The crop and mirror of an image are drawn from a generator keyed by
    (``seed``, its stream position): the same for any thread count.
    ``backend`` None takes the first of :func:`decoder_backends`;
    naming one that is missing raises, as does a machine with none.
    ``opencv`` decodes on ``num_threads`` host threads (0: one a core)
    into host memory and returns numpy; ``nvjpeg`` decodes on the card
    ``ctx`` (default ``cuda:0``) and returns a CUDA tensor (it does not
    resize yet: ROADMAP A8.1b)."""

    def __init__(self, data_shape, resize=0, rand_crop=False,
                 rand_mirror=False, mean=None, std=None, num_threads=0,
                 seed=0, backend=None, ctx=None):
        from . import _native
        c, h, w = (int(v) for v in data_shape)
        if c not in (1, 3):
            raise MXNetError("native decoder supports 1 or 3 channels")
        have = decoder_backends()
        if backend is None:
            if not have:
                raise MXNetError(
                    "no native image decoder backend on this machine: "
                    "neither OpenCV's C++ headers (%s) nor the CUDA "
                    "toolkit's nvJPEG" % _native.OPENCV_INCLUDE)
            backend = have[0]
        if backend not in ("opencv", "nvjpeg"):
            raise MXNetError("unknown decoder backend %r (opencv, nvjpeg)"
                             % (backend,))
        if backend not in have:
            raise MXNetError("decoder backend %r is not on this machine "
                             "(it has %s)" % (backend, have or "none"))
        if mean is True:
            mean = _IMAGENET_MEAN
        if std is True:
            std = _IMAGENET_STD

        def per_channel(v, default):
            if v is None:
                return np.full(c, default, np.float32)
            return np.ascontiguousarray(np.broadcast_to(
                np.asarray(_to_np(v), np.float32).ravel(), (3,))
                if c == 3 else np.asarray(_to_np(v), np.float32).ravel()[:1])

        self.backend = backend
        self._shape = (c, h, w)
        self._seed = int(seed)
        self._rand = (int(bool(rand_crop)), int(bool(rand_mirror)))
        self._mean = per_channel(mean, 0.0)
        self._std = per_channel(std, 1.0)
        self._h = None
        if backend == "opencv":
            import ctypes
            self._lib = _native.imagedec_lib()
            fp = ctypes.POINTER(ctypes.c_float)
            self._h = self._lib.imgdec_create(
                int(num_threads), h, w, c, int(resize), *self._rand,
                self._mean.ctypes.data_as(fp), self._std.ctypes.data_as(fp),
                self._seed)
            if not self._h:
                raise MXNetError("imgdec_create failed")
        else:
            from .context import default_device
            from .ops.cuda import image_decode
            if resize:
                raise MXNetError(
                    "the nvjpeg decoder backend does not resize yet "
                    "(resize=%d; ROADMAP A8.1b): write the records at the "
                    "training size (tools/im2rec.py --resize)" % resize)
            dev = default_device(ctx)
            if dev.type != "cuda":
                raise MXNetError("the nvjpeg decoder backend decodes on "
                                 "the card; ctx %s" % dev)
            self.device = dev
            self._plan = _native.imageplan_lib()
            self._pool = image_decode.NvJpegPool(num_threads, dev, c)

    def decode_batch(self, bufs, base=0, out=None):
        """Decode ``bufs`` (JPEG bytes) to (n, c, h, w) float32: numpy
        (``opencv``) or a CUDA tensor (``nvjpeg``), written into ``out``
        when given. ``base`` is the stream position of ``bufs[0]``."""
        n = len(bufs)
        c, h, w = self._shape
        if self.backend == "nvjpeg":
            return self._decode_nvjpeg(bufs, base, out)
        import ctypes
        if out is None:
            out = np.empty((n, c, h, w), np.float32)
        arr_p = (ctypes.c_char_p * n)(*bufs)
        lens = np.array([len(b) for b in bufs], dtype=np.int64)
        rc = self._lib.imgdec_decode_batch(
            self._h, n, ctypes.cast(arr_p, ctypes.c_void_p),
            lens.ctypes.data, int(base), out.ctypes.data)
        if rc != 0:
            raise MXNetError("native decode failed: %s" %
                             self._lib.imgdec_last_error(self._h)
                             .decode("utf-8", "replace"))
        return out

    def plan(self, hw, base=0):
        """(n, 3) int32 crop origins and mirror flags of images of
        heights and widths ``hw`` (n, 2) at stream positions ``base``,
        ``base + 1``, ... (the draws both backends take)."""
        lib = self._plan if self.backend == "nvjpeg" else self._lib
        hw = np.ascontiguousarray(hw, dtype=np.int32)
        plan = np.empty((hw.shape[0], 3), dtype=np.int32)
        c, h, w = self._shape
        small = lib.imgdec_plan(hw.shape[0], hw.ctypes.data, int(base),
                                self._seed, h, w, *self._rand,
                                plan.ctypes.data)
        if small:
            raise MXNetError(
                "image %d of the batch (%dx%d) is smaller than the %dx%d "
                "crop; the nvjpeg decoder backend does not resize yet "
                "(ROADMAP A8.1b)" % (small - 1, hw[small - 1, 1],
                                     hw[small - 1, 0], w, h))
        return plan

    def decode_planes(self, bufs, base=0):
        """The ``nvjpeg`` backend's first half: ``bufs`` decoded on the
        card to their component planes, as ``(src, items)``, the
        arguments of ``ops.cuda.image_decode.crop_mirror_normalize``
        (``items`` on the host) with this decoder's plan for stream
        positions ``base``, ..."""
        from .ops.cuda import image_decode
        info = self._pool.info(bufs)
        plan = self.plan(info[:, :2], base)
        kinds, nbytes = image_decode.plane_layout(info, self._shape[0])
        offsets = np.concatenate([[0], np.cumsum(nbytes)[:-1]]).astype(
            np.int64)
        src = torch.empty(int(nbytes.sum()), dtype=torch.uint8,
                          device=self.device)
        self._pool.decode(bufs, src, offsets, info)
        items = np.concatenate(
            [offsets[:, None], info[:, :2], plan, kinds[:, None],
             info[:, 4:6]], axis=1).astype(np.int64)
        return src, torch.from_numpy(items)

    def _decode_nvjpeg(self, bufs, base, out):
        from .ops.cuda import image_decode
        src, items = self.decode_planes(bufs, base)
        return image_decode.crop_mirror_normalize(
            src, items, self._shape, self._mean, self._std, out=out)

    def close(self):
        h, self._h = self._h, None
        if h:
            self._lib.imgdec_destroy(h)
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# the CreateAugmenter arguments the native decoder implements; any other
# (rand_resize, colour jitter, pca_noise, interpolation other than cubic)
# takes the python route
_NATIVE_AUG_KEYS = {"resize", "rand_crop", "rand_mirror", "mean", "std"}


def _native_route(preprocess_threads, aug_list, dtype, kwargs):
    return bool(preprocess_threads and aug_list is None
                and dtype == "float32"
                and all(k in _NATIVE_AUG_KEYS or not kwargs[k]
                        for k in kwargs if k != "inter_method")
                and kwargs.get("inter_method", 2) == 2)


class ImageIter(DataIter):
    """Image batches from a ``.rec`` file (indexed or not), an image
    list file or an in-memory ``imglist`` (reference: image.py
    ImageIter; C++ hot path src/io/iter_image_recordio_2.cc).

    The route (module docstring) is picked here, before any batch:
    ``native`` when ``preprocess_threads`` > 0 and ``kwargs`` are the
    native decoder's augmentations, else ``python``. Shuffling draws
    from ``random.Random(io.mix_seed(seed, epoch))``; the python route's
    augmenters from ``random.Random(seed)`` and
    ``numpy.random.RandomState(seed)``, which draw what the JAX
    package's take from ``random`` / ``np.random`` seeded with ``seed``.
    ``num_parts`` / ``part_index`` shard the records (``io.shard_bounds``).
    Batches are host NDArrays, except on the ``nvjpeg`` backend, whose
    batches stay on the card ``ctx`` (a host ``ctx`` copies them back).
    """

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, imglist=None, dtype="float32",
                 num_parts=1, part_index=0, preprocess_threads=0, seed=0,
                 ctx=None, **kwargs):
        from .io import DataDesc, shard_bounds
        super().__init__(batch_size)
        if not (path_imgrec or path_imglist or imglist is not None):
            raise MXNetError("ImageIter needs path_imgrec, path_imglist or "
                             "imglist")
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.dtype = dtype
        self._seed = int(seed)
        self.route = ("native" if _native_route(preprocess_threads,
                                                aug_list, dtype, kwargs)
                      else "python")
        self._native = None
        self._ctx = None if ctx is None else torch.device(ctx)
        if self.route == "native":
            dev = self._ctx
            if dev is not None and dev.type != "cuda":
                dev = None          # nvjpeg decodes on cuda:0, copied back
            self._native = NativeImageDecoder(
                data_shape, resize=kwargs.get("resize", 0),
                rand_crop=kwargs.get("rand_crop", False),
                rand_mirror=kwargs.get("rand_mirror", False),
                mean=kwargs.get("mean"), std=kwargs.get("std"),
                num_threads=preprocess_threads, seed=self._seed, ctx=dev)
            self.auglist = []
        else:
            self.auglist = aug_list if aug_list is not None else \
                CreateAugmenter(data_shape, rng=_pyrandom.Random(self._seed),
                                np_rng=np.random.RandomState(
                                    self._seed % (2 ** 32)), **kwargs)
        self._stream_pos = 0                  # RNG key of the native route
        self._shuffle_epoch = -1
        self.imgrec = None
        self.imglist = None
        self.seq = None
        if path_imgrec:
            from . import recordio
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx_path):
                self.imgrec = recordio.MXIndexedRecordIO(
                    idx_path, path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
        elif path_imglist:
            self.imglist = {}
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    label = np.array(parts[1:-1], dtype=np.float32)
                    self.imglist[int(parts[0])] = (label, parts[-1])
            self.seq = sorted(self.imglist)
            self.path_root = path_root
        else:
            self.imglist = {i: (np.array(lbl, dtype=np.float32), p)
                            for i, (lbl, p) in enumerate(imglist)}
            self.seq = sorted(self.imglist)
            self.path_root = path_root
        if int(num_parts) > 1:
            if self.seq is None:
                raise MXNetError(
                    "num_parts>1 needs an indexed .rec (an .idx next to the "
                    ".rec) or an image list to shard")
            lo, hi = shard_bounds(len(self.seq), num_parts, part_index)
            self.seq = self.seq[lo:hi]
        self.provide_data = [DataDesc(
            "data", (batch_size,) + self.data_shape, dtype)]
        self.provide_label = [DataDesc(
            "softmax_label", (batch_size, label_width)
            if label_width > 1 else (batch_size,), dtype)]
        self.cursor = 0
        self.reset()

    def reset(self):
        self.cursor = 0
        if self.shuffle and self.seq is not None:
            from .io import mix_seed
            self._shuffle_epoch += 1
            _pyrandom.Random(mix_seed(self._seed, self._shuffle_epoch)
                             ).shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()

    def next_sample(self):
        from . import recordio
        if self.seq is not None and self.cursor >= len(self.seq):
            raise StopIteration
        if self.imgrec is not None:
            if self.seq is not None:
                rec = self.imgrec.read_idx(self.seq[self.cursor])
            else:
                rec = self.imgrec.read()
                if rec is None:
                    raise StopIteration
            self.cursor += 1
            header, img = recordio.unpack(rec)
            return header.label, img
        label, fname = self.imglist[self.seq[self.cursor]]
        self.cursor += 1
        with open(os.path.join(self.path_root, fname), "rb") as f:
            return label, f.read()

    def _samples(self, batch_label):
        """Up to a batch of (label into batch_label, payload)."""
        bufs = []
        try:
            while len(bufs) < self.batch_size:
                label, s = self.next_sample()
                batch_label[len(bufs)] = label
                bufs.append(bytes(s))
        except StopIteration:
            if not bufs:
                raise
        return bufs

    def next(self):
        from .io import DataBatch
        c, h, w = self.data_shape
        batch_label = np.zeros((self.batch_size, self.label_width),
                               dtype=np.float32)
        bufs = self._samples(batch_label)
        if self._native is not None:
            if self._native.backend == "nvjpeg":
                data = torch.zeros((self.batch_size, c, h, w),
                                   dtype=torch.float32,
                                   device=self._native.device)
                self._native.decode_batch(bufs, base=self._stream_pos,
                                          out=data[:len(bufs)])
                if self._ctx is not None and self._ctx.type != "cuda":
                    data = data.cpu()
                data = NDArray(data)
            else:
                batch = np.zeros((self.batch_size, c, h, w), np.float32)
                self._native.decode_batch(bufs, base=self._stream_pos,
                                          out=batch[:len(bufs)])
                data = _host(batch)
            self._stream_pos += len(bufs)
            BACKENDS[self._native.backend] += 1
        else:
            batch = np.zeros((self.batch_size, c, h, w), dtype=self.dtype)
            for i, s in enumerate(bufs):
                img = imdecode(s, 1 if c == 3 else 0, to_ndarray=False)
                for aug in self.auglist:
                    img = aug(img)
                arr = _to_np(img)
                if arr.ndim == 3:
                    arr = arr.transpose(2, 0, 1)
                batch[i] = arr
            data = _host(batch)
        ROUTES[self.route] += 1
        pad = self.batch_size - len(bufs)
        lbl = batch_label[:, 0] if self.label_width == 1 else batch_label
        return DataBatch(data=[data], label=[_host(lbl)], pad=pad)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self
