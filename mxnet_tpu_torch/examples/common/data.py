"""Data plumbing of the image-classification CLIs (the JAX package's
``examples/common/data.py``; reference: example/image-classification/
common/data.py): the data and augmentation flags, the RecordIO
iterators, and a synthetic-data iterator for ``--benchmark 1``."""
from __future__ import annotations

import numpy as np

from ... import io
from ...ndarray.ndarray import array

__all__ = ["add_data_args", "add_data_aug_args", "SyntheticDataIter",
           "get_rec_iter"]


def add_data_args(parser):
    data = parser.add_argument_group("Data")
    data.add_argument("--data-train", type=str, help="training .rec file")
    data.add_argument("--data-train-idx", type=str, default="")
    data.add_argument("--data-val", type=str, help="validation .rec file")
    data.add_argument("--data-val-idx", type=str, default="")
    data.add_argument("--rgb-mean", type=str, default="123.68,116.779,103.939")
    data.add_argument("--rgb-std", type=str, default="1,1,1")
    data.add_argument("--pad-size", type=int, default=0)
    data.add_argument("--image-shape", type=str, default="3,224,224")
    data.add_argument("--num-classes", type=int, default=1000)
    data.add_argument("--num-examples", type=int, default=1281167)
    data.add_argument("--data-nthreads", type=int, default=4,
                      help="number of decode threads")
    data.add_argument("--benchmark", type=int, default=0,
                      help="1: use synthetic data to benchmark the compute "
                           "path without storage in the loop")
    return data


def add_data_aug_args(parser):
    aug = parser.add_argument_group("Augmentation")
    aug.add_argument("--random-crop", type=int, default=0)
    aug.add_argument("--random-mirror", type=int, default=0)
    aug.add_argument("--random-resized-crop", type=int, default=0)
    aug.add_argument("--min-random-area", type=float, default=1.0)
    aug.add_argument("--max-random-aspect-ratio", type=float, default=0.0)
    aug.add_argument("--min-random-aspect-ratio", type=float, default=None)
    aug.add_argument("--brightness", type=float, default=0.0)
    aug.add_argument("--contrast", type=float, default=0.0)
    aug.add_argument("--saturation", type=float, default=0.0)
    aug.add_argument("--pca-noise", type=float, default=0.0)
    return aug


class SyntheticDataIter(io.DataIter):
    """One fixed batch from ``RandomState(0)`` (data uniform in [-1, 1),
    labels in [0, num_classes)) replayed ``epoch_size`` times, made once
    on ``ctx``: the training step with no input pipeline (reference:
    common/fit.py get_synthetic_dataiter)."""

    def __init__(self, num_classes, data_shape, epoch_size, ctx,
                 dtype="float32"):
        super().__init__(batch_size=data_shape[0])
        self._epoch_size = epoch_size
        rng = np.random.RandomState(0)
        self._data = array(rng.uniform(-1, 1, data_shape).astype(dtype),
                           ctx=ctx)
        self._label = array(rng.randint(0, num_classes, (data_shape[0],))
                            .astype(np.float32), ctx=ctx)
        self.provide_data = [io.DataDesc("data", data_shape, dtype)]
        self.provide_label = [io.DataDesc(
            "softmax_label", (data_shape[0],), "float32")]
        self._cur = 0

    def reset(self):
        self._cur = 0

    def next(self):
        if self._cur >= self._epoch_size:
            raise StopIteration
        self._cur += 1
        return io.DataBatch(data=[self._data], label=[self._label],
                            provide_data=self.provide_data,
                            provide_label=self.provide_label)


def get_rec_iter(args, ctx):
    """(train, val) iterators for ``ctx``, the training device. Records
    decode on ``--data-nthreads`` threads (the native route where the
    augmentations allow it) and are staged onto a card ``ctx`` by a
    ``PrefetchingIter`` through pinned buffers."""
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    if args.benchmark:
        epoch_size = max(1, args.num_examples // args.batch_size)
        return SyntheticDataIter(args.num_classes,
                                 (args.batch_size,) + image_shape,
                                 epoch_size, ctx), None
    if not args.data_train:
        raise ValueError("--data-train is required unless --benchmark 1")
    mean = [float(x) for x in args.rgb_mean.split(",")]
    std = [float(x) for x in args.rgb_std.split(",")]
    common = dict(data_shape=image_shape, batch_size=args.batch_size,
                  mean_r=mean[0], mean_g=mean[1], mean_b=mean[2],
                  std_r=std[0], std_g=std[1], std_b=std[2],
                  preprocess_threads=args.data_nthreads, prefetch_buffer=2,
                  ctx=ctx)
    train = io.ImageRecordIter(
        path_imgrec=args.data_train, shuffle=True,
        rand_crop=bool(args.random_crop),
        rand_mirror=bool(args.random_mirror),
        brightness=args.brightness, contrast=args.contrast,
        saturation=args.saturation, pca_noise=args.pca_noise, **common)
    val = None
    if args.data_val:
        val = io.ImageRecordIter(path_imgrec=args.data_val, shuffle=False,
                                 **common)
    return train, val
