"""Train an image-classification network on ImageNet-format RecordIO
data: the north-star CLI (the JAX package's
``examples/train_imagenet.py``; reference: example/image-classification/
train_imagenet.py).

    # real data, on cuda:0:
    python3 -m mxnet_tpu_torch.examples.train_imagenet --network resnet \\
        --num-layers 50 --data-train train.rec --batch-size 32 \\
        --model-prefix build/ckpt/r50

    # synthetic data (the compute path alone):
    python3 -m mxnet_tpu_torch.examples.train_imagenet --network resnet \\
        --num-layers 50 --benchmark 1 --batch-size 32 --max-batches 48

    # on the host, at a small size:
    python3 -m mxnet_tpu_torch.examples.train_imagenet --gpus "" \\
        --network mlp --image-shape 3,32,32 --num-classes 10 \\
        --data-train small.rec --batch-size 16 --num-epochs 1

``main(argv)`` runs in-process and returns the trained ``Module``. The
networks are ``resnet`` and ``mlp``; the JAX package's others (alexnet,
vgg, mobilenet, inception-bn) come with ROADMAP A8.8.
"""
from __future__ import annotations

import argparse
import sys

from .. import models
from .common import data, fit

__all__ = ["get_network", "main"]

NETWORKS = ("resnet", "mlp")


def get_network(args):
    """The symbol of ``--network``."""
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    if args.network == "resnet":
        return models.resnet(num_classes=args.num_classes,
                             num_layers=args.num_layers,
                             image_shape=image_shape)
    if args.network == "mlp":
        return models.mlp(num_classes=args.num_classes)
    raise NotImplementedError(
        "--network %r is not ported yet (this port trains %s; the JAX "
        "package's alexnet, vgg, mobilenet and inception-bn come with "
        "ROADMAP A8.8)" % (args.network, ", ".join(NETWORKS)))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train imagenet-1k",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    fit.add_fit_args(parser)
    data.add_data_args(parser)
    data.add_data_aug_args(parser)
    parser.set_defaults(network="resnet", num_layers=50, num_classes=1000,
                        num_examples=1281167, image_shape="3,224,224",
                        batch_size=32, lr=0.1, lr_step_epochs="30,60,80")
    return parser.parse_args(argv)


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), train, and return the
    ``Module``."""
    args = parse_args(argv)
    return fit.fit(args, get_network(args), data.get_rec_iter)


if __name__ == "__main__":
    main(sys.argv[1:])
