"""Train an MLP or LeNet on MNIST through ``Module.fit`` (the JAX
package's ``examples/train_mnist.py``; reference:
example/image-classification/train_mnist.py).

MNIST is read from ``--data-dir`` (the four gzipped idx files); without
one, a seeded synthetic set of the same shape (10 classes, a bright blob
whose position is the class) is made, so nothing is downloaded.

    # on cuda:0:
    python3 -m mxnet_tpu_torch.examples.train_mnist --network lenet
    # on the host:
    python3 -m mxnet_tpu_torch.examples.train_mnist --gpus "" --num-epochs 1

``main(argv)`` runs in-process and returns the trained ``Module``; with
``--model-prefix`` it saves the checkpoint of the last epoch, which the
JAX package's ``Module.load`` reads.
"""
from __future__ import annotations

import argparse
import gzip
import logging
import os
import struct
import sys

import numpy as np

from .. import callback, io, sym
from .. import mod as _mod
from .common.fit import device_of

__all__ = ["load_mnist", "synthetic_mnist", "get_symbol", "main"]


def load_mnist(data_dir, split):
    """(images (n, 1, 28, 28) float32 in [0, 1], labels float32) of the
    idx files ``<split>-{images-idx3,labels-idx1}-ubyte.gz``."""
    img = os.path.join(data_dir, "%s-images-idx3-ubyte.gz" % split)
    lbl = os.path.join(data_dir, "%s-labels-idx1-ubyte.gz" % split)
    with gzip.open(lbl) as f:
        struct.unpack(">II", f.read(8))
        label = np.frombuffer(f.read(), dtype=np.uint8)
    with gzip.open(img) as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        image = np.frombuffer(f.read(), dtype=np.uint8)
        image = image.reshape(n, 1, rows, cols).astype(np.float32) / 255.0
    return image, label.astype(np.float32)


def synthetic_mnist(n, seed=0):
    """``n`` separable 10-class images: the class sets a blob's place."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = rng.randn(n, 1, 28, 28).astype(np.float32) * 0.3
    for i, c in enumerate(y):
        r, col = divmod(int(c), 4)
        x[i, 0, 4 + r * 6:10 + r * 6, 4 + col * 6:10 + col * 6] += 2.0
    return x, y.astype(np.float32)


def get_symbol(network):
    """The ``mlp`` (128-64-10, ReLU) or ``lenet`` (two 5x5 tanh
    convolutions with max pools, a 500-unit tanh layer) symbol under
    ``SoftmaxOutput``."""
    data = sym.Variable("data")
    if network == "mlp":
        h = sym.Flatten(data)
        h = sym.FullyConnected(h, num_hidden=128, name="fc1")
        h = sym.Activation(h, act_type="relu")
        h = sym.FullyConnected(h, num_hidden=64, name="fc2")
        h = sym.Activation(h, act_type="relu")
        h = sym.FullyConnected(h, num_hidden=10, name="fc3")
    elif network == "lenet":
        h = sym.Convolution(data, kernel=(5, 5), num_filter=20)
        h = sym.Activation(h, act_type="tanh")
        h = sym.Pooling(h, pool_type="max", kernel=(2, 2), stride=(2, 2))
        h = sym.Convolution(h, kernel=(5, 5), num_filter=50)
        h = sym.Activation(h, act_type="tanh")
        h = sym.Pooling(h, pool_type="max", kernel=(2, 2), stride=(2, 2))
        h = sym.Flatten(h)
        h = sym.FullyConnected(h, num_hidden=500)
        h = sym.Activation(h, act_type="tanh")
        h = sym.FullyConnected(h, num_hidden=10)
    else:
        raise ValueError("unknown network %r" % network)
    return sym.SoftmaxOutput(h, name="softmax")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="train mnist")
    ap.add_argument("--network", default="mlp", choices=["mlp", "lenet"])
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--num-examples", type=int, default=6000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--num-epochs", type=int, default=6)
    ap.add_argument("--kv-store", default="local")
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--model-prefix", default=None)
    ap.add_argument("--gpus", default=None,
                    help='the card to train on (default cuda:0); "" '
                    "trains on the host")
    return ap.parse_args(argv)


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), train, print the final
    validation accuracy, and return the ``Module``."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.data_dir:
        X, Y = load_mnist(args.data_dir, "train")
        Xv, Yv = load_mnist(args.data_dir, "t10k")
    else:
        X, Y = synthetic_mnist(args.num_examples)
        Xv, Yv = synthetic_mnist(args.num_examples // 6, seed=1)
    train = io.NDArrayIter(X, Y, batch_size=args.batch_size, shuffle=True,
                           label_name="softmax_label")
    val = io.NDArrayIter(Xv, Yv, batch_size=args.batch_size,
                         label_name="softmax_label")
    mod = _mod.Module(get_symbol(args.network), context=device_of(args))
    mod.fit(train, eval_data=val, eval_metric="acc",
            optimizer=args.optimizer,
            optimizer_params={"learning_rate": args.lr,
                              "momentum": args.momentum},
            kvstore=args.kv_store, num_epoch=args.num_epochs,
            batch_end_callback=callback.Speedometer(args.batch_size, 50))
    score = mod.score(val, "acc")
    print("final validation accuracy: %.4f" % dict(score)["accuracy"])
    if args.model_prefix:
        mod.save_checkpoint(args.model_prefix, args.num_epochs)
    return mod


if __name__ == "__main__":
    main(sys.argv[1:])
