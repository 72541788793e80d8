"""A bucketed LSTM language model through the legacy ``mx.rnn`` API and
``BucketingModule`` (the JAX package's ``examples/lstm_bucketing.py``;
reference: example/rnn/bucketing/lstm_bucketing.py, the PTB LSTM).

With ``--data`` (a tokenized text file: one sentence a line, tokens
separated by spaces) it trains on that corpus; without it, on the same
seeded synthetic corpus as the JAX package's CLI, so it runs with no
file. Each bucket unrolls ``--num-layers`` ``LSTMCell``s over its length;
``SoftmaxOutput`` ignores the padding label -1, and so does the
``Perplexity`` metric.

    # on cuda:0, PTB "small" widths:
    python3 -m mxnet_tpu_torch.examples.lstm_bucketing --data corpus.txt \\
        --num-hidden 200 --num-embed 200 --batch-size 32 \\
        --buckets 10,20,30,40,50,60
    # on the host:
    python3 -m mxnet_tpu_torch.examples.lstm_bucketing --gpus ""

``main(argv)`` runs in-process and returns the trained
``BucketingModule``.
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from .. import callback, init, metric, rnn, sym
from .. import mod as _mod
from .common.fit import device_of

__all__ = ["build_vocab", "encode", "synthetic_corpus", "lstm_stack",
           "sym_gen_for", "parse_args", "main"]


def build_vocab(lines):
    """Token -> id, from 1 in order of first appearance (0 pads)."""
    vocab = {}
    for line in lines:
        for tok in line.split():
            if tok not in vocab:
                vocab[tok] = len(vocab) + 1
    return vocab


def encode(lines, vocab):
    return [[vocab[t] for t in line.split()] for line in lines]


def synthetic_corpus(n=400, vocab_size=30, seed=0):
    """``n`` sentences of 4-16 consecutive ids mod ``vocab_size`` (plus
    one), and the vocabulary size with the padding id."""
    rng = np.random.RandomState(seed)
    sents = []
    for _ in range(n):
        start = rng.randint(0, vocab_size)
        ln = rng.randint(4, 17)
        sents.append([(start + k) % vocab_size + 1 for k in range(ln)])
    return sents, vocab_size + 1


def lstm_stack(num_layers, num_hidden):
    """``num_layers`` ``LSTMCell``s of ``num_hidden``, "lstm_l<i>_"."""
    stack = rnn.SequentialRNNCell()
    for i in range(num_layers):
        stack.add(rnn.LSTMCell(num_hidden=num_hidden, prefix="lstm_l%d_" % i))
    return stack


def sym_gen_for(stack, vocab_size, num_embed, num_hidden, batch_size):
    """The bucketing module's ``sym_gen``: bucket length -> (symbol,
    data names, label names)."""
    def sym_gen(seq_len):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data, input_dim=vocab_size,
                              output_dim=num_embed, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, embed, merge_outputs=True,
                                  batch_size=batch_size)
        pred = sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = sym.FullyConnected(pred, num_hidden=vocab_size, name="pred")
        label_f = sym.Reshape(label, shape=(-1,))
        net = sym.SoftmaxOutput(pred, label_f, name="softmax",
                                use_ignore=True, ignore_label=-1)
        return net, ("data",), ("softmax_label",)
    return sym_gen


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="bucketed LSTM language model")
    ap.add_argument("--data", type=str, default=None,
                    help="tokenized text file; synthetic corpus if unset")
    ap.add_argument("--num-hidden", type=int, default=64)
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--num-embed", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--buckets", type=str, default="8,16,24,32")
    ap.add_argument("--num-epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--disp-batches", type=int, default=50)
    ap.add_argument("--gpus", default=None,
                    help='the card to train on (default cuda:0); "" '
                    "trains on the host")
    return ap.parse_args(argv)


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), train, and return the
    ``BucketingModule``."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.data:
        with open(args.data) as f:
            lines = [line.strip() for line in f if line.strip()]
        vocab = build_vocab(lines)
        sentences = encode(lines, vocab)
        vocab_size = len(vocab) + 1
    else:
        sentences, vocab_size = synthetic_corpus()

    buckets = [int(b) for b in args.buckets.split(",")]
    it = rnn.BucketSentenceIter(sentences, args.batch_size, buckets=buckets,
                                invalid_label=-1)
    stack = lstm_stack(args.num_layers, args.num_hidden)
    mod = _mod.BucketingModule(
        sym_gen_for(stack, vocab_size, args.num_embed, args.num_hidden,
                    args.batch_size),
        default_bucket_key=it.default_bucket_key, context=device_of(args))
    mod.fit(it,
            eval_metric=metric.Perplexity(ignore_label=-1),
            optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            initializer=init.Xavier(factor_type="in", magnitude=2.34),
            num_epoch=args.num_epochs,
            batch_end_callback=callback.Speedometer(args.batch_size,
                                                    args.disp_batches))
    return mod


if __name__ == "__main__":
    main(sys.argv[1:])
