#!/usr/bin/env python
"""Train a small decoder-only LM, then greedy-decode from it (the JAX
package's ``examples/train_transformer_lm.py``).

The task is the JAX CLI's: predict the next token of one seeded
repeating n-gram stream, each batch a set of seeded rotations of it. The
flags, the stream and the printed lines (``step ...  loss ...``,
``mesh=... final loss ...``, ``generated N tokens; next-token match
...``) are the JAX CLI's. ``--num-experts`` makes every block an MoE
layer (top-2, capacity factor 2.0); ``--generate N`` decodes N tokens
after a 16-token prompt of the stream through the dense KV cache
(``transformer_generate``).

``--mesh`` (dp,sp,tp,pp,ep) defaults to ``1,1,1,1,1``, one card, where
the JAX CLI's default is ``2,2,2,1,1``: this port runs the train step on
one device, and a size above 1 on any axis raises naming the ROADMAP
item that ports it (A13 / A15).

    python3 -m mxnet_tpu_torch.examples.train_transformer_lm \\
        --num-experts 8 --generate 32

``main(argv=None, device=None)`` runs on ``cuda:0`` unless ``device``
says otherwise (``device="cpu"`` for the host) and returns a dict with
the trained ``params``, the final ``loss``, and, with ``--generate``,
the ``generated`` tokens and their ``match`` share.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..context import default_device
from ..parallel.transformer import (AXES, TransformerConfig, _check_mesh,
                                    init_transformer_params_np,
                                    make_transformer_train_step,
                                    transformer_generate)

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="1,1,1,1,1",
                    help="dp,sp,tp,pp,ep sizes")
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--num-experts", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--generate", type=int, default=0, metavar="N",
                    help="after training, greedy-decode N tokens from "
                         "a training prompt (KV-cache path)")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    args = parse_args(argv)
    device = default_device(device)
    shape = tuple(int(x) for x in args.mesh.split(","))
    if len(shape) != len(AXES):
        raise ValueError("--mesh takes %d sizes (%s), got %r"
                         % (len(AXES), ",".join(AXES), args.mesh))
    mesh = dict(zip(AXES, shape))
    _check_mesh(mesh)
    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_len=args.seq_len,
        num_experts=args.num_experts)
    params = init_transformer_params_np(cfg, seed=0, device=device,
                                        trainable=True)
    step = make_transformer_train_step(cfg, mesh, lr=args.lr)

    # task: predict the next token of a repeating-ngram stream
    rng = np.random.RandomState(0)
    base = rng.randint(0, args.vocab, args.seq_len + 1)

    def batch():
        rolls = rng.randint(0, args.seq_len, args.batch_size)
        seqs = np.stack([np.roll(base, -r) for r in rolls])
        return (torch.from_numpy(seqs[:, :-1].astype(np.int32)).to(device),
                torch.from_numpy(seqs[:, 1:].astype(np.int32)).to(device))

    t0 = time.time()
    loss = None
    for i in range(args.steps):
        tok, tgt = batch()
        params, loss = step(params, tok, tgt)
        if i in (0, args.steps - 1) or i % 10 == 0:
            print("step %4d  loss %.4f  (%.1fs)"
                  % (i, float(loss), time.time() - t0))
    loss = float(loss) if loss is not None else float("nan")
    print("mesh=%s final loss %.4f" % (mesh, loss))
    out = {"params": params, "loss": loss}

    if args.generate:
        # greedy decode through the dense KV cache; on the
        # repeating-ngram task the model should echo the stream
        prompt_len = min(16, args.seq_len // 2)
        prompt = torch.from_numpy(
            np.asarray(base[:prompt_len], np.int32)[None]).to(device)
        cfg_gen = TransformerConfig(
            vocab_size=args.vocab, d_model=args.d_model,
            n_heads=args.n_heads, n_layers=args.n_layers,
            d_ff=args.d_ff, max_len=prompt_len + args.generate,
            num_experts=args.num_experts)
        gen = transformer_generate(params, prompt, args.generate, cfg_gen)
        truth = base[prompt_len:prompt_len + args.generate]
        n = min(len(truth), args.generate)   # stream may be shorter
        match = float((gen[0].cpu().numpy()[:n] == truth[:n]).mean())
        print("generated %d tokens; next-token match vs stream "
              "(first %d): %.2f" % (args.generate, n, match))
        out.update(generated=gen, match=match)
    return out


if __name__ == "__main__":
    main()
