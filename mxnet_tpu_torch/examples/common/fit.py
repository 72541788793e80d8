"""Fit plumbing of the image-classification CLIs (the JAX package's
``examples/common/fit.py``; reference: example/image-classification/
common/fit.py): the training flags, the learning-rate schedule, the
checkpoint flags and ``Module.fit``.

The device: ``cuda:0`` unless ``--gpus`` says otherwise; ``--gpus ""``
(reference MXNet's reading of an empty list) trains on the host, and
nothing picks the host because a card is missing. ``--gpus 0,1`` (data
parallel, ROADMAP A8.3), ``--kv-store dist_*`` (A13) and ``--monitor 1``
(A8.6) raise.

Checkpoints: ``--model-prefix`` saves the symbol, the parameters, the
optimizer states and the manifest every ``--save-period`` epochs
(``callback.module_checkpoint``); ``--load-epoch`` starts from that
checkpoint's parameters at that epoch, as the reference's
``load_checkpoint`` does.
"""
from __future__ import annotations

import logging
import math
import os

from ... import callback, lr_scheduler, metric, model
from ... import init as _init
from ... import io as _io
from ... import mod as _mod
from ...context import cpu, default_device, gpu

__all__ = ["add_fit_args", "fit", "device_of"]


def get_epoch_size(args):
    return math.ceil(args.num_examples / args.batch_size)


def _get_lr_scheduler(args):
    if not args.lr_factor or args.lr_factor >= 1:
        return args.lr, None
    epoch_size = get_epoch_size(args)
    begin_epoch = args.load_epoch or 0
    step_epochs = [int(x) for x in args.lr_step_epochs.split(",")]
    lr = args.lr
    for s in step_epochs:
        if begin_epoch >= s:
            lr *= args.lr_factor
    if lr != args.lr:
        logging.info("Adjusted learning rate to %e for epoch %d", lr,
                     begin_epoch)
    steps = [epoch_size * (x - begin_epoch)
             for x in step_epochs if x - begin_epoch > 0]
    if not steps:
        return lr, None
    return lr, lr_scheduler.MultiFactorScheduler(
        step=steps, factor=args.lr_factor, base_lr=args.lr)


def add_fit_args(parser):
    train = parser.add_argument_group("Training")
    train.add_argument("--network", type=str, default="resnet",
                       help="the network to train (resnet, mlp)")
    train.add_argument("--num-layers", type=int, default=50)
    train.add_argument("--gpus", "--tpus", dest="gpus", type=str,
                       default=None,
                       help="the card to train on, e.g. 0 (default: 0); "
                            "\"\" trains on the host")
    train.add_argument("--kv-store", type=str, default="device",
                       help="local | device (one card)")
    train.add_argument("--num-epochs", type=int, default=90)
    train.add_argument("--lr", type=float, default=0.1)
    train.add_argument("--lr-factor", type=float, default=0.1)
    train.add_argument("--lr-step-epochs", type=str, default="30,60,80")
    train.add_argument("--optimizer", type=str, default="sgd")
    train.add_argument("--mom", type=float, default=0.9)
    train.add_argument("--wd", type=float, default=1e-4)
    train.add_argument("--batch-size", type=int, default=128)
    train.add_argument("--disp-batches", type=int, default=20)
    train.add_argument("--model-prefix", type=str, default=None)
    train.add_argument("--save-period", type=int, default=1)
    train.add_argument("--load-epoch", type=int, default=None)
    train.add_argument("--max-batches", type=int, default=None,
                       help="stop every epoch after this many batches")
    train.add_argument("--monitor", type=int, default=0)
    train.add_argument("--loss", type=str, default="",
                       help="also show this loss: ce (cross-entropy)")
    return train


def device_of(args):
    """The training device of ``--gpus``."""
    if args.gpus is None:
        return default_device(None)
    if args.gpus.strip() == "":
        return cpu()
    ids = [int(i) for i in args.gpus.split(",")]
    if len(ids) > 1:
        raise NotImplementedError(
            "--gpus %s: data-parallel training over several cards is not "
            "ported yet (ROADMAP A8.3)" % args.gpus)
    return default_device(gpu(ids[0]))


def fit(args, network, data_loader):
    """Train ``network`` with the flags in ``args`` and return the
    ``Module`` (reference: common/fit.py fit). ``data_loader(args,
    ctx)`` gives (train, val)."""
    if "dist" in args.kv_store:
        raise NotImplementedError(
            "--kv-store %s: distributed training is not ported yet "
            "(ROADMAP A13)" % args.kv_store)
    if args.monitor:
        raise NotImplementedError("--monitor: monitors are not ported yet "
                                  "(ROADMAP A8.6)")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-15s Node[0] %(message)s")
    logging.info("start with arguments %s", args)
    ctx = device_of(args)
    train, val = data_loader(args, ctx)

    lr, sched = _get_lr_scheduler(args)
    sym, arg_params, aux_params = network, None, None
    if args.load_epoch is not None:
        if args.model_prefix is None:
            raise ValueError("--load-epoch needs --model-prefix")
        sym, arg_params, aux_params = model.load_checkpoint(
            args.model_prefix, args.load_epoch)

    mod = _mod.Module(symbol=sym, context=ctx)
    optimizer_params = {"learning_rate": lr, "wd": args.wd,
                        "lr_scheduler": sched}
    if args.optimizer in ("sgd", "nag", "signum"):
        optimizer_params["momentum"] = args.mom

    checkpoint = None
    if args.model_prefix is not None:
        dst_dir = os.path.dirname(args.model_prefix)
        if dst_dir:
            os.makedirs(dst_dir, exist_ok=True)
        checkpoint = callback.module_checkpoint(
            mod, args.model_prefix, period=args.save_period,
            save_optimizer_states=True)

    eval_metrics = ["accuracy"]
    if args.num_classes >= 5:
        eval_metrics.append(metric.create("top_k_accuracy", top_k=5))
    if args.loss:
        if args.loss != "ce":
            raise ValueError("--loss %r (ce)" % args.loss)
        eval_metrics.append("ce")

    if args.max_batches:
        train = _io.ResizeIter(train, args.max_batches)

    mod.fit(train,
            begin_epoch=args.load_epoch or 0,
            num_epoch=args.num_epochs,
            eval_data=val,
            eval_metric=eval_metrics,
            kvstore=args.kv_store,
            optimizer=args.optimizer,
            optimizer_params=optimizer_params,
            initializer=_init.Xavier(rnd_type="gaussian", factor_type="in",
                                     magnitude=2),
            arg_params=arg_params,
            aux_params=aux_params,
            batch_end_callback=[callback.Speedometer(args.batch_size,
                                                     args.disp_batches)],
            epoch_end_callback=checkpoint,
            allow_missing=True)
    return mod
