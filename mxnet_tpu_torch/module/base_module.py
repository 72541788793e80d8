"""BaseModule: the high-level train / score / predict interface.

Counterpart of the JAX package's ``module/base_module.py``: ``fit`` runs
the same batch loop (forward_backward, update, update_metric, the next
batch drawn and prepared, the batch-end callbacks; at each epoch's end
the logged metric, a parameter sync, the epoch-end callbacks, scoring
on ``eval_data`` and the iterator reset), with the JAX package's
checkpoints: ``checkpoint_prefix`` saves every ``checkpoint_period``
epochs (parameters, optimizer states, manifest, and the iterator's
cursor when it has one) and ``resume`` restarts from the newest
checkpoint that verifies, at its epoch and, for a save made within an
epoch, at its batch: an iterator with a cursor (``DataPipeline``) seeks
to the manifest's, one without replays the batches the save had
trained. What the JAX ``fit`` adds beyond that is refused by name until
its ROADMAP item comes: elastic training (``MXNET_ELASTIC_*``, A13),
monitors and ``sparse_row_id_fn`` (A8.6). The SIGTERM grace-window save
waits for A16.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np

from .. import io as _io
from .. import metric as _metric
from ..base import MXNetError
from ..initializer import Uniform
from ..model import BatchEndParam
from ..ndarray.ndarray import NDArray, array

__all__ = ["BaseModule"]


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [a for a in args if not a.endswith(
            ("_weight", "_bias", "_gamma", "_beta"))]
        msg = ("You created Module with Module(..., %s_names=%s) but input "
               "with name '%s' is not found in symbol.list_arguments(). Did "
               "you mean one of:\n\t%s"
               % (typename, str(names), name, "\n\t".join(candidates)))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


def _parse_data_desc(data_names, label_names, data_shapes, label_shapes):
    data_shapes = [x if isinstance(x, _io.DataDesc) else _io.DataDesc(*x)
                   for x in data_shapes]
    _check_names_match(data_names, data_shapes, "data", True)
    if label_shapes is not None:
        label_shapes = [x if isinstance(x, _io.DataDesc)
                        else _io.DataDesc(*x) for x in label_shapes]
        _check_names_match(label_names, label_shapes, "label", False)
    else:
        _check_names_match(label_names, [], "label", False)
    return data_shapes, label_shapes


def _check_names_match(data_names, data_shapes, name, throw):
    actual = [x[0] for x in data_shapes]
    if sorted(data_names) != sorted(actual):
        msg = "Data provided by %s_shapes don't match names specified by " \
              "%s_names (%s vs. %s)" % (name, name, str(data_shapes),
                                        str(data_names))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule(object):
    """Base class for modules (reference: base_module.py:64)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high-level API ----------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Evaluate on ``eval_data`` (reference: base_module.py:210)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Outputs over ``eval_data`` (reference: base_module.py:321)."""
        assert self.binded and self.params_initialized
        if isinstance(eval_data, (NDArray, np.ndarray)):
            if isinstance(eval_data, np.ndarray):
                eval_data = array(eval_data, ctx="cpu")
            self.forward(_io.DataBatch([eval_data]))
            return self.get_outputs()[0]
        if not isinstance(eval_data, _io.DataIter):
            raise ValueError("eval_data must be of type NDArray or DataIter")
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            output_list.append([out[0:out.shape[0] - pad].copy()
                                for out in self.get_outputs()])
        if not output_list:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            merged = [array(np.concatenate([out[i].asnumpy()
                                            for out in output_list]),
                            ctx="cpu")
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None, checkpoint_prefix=None,
            checkpoint_period=1, save_optimizer_states=True, resume=False):
        """The training loop (reference: base_module.py:410; the JAX
        package's loop at module/base_module.py:400-560).

        ``checkpoint_prefix``: save a checkpoint after every
        ``checkpoint_period`` epochs, numbered by completed epochs, with
        the optimizer states when ``save_optimizer_states`` and the
        iterator's ``checkpoint_state`` cursor when it has one.
        ``resume``: start from the newest valid checkpoint under the
        prefix (a torn or corrupt one is skipped): its parameters,
        optimizer states and random state, at its epoch and batch. An
        iterator with ``restore_state`` seeks to the manifest's cursor
        (nothing is drawn on the way); otherwise a checkpoint saved
        within an epoch (``nbatch`` > 0) replays that many batches of the
        iterator untrained. With a seekable or deterministic iterator the
        resumed run then repeats the uninterrupted one's steps. The data
        iterators' ``close()`` runs when the fit ends."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        if checkpoint_prefix is not None and int(checkpoint_period) < 1:
            raise MXNetError("checkpoint_period must be >= 1, got %r"
                             % (checkpoint_period,))
        elastic = sorted(k for k in os.environ
                         if k.startswith("MXNET_ELASTIC_"))
        if elastic:
            raise NotImplementedError("elastic training (%s) is not ported "
                                      "yet (ROADMAP A13)" % ", ".join(elastic))
        if monitor is not None:
            raise NotImplementedError("fit(monitor=...) is not ported yet "
                                      "(ROADMAP A8.6)")
        if sparse_row_id_fn is not None:
            raise NotImplementedError("fit(sparse_row_id_fn=...): sparse "
                                      "arrays are not ported (ROADMAP A8.6)")
        resume_state = None
        skip_nbatch = 0
        io_seeked = False
        if resume:
            if checkpoint_prefix is None:
                raise MXNetError("fit(resume=True) needs checkpoint_prefix "
                                 "to know where the checkpoints live")
            from ..checkpoint import load_latest_valid
            resume_state = load_latest_valid(checkpoint_prefix)
            if resume_state is not None:
                arg_params = resume_state.arg_params
                aux_params = resume_state.aux_params
                allow_missing = False
                begin_epoch = resume_state.epoch
                skip_nbatch = resume_state.nbatch
                # the iterator's cursor, where it has one: a seek, with
                # the shuffle seed; a cursor of another stream falls back
                # to replaying
                cur = resume_state.io_cursor
                if cur and hasattr(train_data, "restore_state"):
                    try:
                        train_data.restore_state(cur)
                        io_seeked = True
                    except MXNetError as e:
                        self.logger.warning(
                            "io cursor in %s-%04d does not fit this "
                            "iterator (%s); replaying the epoch instead",
                            checkpoint_prefix, resume_state.epoch, e)
                self.logger.info("resuming from checkpoint %s-%04d (epoch "
                                 "%d, batch %d%s)", checkpoint_prefix,
                                 resume_state.epoch, resume_state.epoch,
                                 resume_state.nbatch,
                                 ", iterator seeked" if io_seeked else "")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if resume_state is not None:
            # the checkpoint's parameters even where this module's were
            # already live (init_params above keeps live ones)
            self.set_params(resume_state.arg_params, resume_state.aux_params,
                            force_init=True)
            if resume_state.states_fname:
                self.load_optimizer_states(resume_state.states_fname)
            if resume_state.rng is not None:
                from .. import random as _random
                _random.set_state(resume_state.rng)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        try:
            for epoch in range(begin_epoch, num_epoch):
                tic = time.time()
                eval_metric.reset()
                nbatch = 0
                data_iter = iter(train_data)
                if io_seeked:
                    # the iterator is at the cursor already: only the
                    # batch numbering lines up
                    nbatch = skip_nbatch
                else:
                    # a checkpoint saved within this epoch: draw
                    # (untrained) the batches it had trained on
                    for _ in range(skip_nbatch):
                        try:
                            next(data_iter)
                        except StopIteration:
                            break
                        nbatch += 1
                skip_nbatch = 0
                io_seeked = False
                end_of_batch = False
                eval_name_vals = eval_metric.get_name_value()
                try:
                    next_data_batch = next(data_iter)
                except StopIteration:
                    end_of_batch = True
                while not end_of_batch:
                    data_batch = next_data_batch
                    self.forward_backward(data_batch)
                    self.update()
                    self.update_metric(eval_metric, data_batch.label)
                    try:
                        next_data_batch = next(data_iter)
                        self.prepare(next_data_batch)
                    except StopIteration:
                        end_of_batch = True
                    if end_of_batch:
                        eval_name_vals = eval_metric.get_name_value()
                    if batch_end_callback is not None:
                        params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                               eval_metric=eval_metric,
                                               locals=locals())
                        for callback in _as_list(batch_end_callback):
                            callback(params)
                    nbatch += 1
                for name, val in eval_name_vals:
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 time.time() - tic)
                arg_p, aux_p = self.get_params()
                self.set_params(arg_p, aux_p)
                if epoch_end_callback is not None:
                    for callback in _as_list(epoch_end_callback):
                        callback(epoch, self.symbol, arg_p, aux_p)
                if checkpoint_prefix is not None and \
                        (epoch + 1) % int(checkpoint_period) == 0:
                    cursor = getattr(train_data, "checkpoint_state", None)
                    self.save_checkpoint(
                        checkpoint_prefix, epoch + 1, save_optimizer_states,
                        io_cursor=cursor(epoch + 1, 0) if cursor else None)
                if eval_data is not None:
                    res = self.score(eval_data, validation_metric,
                                     score_end_callback=eval_end_callback,
                                     batch_end_callback=eval_batch_end_callback,
                                     epoch=epoch)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                         name, val)
                train_data.reset()
        finally:
            # stop read-ahead threads (close() is restartable, so the same
            # iterator can go to another fit)
            for it in (train_data, eval_data):
                closer = getattr(it, "close", None)
                if callable(closer):
                    closer()

    # -- properties / interface --------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Prepare for a batch (the reference's row-sparse pull; no-op)."""

    def save_params(self, fname):
        """Write the parameters to ``fname`` (``arg:`` / ``aux:`` keys, the
        JAX package's file), atomically."""
        from ..ndarray.utils import save
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        save(fname, save_dict)

    def load_params(self, fname):
        """Set the parameters from a file of :meth:`save_params`."""
        from ..ndarray.utils import load
        arg_params, aux_params = {}, {}
        for k, value in load(fname).items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def install_monitor(self, mon):
        raise NotImplementedError("monitors are not ported yet "
                                  "(ROADMAP A8.6)")

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()
