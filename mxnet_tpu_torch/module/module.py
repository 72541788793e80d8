"""Module: a symbol, one bound executor and the optimizer state.

Counterpart of the JAX package's ``module/module.py`` on one device.
``update()`` runs the fused train step when it may (the default): the
batch that ``forward_backward`` deferred goes through
``Executor.train_step`` with the optimizer's fused rule, so the whole
parameter list is updated by one kernel launch. Under
``MXNET_FUSED_STEP=0``, with ``inputs_need_grad``, or when
``get_outputs()`` is read before ``update()``, the unfused path runs
instead: forward, backward, then the updater per parameter (the same
rule on a list of one). With ``multi_precision`` a float16 weight updates
on its float32 master copy (its state ``(state, weight32)``) in that one
launch; the JAX ``Module`` takes its unfused path then, which computes
the same function.

Checkpoints are the JAX package's files, which each package loads:
``save_checkpoint`` writes the symbol, the parameters, optionally the
optimizer states (``save_optimizer_states``: a pickle of ``{index:
numpy state}``) and a checksum manifest, each file atomically; ``load``
reads them back.

Refused until their ROADMAP items: more than one context, kvstores and
gradient compression (A8.3/A13), monitors (A8.6); ``bind(shared_module=)``
is refused as in the JAX
package (``BucketingModule`` aliases its buckets' arrays instead).
"""
from __future__ import annotations

import functools
import logging
import warnings

from .. import optimizer as opt
from ..context import default_device
from ..executor import _copy_into
from ..initializer import InitDesc, Uniform
from ..model import (_create_kvstore, _update_params, fused_step_supported,
                     load_checkpoint, save_checkpoint)
from .base_module import (BaseModule, _check_input_names, _parse_data_desc)

__all__ = ["Module"]


class Module(BaseModule):
    """Symbolic training module (reference: module.py:59). ``context``
    is one device, ``cuda:0`` by default (raising without a card); pass
    ``cpu()`` to train on the host."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise NotImplementedError(
                    "Module over %d contexts: data-parallel training is not "
                    "ported yet (ROADMAP A8.3 / A13)" % len(context))
            context = context[0]
        if group2ctxs is not None:
            raise NotImplementedError("group2ctxs model parallelism is not "
                                      "ported yet (ROADMAP A13)")
        if compression_params:
            raise NotImplementedError("gradient compression is not ported "
                                      "yet (ROADMAP A13)")
        self._context = [default_device(context)]
        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed_param_names = (list(fixed_param_names)
                             if fixed_param_names is not None else [])
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)
        input_names = data_names + label_names + state_names
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._fused_batch = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of checkpoint ``epoch`` under ``prefix`` (reference:
        module.py load): its symbol and parameters, bound at ``bind``;
        with ``load_optimizer_states`` the optimizer states too, loaded
        by ``init_optimizer``. ``kwargs`` go to the constructor."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        nbatch=0, io_cursor=None):
        """Write checkpoint ``epoch``: ``prefix-symbol.json``,
        ``prefix-%04d.params``, with ``save_optimizer_states`` also
        ``prefix-%04d.states``, and the manifest (checksums, ``nbatch``
        > 0 for a save within an epoch, the random state); every file
        atomically (reference: module.py save_checkpoint)."""
        state_name = None
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux, nbatch=nbatch,
                        states_fname=state_name, io_cursor=io_cursor)
        logging.info("Saved checkpoint to \"%s-%04d.params\"", prefix,
                     epoch)

    # -- properties --------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    # -- parameters --------------------------------------------------------
    def get_params(self):
        """(arg_params, aux_params): copies of the bound values."""
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Initialize the bound parameters, in place: from ``arg_params``
        / ``aux_params`` where given, else with ``initializer``
        (reference: module.py:259)."""
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init="
                          "False. init_params call ignored.", stacklevel=2)
            return
        assert self.binded, "call bind before initializing the parameters"
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                if cache[name] is not arr:
                    _copy_into(arr, cache[name], name)
                return
            if cache is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % name)
            if initializer is not None:
                initializer(InitDesc(name, attrs.get(name)), arr)

        for name in self._param_names:
            _impl(name, self._exec.arg_dict[name], arg_params)
        for name in self._aux_names:
            _impl(name, self._exec.aux_dict[name], aux_params)
        self.params_initialized = True
        self._params_dirty = True
        self._sync_params_from_devices()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init="
                          "False. set_params call ignored.", stacklevel=2)
            return
        self._exec.copy_params_from(arg_params or {}, aux_params or {},
                                    allow_extra_params=True)
        self.params_initialized = True
        self._params_dirty = True

    def _sync_params_from_devices(self):
        self._arg_params = {n: self._exec.arg_dict[n].copy()
                            for n in self._param_names}
        self._aux_params = {n: self._exec.aux_dict[n].copy()
                            for n in self._aux_names}
        self._params_dirty = False

    # -- binding -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Allocate the executor's arrays (reference: module.py:364)."""
        if force_rebind:
            self._exec = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            # as the JAX package (module/module.py:256): buckets share
            # memory through BucketingModule's aliased arrays instead
            raise NotImplementedError(
                "shared_module is not supported; BucketingModule shares "
                "the parameters of its buckets")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self._data_names, self._label_names, data_shapes, label_shapes)
        shape_kwargs = {d.name: d.shape for d in self._data_shapes}
        type_dict = {d.name: d.dtype for d in self._data_shapes}
        for l in self._label_shapes or ():
            shape_kwargs[l.name] = l.shape
            type_dict[l.name] = l.dtype
        reqs = {}
        for name in self._symbol.list_arguments():
            if name in self._param_names:
                reqs[name] = ("null" if name in self._fixed_param_names
                              or not for_training else grad_req)
            elif name in self._data_names:
                reqs[name] = grad_req if inputs_need_grad else "null"
            else:
                reqs[name] = "null"
        self._exec = self._symbol.simple_bind(
            self._context[0], grad_req=reqs, type_dict=type_dict,
            **shape_kwargs)
        self.binded = True
        if self.params_initialized and self._arg_params is not None:
            self._exec.copy_params_from(self._arg_params, self._aux_params,
                                        allow_extra_params=True)

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Install the optimizer (reference: module.py:474); rescale_grad
        defaults to 1 / batch size."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        rescale_grad = 1.0 / self._data_shapes[0].shape[0]
        idx2name = dict(enumerate(self._param_names))
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            if not isinstance(optimizer, opt.Optimizer):
                raise TypeError("optimizer must be a name or an Optimizer")
            if optimizer.rescale_grad != rescale_grad:
                warnings.warn(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size (%s vs."
                    " %s). Is this intended?" % (optimizer.rescale_grad,
                                                 rescale_grad), stacklevel=2)
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name.copy()
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Use ``shared_module``'s optimizer, kvstore and updater (with its
        states), as the buckets of a ``BucketingModule`` do (reference:
        module.py borrow_optimizer)."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # -- computation -------------------------------------------------------
    def _build_feed(self, data_batch):
        feed = dict(zip(self._data_names, data_batch.data))
        if self._label_shapes and data_batch.label:
            feed.update(zip(self._label_names, data_batch.label))
        return feed

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._exec.forward(is_train=is_train, **self._build_feed(data_batch))
        self._params_dirty = True

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def _fused_step_ok(self):
        """Whether forward + backward + update may run as one train step
        (Executor.train_step)."""
        if not (self.binded and self.params_initialized
                and self.optimizer_initialized):
            return False
        if not fused_step_supported(self._optimizer, self._kvstore,
                                    self._update_on_kvstore):
            return False
        if self.inputs_need_grad:
            return False
        return all(self._exec._grad_req.get(n, "null") in ("write", "null")
                   for n in self._param_names)

    def forward_backward(self, data_batch):
        """Forward + backward; on the fused path the batch is deferred to
        the following ``update()``, which runs the whole step (outputs
        exist after it; ``grad_dict`` is not written)."""
        if self._fused_step_ok():
            self._fused_batch = data_batch
            return
        self._fused_batch = None
        super().forward_backward(data_batch)

    def _run_fused_step(self, data_batch):
        exe = self._exec
        update_names, states, hyper, masters = [], {}, {}, []
        for i, name in enumerate(self._param_names):
            if exe._grad_req.get(name, "null") == "null":
                continue
            update_names.append(name)
            weight = exe.arg_dict[name]
            state = self._updater.ensure_state(i, weight)
            master = None
            if self._optimizer._mastered(weight):
                state, master = state
                master = master._data
            masters.append(master)
            states[name] = opt.fused_state_arrays(state)
            hyper[name] = self._optimizer.fused_hyper(i)
        rule = self._optimizer.fused_rule()
        if any(m is not None for m in masters):
            rule = functools.partial(rule, masters=masters)
        exe.train_step(rule, update_names, states, hyper,
                       feed=self._build_feed(data_batch))

    def update(self):
        """Apply the optimizer (reference: module.py:644). With a deferred
        batch pending, run the whole fused step instead."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        data_batch, self._fused_batch = self._fused_batch, None
        if data_batch is not None:
            if self._fused_step_ok():
                self._run_fused_step(data_batch)
                return
            self.forward(data_batch, is_train=True)
            self.backward()
        _update_params([self._exec.arg_dict[n] for n in self._param_names],
                       [self._exec.grad_dict[n] for n in self._param_names],
                       updater=self._updater)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        if self._fused_batch is not None:
            # outputs read between forward_backward() and update(): replay
            # the deferred batch unfused (grad_dict written; the following
            # update() takes the per-parameter path)
            batch, self._fused_batch = self._fused_batch, None
            self.forward(batch, is_train=True)
            self.backward()
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    def save_optimizer_states(self, fname):
        """Write the updater's states to ``fname``, atomically."""
        assert self.optimizer_initialized
        from ..checkpoint import atomic_writer
        with atomic_writer(fname) as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Load the updater's states from ``fname`` (either package's)."""
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
