"""Gluon ``Parameter`` and ``ParameterDict``.

Counterpart of the JAX package's ``gluon/parameter.py`` (reference:
python/mxnet/gluon/parameter.py): a Parameter owns one NDArray on one
device, with its gradient buffer (``autograd.mark_variables``), its
``grad_req``, ``lr_mult`` / ``wd_mult`` and its initializer; a shape with
0 entries is completed from the first batch when ``allow_deferred_init``
(the layers' ``infer_shape``). ``initialize`` puts the value on
``cuda:0`` unless ``ctx`` names another device (``cpu()`` for the host).
Values are written in place (``set_data``), so the tensor the autograd
graph and the optimizer kernel see stays the same one.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..base import MXNetError
from ..context import default_device
from .. import initializer as init_mod
from ..ndarray.ndarray import NDArray, to_torch_dtype, zeros

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """A parameter's initialization waits for its shape (reference:
    gluon/parameter.py DeferredInitializationError)."""


def _dtype(dtype):
    """numpy dtype of ``dtype``; bfloat16, which numpy has not, as its
    name (what ``NDArray.dtype`` gives)."""
    if dtype is torch.bfloat16 or str(dtype) == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype)


class Parameter(object):
    """A Block parameter (reference: gluon/parameter.py:37)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if stype != "default":
            raise MXNetError("sparse parameters are not ported to "
                             "mxnet_tpu_torch (ROADMAP A15)")
        # grad_stype is accepted and the gradient stays dense, as in the
        # JAX package
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = _dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._grad_req = grad_req if differentiable else "null"
        self._data = None
        self._deferred_init = None      # (init, ctx, default_init)

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self.shape, self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be write/add/null, got %r" % req)
        self._grad_req = req
        if self._data is not None:
            from .. import autograd
            autograd.mark_variables([self._data], grad_reqs=req)

    @property
    def stype(self):
        return "default"

    # -- initialization ----------------------------------------------------
    def _shape_complete(self):
        return (self.shape is not None and len(self.shape) > 0
                and all(s > 0 for s in self.shape))

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Initialize the value and its gradient buffer on ``ctx``
        (default ``cuda:0``; a list takes its first device)."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            if len(ctx) > 1:
                raise MXNetError("Parameter %s: one device per parameter; "
                                 "several contexts come with ROADMAP "
                                 "A12.6 / A13" % self.name)
            ctx = ctx[0] if ctx else None
        ctx = default_device(ctx)
        if not self._shape_complete():
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise ValueError(
                "Cannot initialize Parameter %s because it has invalid "
                "shape %s. Specify in_units/in_channels etc. or set "
                "allow_deferred_init." % (self.name, self.shape))
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init):
        arr = zeros(self.shape, ctx=ctx, dtype=self.dtype)
        # the parameter's own initializer sets it whatever its name (PReLU's
        # alpha too), the default one by the name's suffix (reference:
        # gluon/parameter.py _finish_deferred_init)
        explicit = init or self.init
        if isinstance(explicit, str):
            explicit = init_mod.create(explicit)
        if isinstance(default_init, str):
            default_init = init_mod.create(default_init)
        default_init(init_mod.InitDesc(
            self.name, {"__init__": explicit} if explicit else None), arr)
        self._data = arr
        self._deferred_init = None
        if self._grad_req != "null":
            from .. import autograd
            autograd.mark_variables([self._data], grad_reqs=self._grad_req)

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not self._shape_complete():
            raise DeferredInitializationError(
                "Parameter %s has unknown shape %s and shape inference "
                "did not complete it." % (self.name, self.shape))
        self._finish_init(*self._deferred_init)

    def _set_shape_from(self, shape):
        """Complete deferred dims (0 entries) from an inferred shape."""
        shape = tuple(int(s) for s in shape)
        if self.shape is None or len(self.shape) == 0:
            self.shape = shape
            return
        if len(shape) != len(self.shape) or any(
                a > 0 and a != b for a, b in zip(self.shape, shape)):
            raise ValueError("inferred shape %s incompatible with declared "
                             "%s for %s" % (shape, self.shape, self.name))
        self.shape = shape

    # -- access ------------------------------------------------------------
    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                "Parameter %s has not been initialized yet because "
                "initialization was deferred. Run a forward pass first."
                % self.name)
        raise RuntimeError(
            "Parameter %s has not been initialized. You should initialize "
            "parameters with Block.initialize()." % self.name)

    def data(self, ctx=None):
        self._check_initialized()
        return self._data

    def grad(self, ctx=None):
        self._check_initialized()
        if self._grad_req == "null":
            raise RuntimeError(
                "Cannot get gradient array for Parameter %s because "
                "grad_req='null'" % self.name)
        return self._data.grad

    def zero_grad(self):
        if self._data is not None and self._data.grad is not None:
            with torch.no_grad():
                self._data.grad._data.zero_()

    def set_data(self, data):
        """Write ``data`` into the value, in place (a deferred parameter
        takes its shape from it)."""
        if self._data is None:
            if self._deferred_init is None:
                raise RuntimeError("Parameter %s has not been initialized"
                                   % self.name)
            self._set_shape_from(data.shape)
            self._finish_deferred_init()
        src = data._data if isinstance(data, NDArray) \
            else torch.as_tensor(np.asarray(data))
        if tuple(src.shape) != self._data.shape:
            raise MXNetError("Parameter %s: set_data of shape %s into %s"
                             % (self.name, tuple(src.shape),
                                self._data.shape))
        with torch.no_grad():
            self._data._data.copy_(src.detach())

    def var(self):
        """This parameter as a Symbol variable: its name, shape and type
        (reference: parameter.py var). An op that takes it in an
        auxiliary slot (BatchNorm's moving statistics, ``grad_req``
        "null") marks it an auxiliary state."""
        from ..symbol import var as sym_var
        return sym_var(self.name, shape=self.shape, dtype=self.dtype)

    def cast(self, dtype):
        self.dtype = _dtype(dtype)
        if self._data is not None:
            self._data = NDArray(self._data._data.detach().to(
                to_torch_dtype(dtype)))
            if self._grad_req != "null":
                from .. import autograd
                autograd.mark_variables([self._data],
                                        grad_reqs=self._grad_req)


class ParameterDict(object):
    """A prefix-scoped dictionary of Parameters (reference:
    gluon/parameter.py ParameterDict)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        s = "\n".join("  %r" % p for p in self._params.values())
        return "ParameterDict %r (\n%s\n)" % (self._prefix, s)

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, key):
        return key in self._params

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        """Create or retrieve the parameter ``prefix + name``, merging
        attributes (reference: parameter.py get)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            if k == "shape" and v is not None:
                v = tuple(v)
                if param.shape is not None and len(v) == len(param.shape):
                    param.shape = tuple(a if a > 0 else b
                                        for a, b in zip(param.shape, v))
                elif param.shape is None:
                    param.shape = v
            elif k == "dtype" and v is not None:
                param.dtype = _dtype(v)
            elif v is not None and getattr(param, k, None) is None:
                setattr(param, k, v)
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(
                    "Cannot update because parameter %r exists with a "
                    "different Parameter object" % k)
            self._params[k] = v

    # -- bulk operations ---------------------------------------------------
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default ``cuda:0``);
        ``init`` is the default initializer of those without their
        own."""
        if init is None:
            init = init_mod.Uniform()
        for p in self._params.values():
            p.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def setattr(self, name, value):
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Save every value, keyed by name less ``strip_prefix``, in the
        reference's binary ``.params`` layout."""
        from ..ndarray import utils as nd_utils
        out = {}
        for p in self._params.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            out[name] = p.data()
        nd_utils.save(filename, out, format="mxnet")

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..ndarray import utils as nd_utils
        loaded = {restore_prefix + k: v
                  for k, v in nd_utils.load(filename).items()}
        _load_into(self._params, loaded, filename, ctx, allow_missing,
                   ignore_extra)


def _load_into(params, loaded, filename, ctx, allow_missing, ignore_extra):
    """Copy ``loaded`` (name -> NDArray) into ``params`` (name ->
    Parameter), initializing a parameter that has no value yet."""
    if not allow_missing:
        for name in params:
            if name not in loaded:
                raise IOError("Parameter %s is missing in file %s"
                              % (name, filename))
    for name, arr in loaded.items():
        if name not in params:
            if not ignore_extra:
                raise IOError("Parameter %s loaded from %s is not present "
                              "in this block" % (name, filename))
            continue
        p = params[name]
        if p._data is None:
            p._set_shape_from(arr.shape)
            if p._deferred_init is None:
                p.initialize(ctx=ctx, default_init=init_mod.Zero())
            else:
                p._finish_deferred_init()
        p.set_data(arr)
