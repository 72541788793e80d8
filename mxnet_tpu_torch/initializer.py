"""Weight initializers.

Counterpart of the JAX package's ``initializer.py``: the dispatch on
name suffixes (``*_weight`` -> the initializer's rule, ``*_bias``/
``*_beta``/moving means -> 0, ``*_gamma``/moving variances -> 1, an
``__init__`` attr naming another initializer) and ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal`` and ``Xavier``. Arrays are filled in
place on their own device, from :mod:`mxnet_tpu_torch.random`'s
generator for it. Orthogonal, MSRAPrelu, Bilinear, LSTMBias, Load and
Mixed come with ROADMAP A8.6.
"""
from __future__ import annotations

import json

import numpy as np

from .base import MXNetError
from .ndarray import random as _nd_random

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "register", "create"]

_INIT_REGISTRY = {}
_ALIASES = {"zeros": "zero", "ones": "one"}


class InitDesc(str):
    """Name + attrs describing the parameter to initialize
    (reference: initializer.py InitDesc)."""

    def __new__(cls, name, attrs=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        return ret


def register(klass):
    """Register an initializer under its lowercased class name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    key = _ALIASES.get(name.lower(), name.lower())
    if key not in _INIT_REGISTRY:
        raise MXNetError("initializer %r is not ported to mxnet_tpu_torch "
                         "yet (ROADMAP A8.6)" % name)
    return _INIT_REGISTRY[key](**kwargs)


class Initializer(object):
    """Base initializer (reference: python/mxnet/initializer.py:91)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """JSON ``[name, kwargs]``, what a variable's ``init`` attr holds."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        """Initialize ``arr`` (an NDArray, in place) for the parameter
        ``desc`` names; dispatches on its ``__init__`` attr, then on the
        name's suffix."""
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        init = desc.attrs.get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr)
        elif desc.endswith("weight"):
            self._init_weight(desc, arr)
        elif desc.endswith("bias") or desc.endswith("beta"):
            self._init_zero(desc, arr)
        elif desc.endswith("gamma"):
            self._init_one(desc, arr)
        elif desc.endswith("running_mean") or desc.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif desc.endswith("running_var") or desc.endswith("moving_var"):
            self._init_one(desc, arr)
        elif (desc.endswith("moving_inv_var") or desc.endswith("moving_avg")
              or desc.endswith("min") or desc.endswith("max")):
            self._init_zero(desc, arr)
        else:
            raise ValueError(
                "Unknown initialization pattern for %s. Default "
                "initialization is limited to \"weight\", \"bias\", "
                "\"gamma\" (1.0) and \"beta\" (0.0); use "
                "sym.Variable(init=...) to set another" % desc)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")

    def __eq__(self, other):
        return (isinstance(other, Initializer) and type(self) is type(other)
                and self._kwargs == other._kwargs)

    __hash__ = object.__hash__


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    """U(-scale, scale) (reference: initializer.py Uniform)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        _nd_random.uniform(-self.scale, self.scale, out=arr)


@register
class Normal(Initializer):
    """N(0, sigma^2) (reference: initializer.py Normal)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        _nd_random.normal(0, self.sigma, out=arr)


@register
class Xavier(Initializer):
    """Xavier/Glorot (reference: initializer.py Xavier): scale
    sqrt(magnitude / factor), factor the fan in, the fan out or their
    mean, each counted over the kernel's spatial size."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier initializer cannot be applied to vector "
                             "%s. It requires at least 2D." % name)
        hw_scale = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise ValueError("Incorrect factor type")
        scale = float(np.sqrt(self.magnitude / factor))
        if self.rnd_type == "uniform":
            _nd_random.uniform(-scale, scale, out=arr)
        elif self.rnd_type == "gaussian":
            _nd_random.normal(0, scale, out=arr)
        else:
            raise ValueError("Unknown random type")
