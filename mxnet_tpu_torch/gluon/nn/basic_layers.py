"""Gluon basic layers.

Counterpart of the JAX package's ``gluon/nn/basic_layers.py`` (reference:
python/mxnet/gluon/nn/basic_layers.py, activations.py): ``Sequential``,
``HybridSequential``, ``Dense``, ``Activation``, ``BatchNorm``,
``Flatten``, ``Lambda``, ``HybridLambda`` and ``Swish``, each over the op
registry, with the JAX package's parameter names and defaults.
``BatchNorm`` normalizes with the batch statistics and updates its
running statistics in place while ``autograd.is_training()``, and uses
the running statistics otherwise; traced (``F`` the ``symbol``
namespace) it is one ``BatchNorm`` node either way. ``Dropout``,
``Embedding``, ``InstanceNorm``, ``LayerNorm`` and the ``LeakyReLU``
family (``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``) call the
registry's ops of the same names. Every layer here traces under
``hybridize()`` and ``export``.
"""
from __future__ import annotations

import math

import torch

from ...base import MXNetError
from ... import initializer as init
from ..block import Block, HybridBlock, _is_symbol

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "InstanceNorm", "LayerNorm", "Flatten", "Lambda",
           "HybridLambda", "Activation", "LeakyReLU", "PReLU", "ELU", "SELU",
           "Swish", "GELU"]


class _Stack(object):
    """The container methods Sequential and HybridSequential share."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __getitem__(self, key):
        layers = list(self._children.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers[key])
            return net
        return layers[key]

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_Stack, Block):
    """Blocks run one after another (reference: basic_layers.py
    Sequential)."""

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x, *args)
            args = []
            if isinstance(x, (tuple, list)) and len(x) == 1:
                x = x[0]
        return x


class HybridSequential(_Stack, HybridBlock):
    """HybridBlocks run one after another (reference: basic_layers.py
    HybridSequential)."""

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x


def _init(i):
    """An initializer argument (str / Initializer / None)."""
    if i is None or isinstance(i, init.Initializer):
        return i
    if isinstance(i, str):
        return init.create(i.lower())
    raise TypeError("invalid initializer %r" % (i,))


class Dense(HybridBlock):
    """``act(dot(x, w.T) + b)`` (reference: basic_layers.py Dense; op
    FullyConnected)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super(Dense, self).__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=_init(weight_initializer), allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,), dtype=dtype,
                init=_init(bias_initializer), allow_deferred_init=True) \
                if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def infer_shape(self, x, *args):
        in_units = x.shape[-1] if not self._flatten else \
            math.prod(x.shape[1:])
        self.weight._set_shape_from((self._units, in_units))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        shape = self.weight.shape
        return "Dense(%s -> %s, %s)" % (
            shape[1] if shape and len(shape) > 1 else None, shape[0],
            "linear" if self.act is None else self.act._act_type)


class BatchNorm(HybridBlock):
    """Batch normalization with running statistics (reference:
    basic_layers.py BatchNorm; op BatchNorm). While
    ``autograd.is_training()`` it normalizes with the batch's mean and
    biased variance and updates the running statistics in place,
    ``running = running * momentum + batch * (1 - momentum)``; otherwise
    it normalizes with the running statistics."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super(BatchNorm, self).__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init(gamma_initializer),
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init(beta_initializer),
                allow_deferred_init=True)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=_init(running_mean_initializer),
                allow_deferred_init=True, differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=_init(running_variance_initializer),
                allow_deferred_init=True, differentiable=False)

    def cast(self, dtype):
        """Cast the block; gamma, beta and the running statistics stay
        float32 under float16 and bfloat16 (reference MXNet's policy,
        the JAX package's BatchNorm.cast)."""
        if str(dtype) in ("float16", "bfloat16") or dtype in (
                torch.float16, torch.bfloat16) or (
                isinstance(dtype, type) and dtype.__name__ == "float16"):
            dtype = "float32"
        super(BatchNorm, self).cast(dtype)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p._set_shape_from((c,))

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        from ... import autograd
        if _is_symbol(x) or not autograd.is_training() or \
                self._kwargs["use_global_stats"]:
            # traced, one BatchNorm node: the graph evaluator gives its
            # batch statistics, and the CachedOp updates the running ones
            return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                               **self._kwargs)
        out, mean, var = F.BatchNorm(x, gamma, beta, running_mean,
                                     running_var, output_mean_var=True,
                                     **self._kwargs)
        mom = self._kwargs["momentum"]
        with torch.no_grad():
            for run, batch in ((running_mean, mean), (running_var, var)):
                r = run._data
                r.copy_(r * mom + batch._data.to(r.dtype) * (1 - mom))
        return out

    def __repr__(self):
        in_channels = self.gamma.shape[0] if self.gamma.shape else None
        return "BatchNorm(axis=%s, eps=%s, momentum=%s, in_channels=%s)" % (
            self._kwargs["axis"], self._kwargs["eps"],
            self._kwargs["momentum"], in_channels)


class Flatten(HybridBlock):
    """Collapse all but the batch axis (reference: basic_layers.py
    Flatten)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    """A function as a Block (reference: basic_layers.py Lambda); a
    string names an ``nd`` function."""

    def __init__(self, function, prefix=None):
        super(Lambda, self).__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd
            if not hasattr(nd, function):
                raise MXNetError("function %r not found in ndarray"
                                 % function)
            self._func_impl = getattr(nd, function)
            self._func_name = function
        else:
            self._func_impl = function
            self._func_name = getattr(function, "__name__", "custom")

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "Lambda(%s)" % self._func_name


class HybridLambda(HybridBlock):
    """``function(F, *args)`` as a HybridBlock (reference:
    basic_layers.py HybridLambda); a string names an ``F`` function."""

    def __init__(self, function, prefix=None):
        super(HybridLambda, self).__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_name = function
            self._func = lambda F, *args: getattr(F, function)(*args)
        else:
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return "HybridLambda(%s)" % self._func_name


class Activation(HybridBlock):
    """``act_type`` applied elementwise (reference: activations.py)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super(Activation, self).__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return "Activation(%s)" % self._act_type


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)`` (reference: activations.py Swish)."""

    def __init__(self, beta=1.0, **kwargs):
        super(Swish, self).__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class Dropout(HybridBlock):
    """Each value zeroed with probability ``rate`` while
    ``autograd.is_training()`` and the kept ones scaled by
    ``1 / (1 - rate)``; with ``axes`` one draw is shared along those axes
    (reference: basic_layers.py Dropout; op Dropout, drawn from the
    port's generator of the data's device)."""

    def __init__(self, rate, axes=(), **kwargs):
        super(Dropout, self).__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate <= 0:
            return x
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return "Dropout(p = %s, axes=%s)" % (self._rate, self._axes)


class Embedding(HybridBlock):
    """Rows of ``weight`` (input_dim, output_dim) picked by index
    (reference: basic_layers.py Embedding; op Embedding). As in the JAX
    package, ``sparse_grad=True`` asks for a ``row_sparse`` gradient and
    gets a dense one: sparse storage is ROADMAP A15."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super(Embedding, self).__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._dtype = dtype
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=_init(weight_initializer),
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim, dtype=self._dtype)

    def __repr__(self):
        return "Embedding(%d -> %d, %s)" % (
            self._input_dim, self._output_dim, self._dtype)


class _Norm(HybridBlock):
    """gamma and beta of a normalization over ``in_channels``."""

    def __init__(self, axis, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, **kwargs):
        super(_Norm, self).__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init(gamma_initializer),
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init(beta_initializer),
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        self.gamma._set_shape_from((x.shape[self._axis],))
        self.beta._set_shape_from((x.shape[self._axis],))

    def __repr__(self):
        return "%s(axis=%s, eps=%s)" % (type(self).__name__, self._axis,
                                        self._epsilon)


class InstanceNorm(_Norm):
    """Each (sample, channel) normalized over its other axes (reference:
    basic_layers.py InstanceNorm; op InstanceNorm), ``axis`` the channel
    axis (the JAX package sizes gamma by axis 1 whatever ``axis``, and
    then fails for another axis of another size)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super(InstanceNorm, self).__init__(
            axis, epsilon, center, scale, beta_initializer,
            gamma_initializer, in_channels, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        x = F.swapaxes(x, dim1=1, dim2=self._axis)
        return F.swapaxes(F.InstanceNorm(x, gamma, beta, eps=self._epsilon),
                          dim1=1, dim2=self._axis)


class LayerNorm(_Norm):
    """Each position normalized over ``axis`` (reference: basic_layers.py
    LayerNorm; op LayerNorm)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super(LayerNorm, self).__init__(
            axis, epsilon, center, scale, beta_initializer,
            gamma_initializer, in_channels, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class LeakyReLU(HybridBlock):
    """``x`` above 0, ``alpha * x`` below (reference: activations.py
    LeakyReLU; op LeakyReLU, act_type "leaky")."""

    def __init__(self, alpha, **kwargs):
        super(LeakyReLU, self).__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return "LeakyReLU(%s)" % self._alpha


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope ``alpha`` of shape (1,), 0.25 at
    the start (reference: activations.py PReLU)."""

    def __init__(self, alpha_initializer=None, **kwargs):
        super(PReLU, self).__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,),
                init=_init(alpha_initializer) or init.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    """``alpha * (exp(x) - 1)`` below 0 (reference: activations.py
    ELU)."""

    def __init__(self, alpha=1.0, **kwargs):
        super(ELU, self).__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU (reference: activations.py SELU)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """Gaussian error linear unit (reference: activations.py GELU)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")
