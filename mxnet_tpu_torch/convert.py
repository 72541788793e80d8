"""Weights between the JAX package and this one.

Transformer weights: the JAX package keeps them as a pytree of arrays
whose layer stacks lead with ``(pp, layers_per_stage)``; this package
keeps them in a :class:`~.parallel.transformer.TransformerParams` with
the stacks flattened to ``(n_layers, ...)``. Module parameters: name ->
array dicts on both sides, with the same names (``Module.get_params()``
there, ``Module.set_params`` / ``fit(arg_params=...)`` here); Gluon
parameters likewise, by name (``gluon_params_from_jax``). The caller
turns the JAX arrays into numpy first (``np.asarray`` /
``NDArray.asnumpy()``), so this module never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import default_device
from .ndarray.ndarray import NDArray
from .parallel.transformer import (TransformerParams, _validate,
                                   expected_shapes, layer_keys)

__all__ = ["params_from_jax", "params_to_numpy", "module_params_from_numpy",
           "module_params_to_numpy", "gluon_params_from_jax",
           "gluon_params_to_numpy"]


def _to_torch(arr, dtype, device):
    """numpy array (float64/32/16 or ml_dtypes bfloat16) -> torch tensor
    of ``dtype`` on ``device``, rounding once, on the host."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:      # e.g. a view of a jax buffer
            arr = arr.copy()
        t = torch.from_numpy(arr)
    return t.to(dtype).to(device)


def params_from_jax(np_params, cfg, device=None, trainable=False):
    """The JAX params pytree (as numpy arrays) -> :class:`TransformerParams`
    in ``cfg.dtype`` on ``device`` (default ``cuda:0``), with gradients
    when ``trainable``.

    Flattens each ``(pp, lps, ...)`` layer stack to ``(n_layers, ...)``
    (an MoE config's ``gate``, ``we1`` and ``we2`` in place of ``w1`` and
    ``w2``); raises :class:`MXNetError` on a missing or extra key or a wrong
    shape (the module checks every shape)."""
    _validate(cfg)
    device = default_device(device)
    shapes = expected_shapes(cfg)
    keys = layer_keys(cfg)
    top = set(k for k in shapes if k not in keys) | {"layers"}
    got = set(np_params)
    if got != top:
        raise MXNetError("params keys: missing %s, extra %s"
                         % (sorted(top - got), sorted(got - top)))
    layers = np_params["layers"]
    got = set(layers)
    if got != set(keys):
        raise MXNetError("params['layers'] keys: missing %s, extra %s"
                         % (sorted(set(keys) - got), sorted(got - set(keys))))
    tensors = {}
    for name, shape in shapes.items():
        arr = np.asarray(layers[name] if name in keys
                         else np_params[name])
        if name in keys:
            if (arr.ndim != len(shape) + 1
                    or arr.shape[0] * arr.shape[1] != cfg.n_layers):
                raise MXNetError(
                    "layers[%r]: shape %s is not (pp, layers_per_stage) "
                    "x %s with pp * layers_per_stage = n_layers = %d"
                    % (name, arr.shape, shape[1:], cfg.n_layers))
            arr = arr.reshape((cfg.n_layers,) + arr.shape[2:])
        tensors[name] = _to_torch(arr, cfg.dtype, device)
    return TransformerParams(cfg, tensors, trainable=trainable)


def params_to_numpy(params, pp=1):
    """:class:`TransformerParams` -> the JAX pytree layout as float32
    numpy arrays, layer stacks reshaped to ``(pp, n_layers // pp, ...)``
    (what ``jax.tree_util.tree_map(jnp.asarray, ...)`` takes back)."""
    def host(t):
        return t.detach().to("cpu", torch.float32).numpy()

    n_layers = params.layers["wq"].shape[0]
    if n_layers % pp:
        raise MXNetError("n_layers=%d must divide by pp=%d"
                         % (n_layers, pp))
    out = {"embed": host(params.embed), "lnf_g": host(params.lnf_g),
           "lnf_b": host(params.lnf_b)}
    if params.pos is not None:
        out["pos"] = host(params.pos)
    out["layers"] = {
        k: host(p).reshape((pp, n_layers // pp) + tuple(p.shape[1:]))
        for k, p in params.layers.items()}
    return out


def module_params_from_numpy(arg_params, aux_params, device=None):
    """Module parameters as name -> numpy dicts (the JAX
    ``Module.get_params()`` through ``.asnumpy()``) -> (arg, aux) dicts of
    float32 NDArrays on ``device`` (default ``cuda:0``), what
    ``Module.set_params`` and ``Module.fit(arg_params=..., aux_params=...)``
    take."""
    device = default_device(device)

    def conv(params):
        return {name: NDArray(_to_torch(arr, torch.float32, device))
                for name, arr in (params or {}).items()}

    return conv(arg_params), conv(aux_params)


def module_params_to_numpy(arg_params, aux_params):
    """(arg, aux) NDArray dicts (``Module.get_params()``) -> name -> numpy
    dicts, what the JAX package's ``nd.array`` takes back."""
    return ({n: a.asnumpy() for n, a in arg_params.items()},
            {n: a.asnumpy() for n, a in aux_params.items()})


def gluon_params_from_jax(jax_params, params, ctx=None):
    """Copy the JAX package's Gluon parameters into the port's, by name.

    ``jax_params`` maps names to values: the JAX ``ParameterDict``
    (``net.collect_params()``, whose Parameters give ``.data().asnumpy()``)
    or name -> numpy arrays. ``params`` is the port's ``ParameterDict``
    or Block (its ``collect_params()``). The two nets are made under the
    same prefix, so the names match; a missing or extra name raises. A
    port parameter without a value is initialized on ``ctx`` (default
    ``cuda:0``) with the array's shape. Returns the port's
    ``ParameterDict``."""
    from .gluon import Block
    from .gluon.parameter import _load_into
    if isinstance(params, Block):
        params = params.collect_params()
    loaded = {}
    for name, value in jax_params.items():
        if not isinstance(value, np.ndarray) and callable(
                getattr(value, "data", None)):
            value = value.data().asnumpy()
        loaded[name] = NDArray(_to_torch(value, torch.float32, "cpu"))
    missing = sorted(set(params.keys()) - set(loaded))
    extra = sorted(set(loaded) - set(params.keys()))
    if missing or extra:
        raise MXNetError("gluon parameters: missing %s, extra %s"
                         % (missing, extra))
    _load_into(dict(params.items()), loaded, "<jax params>", ctx, False,
               False)
    return params


def gluon_params_to_numpy(net):
    """The port's Gluon parameters (a Block or ``ParameterDict``) as
    name -> numpy arrays, what the JAX package's ``Parameter.set_data``
    takes back."""
    params = net.collect_params() if hasattr(net, "collect_params") else net
    return {name: p.data().asnumpy() for name, p in params.items()}
