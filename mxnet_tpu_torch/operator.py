"""Custom Python operators: ``CustomOp``, ``CustomOpProp``, ``register``.

Counterpart of the JAX package's ``operator.py`` (reference:
python/mxnet/operator.py:76-191, src/operator/custom/custom-inl.h). A
registered prop becomes the registry op ``Custom``, so one definition
serves ``nd.Custom`` (eager, under autograd) and ``sym.Custom`` (the
port's symbol graph and executor) alike: the op runs the prop's operator
inside a ``torch.autograd.Function`` whose forward calls the operator's
``forward`` with NDArrays, and whose backward calls its ``backward``
with the head gradients (``out_grad``, ones where an output gets none),
the inputs and the forward's outputs (``out_data``). On ``meta`` tensors
(the symbol's shape inference) the op answers from the prop's
``infer_shape`` / ``infer_type`` without running the operator.

The JAX package's ``make_custom_jax_fn`` (``jax.pure_callback`` inside
``jax.jit``) has no counterpart: PyTorch runs eagerly, and the graph
evaluator calls the same op.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop"]

_CUSTOM_REGISTRY = {}


class CustomOp(object):
    """Base class for user ops (reference: operator.py CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` honoring the request type."""
        if req in ("null", None):
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise MXNetError("unknown req %r" % req)


class CustomOpProp(object):
    """Op metadata provider (reference: operator.py CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


def register(reg_name):
    """Decorator registering a CustomOpProp subclass under ``reg_name``
    (reference: operator.py register)."""
    def _wrap(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls
    return _wrap


def get_prop(op_type, **kwargs):
    try:
        cls = _CUSTOM_REGISTRY[op_type]
    except KeyError:
        raise MXNetError("custom op %r is not registered" % op_type) \
            from None
    return cls(**kwargs)


class _CustomFunction(torch.autograd.Function):
    """The prop's operator as one autograd node."""

    @staticmethod
    def forward(ctx, prop, is_train, *tensors):
        from .ndarray.ndarray import NDArray, to_torch_dtype
        shapes = [tuple(t.shape) for t in tensors]
        dtypes = [NDArray(t).dtype for t in tensors]
        _, out_shapes, _ = prop.infer_shape(list(shapes))
        _, out_types, _ = prop.infer_type(list(dtypes))
        dev = tensors[0].device if tensors else torch.device("cpu")
        op = prop.create_operator(dev, shapes, dtypes)
        ins = [NDArray(t) for t in tensors]
        outs = [NDArray(torch.zeros(tuple(s), dtype=to_torch_dtype(d),
                                    device=dev))
                for s, d in zip(out_shapes, out_types)]
        op.forward(is_train=is_train, req=["write"] * len(outs),
                   in_data=ins, out_data=outs, aux=[])
        ctx.op, ctx.ins, ctx.outs = op, ins, outs
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        out_grad = [NDArray(torch.ones_like(o._data) if g is None else g)
                    for g, o in zip(grads, ctx.outs)]
        in_grad = [NDArray(torch.zeros_like(x._data)) for x in ctx.ins]
        ctx.op.backward(req=["write"] * len(in_grad), out_grad=out_grad,
                        in_data=ctx.ins, out_data=ctx.outs,
                        in_grad=in_grad, aux=[])
        return (None, None) + tuple(g._data for g in in_grad)


def _custom_op_fn(*tensors, op_type=None, train_mode=False, **kwargs):
    """The registry op ``Custom`` (reference: sym.Custom / nd.Custom)."""
    from . import autograd
    from .ndarray.ndarray import NDArray, to_torch_dtype
    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    prop = get_prop(op_type, **kwargs)
    if tensors and tensors[0].device.type == "meta":
        _, out_shapes, _ = prop.infer_shape([tuple(t.shape)
                                             for t in tensors])
        _, out_types, _ = prop.infer_type([NDArray(t).dtype
                                           for t in tensors])
        outs = tuple(torch.empty(tuple(s), dtype=to_torch_dtype(d),
                                 device="meta")
                     for s, d in zip(out_shapes, out_types))
    else:
        with autograd.pause(train_mode):
            outs = _CustomFunction.apply(prop, bool(train_mode), *tensors)
    return outs[0] if len(outs) == 1 else outs


def _custom_num_outputs(attrs):
    attrs = dict(attrs)
    prop = get_prop(attrs.pop("op_type"),
                    **{k: v for k, v in attrs.items()
                       if k != "train_mode" and not k.startswith("__")})
    return len(prop.list_outputs())


def _register_custom_op():
    from .ndarray import register as nd_register
    from .ops.registry import register as reg_op
    from .symbol import register as sym_register
    reg_op("Custom", num_outputs=_custom_num_outputs,
           attr_defaults={"op_type": None, "train_mode": False})(
        _custom_op_fn)
    nd_register.populate("mxnet_tpu_torch.ndarray")
    sym_register.populate("mxnet_tpu_torch.symbol")


_register_custom_op()
