"""NDArray: a thin wrapper over one :class:`torch.Tensor`.

Counterpart of the JAX package's ``ndarray/ndarray.py``: shape, dtype,
context, host copies, ``copy``/``copyto``/``astype``, slicing and
assignment; the arithmetic, comparison and in-place operators, the
methods (``reshape``, ``sum``, ``mean``, ...) and the generated
``nd.<op>`` functions (``register.py``), all through :func:`invoke_op`
and the op registry; and autograd (``attach_grad``, ``.grad``,
``backward``; ``autograd.py`` maps the tape onto ``torch.autograd``).
``_data`` is the backing tensor and ``_set_data`` rebinds it.

Unlike a JAX array a tensor can be written in place: whole-array
assignment (``arr[:] = v``) fills the existing tensor, an in-place
operator (``x += y``) outside ``autograd.record()`` updates it, and the
optimizer kernels write parameters in place.

Creation helpers (``array``, ``zeros``, ``ones``, ``empty``) put the
array on ``cuda:0`` unless the caller passes ``ctx`` (``cpu()`` for the
host); without a card and without ``ctx`` they raise.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, default_device

__all__ = ["NDArray", "array", "zeros", "ones", "empty", "full", "arange",
           "concat", "stack", "waitall", "invoke_op", "to_torch_dtype"]

_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool,
    np.dtype(np.int16): torch.int16, np.dtype(np.uint32): torch.uint32,
}
_NP_DTYPES = {t: n for n, t in _DTYPES.items()}


def to_torch_dtype(dtype):
    """numpy dtype / name / torch dtype -> torch dtype (default float32)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":    # the name, or ml_dtypes' numpy type
        return torch.bfloat16
    try:
        return _DTYPES[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise MXNetError("unsupported dtype %r" % (dtype,)) from None


def _device(ctx):
    """Where a new array goes: ``ctx``, else ``cuda:0``."""
    return default_device(ctx)


def invoke_op(name, inputs, attrs=None, out=None):
    """Apply the registered op ``name`` to ``inputs`` (NDArrays, or
    tensors) with ``attrs``; the analog of the reference's
    ``MXImperativeInvokeEx``. Ops with a ``train_mode`` attr get
    ``autograd.is_training()`` unless ``attrs`` has it; an op that draws
    random numbers draws from the port's generator of its inputs'
    device; a creation op (no array input) puts its output on ``ctx``,
    by default the current context. The op runs with torch's grad mode
    on exactly while ``autograd.record()`` is. With ``out`` the result
    is bound into that NDArray (or list). An optimizer update
    (``mutate_inputs``) writes its weight and states in place and returns
    the weight."""
    from .. import autograd
    from ..ops.registry import apply, get_op
    op = get_op(name)
    attrs = dict(attrs or {})
    if "train_mode" in op.attr_defaults and "train_mode" not in attrs:
        attrs["train_mode"] = autograd.is_training()
    tensors = [x._data if isinstance(x, NDArray) else x for x in inputs]
    if "ctx" in op.attr_defaults and not any(
            isinstance(t, torch.Tensor) for t in tensors):
        attrs["ctx"] = _device(attrs.get("ctx"))
    with torch.set_grad_enabled(autograd.is_recording()):
        res = apply(op, tensors, attrs)
    if op.mutate_inputs:       # updated in place: the weight comes back
        return inputs[op.mutate_inputs[0]]
    outs = [NDArray(t) for t in res]
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        for t, o in zip(targets, outs):
            t._set_data(o._data)
        return out
    return outs[0] if len(outs) == 1 else outs


def _binop(a, b, op, scalar_op):
    if isinstance(b, NDArray):
        return invoke_op(op, [a, b])
    if isinstance(b, numbers.Number):
        return invoke_op(scalar_op, [a], {"scalar": b})
    return NotImplemented


class NDArray(object):
    """A multi-dimensional array on a device (reference: ndarray.h:82)."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise MXNetError("NDArray wraps a torch.Tensor, got %s"
                             % type(data).__name__)
        self._data = data
        self._grad = None
        self._grad_req = None

    # -- basic properties --------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype of the data (torch.bfloat16 has none: 'bfloat16')."""
        return _NP_DTYPES.get(self._data.dtype, "bfloat16")

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        """The :class:`~mxnet_tpu_torch.context.Context` the data lies
        on (``gpu(0)``, ``cpu(0)``)."""
        return Context(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return invoke_op("transpose", [self])

    # -- host transfer (the sync point) -------------------------------------
    def asnumpy(self):
        """A host copy (never a view of a host tensor, which later
        in-place writes would change). A bfloat16 array comes back as the
        reference's does, a numpy array of ``ml_dtypes.bfloat16`` with the
        same bits (numpy has no bfloat16 of its own; ``ml_dtypes`` is
        imported for that case alone)."""
        t = self._data.detach()
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        a = t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
        if bf16:
            import ml_dtypes
            return a.view(ml_dtypes.bfloat16)
        return a

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape),
            self.context)

    def wait_to_read(self):
        """Block until the work writing this array is done (reference:
        WaitToRead): the device's current stream is synchronized."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    wait_to_write = wait_to_read

    # -- dtype / device movement ------------------------------------------
    def astype(self, dtype, copy=True):
        dt = to_torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return invoke_op("Cast", [self], {"dtype": dt})

    def copy(self):
        return NDArray(self._data.detach().clone())

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, written in place) or onto a
        device (a new NDArray)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto: shape %s into %s"
                                 % (self.shape, other.shape))
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        return NDArray(self._data.detach().to(torch.device(other),
                                              copy=True))

    def as_in_context(self, ctx):
        if torch.device(ctx) == self._data.device:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def detach(self):
        """The same data, outside any recorded graph."""
        return NDArray(self._data.detach())

    def _set_data(self, new_tensor):
        self._data = new_tensor

    # -- autograd ----------------------------------------------------------
    @property
    def grad(self):
        return self._grad

    @grad.setter
    def grad(self, value):
        self._grad = value

    def attach_grad(self, grad_req="write", stype=None):
        """Give this array a gradient buffer (reference:
        ndarray.py:164 attach_grad, autograd.mark_variables)."""
        from .. import autograd
        autograd.mark_variables([self], grad_reqs=grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Gradients of this array with respect to the marked variables
        (reference: ndarray.py:169)."""
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # -- shape ops ---------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return invoke_op("Reshape", [self], {
            "shape": shape, "reverse": kwargs.get("reverse", False)})

    def reshape_like(self, other):
        return invoke_op("reshape_like", [self, other])

    def expand_dims(self, axis):
        return invoke_op("expand_dims", [self], {"axis": axis})

    def flatten(self):
        return invoke_op("Flatten", [self])

    def transpose(self, axes=None):
        return invoke_op("transpose", [self], {"axes": axes})

    def slice_axis(self, axis, begin, end):
        return invoke_op("slice_axis", [self],
                         {"axis": axis, "begin": begin, "end": end})

    def squeeze(self, axis=None):
        return invoke_op("squeeze", [self], {"axis": axis})

    def swapaxes(self, dim1, dim2):
        return invoke_op("swapaxes", [self], {"dim1": dim1, "dim2": dim2})

    def broadcast_to(self, shape):
        return invoke_op("broadcast_to", [self], {"shape": tuple(shape)})

    def broadcast_like(self, other):
        return invoke_op("broadcast_like", [self, other])

    def tile(self, reps):
        return invoke_op("tile", [self], {"reps": tuple(reps)})

    def repeat(self, repeats, axis=None):
        return invoke_op("repeat", [self], {"repeats": repeats,
                                            "axis": axis})

    def pad(self, mode, pad_width, constant_value=0.0):
        return invoke_op("Pad", [self], {"mode": mode,
                                         "pad_width": pad_width,
                                         "constant_value": constant_value})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke_op("SliceChannel", [self], {
            "num_outputs": num_outputs, "axis": axis,
            "squeeze_axis": squeeze_axis})

    def slice(self, begin, end, step=None):
        attrs = {"begin": tuple(begin), "end": tuple(end)}
        if step is not None:
            attrs["step"] = tuple(step)
        return invoke_op("slice", [self], attrs)

    def take(self, indices, axis=0, mode="clip"):
        return invoke_op("take", [self, indices], {"axis": axis,
                                                   "mode": mode})

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return invoke_op("one_hot", [self], {"depth": depth,
                                             "on_value": on_value,
                                             "off_value": off_value})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return invoke_op("dot", [self, other], {"transpose_a": transpose_a,
                                                "transpose_b": transpose_b})

    def tostype(self, stype):
        """This array for ``"default"``; the sparse storage types are
        ROADMAP A15."""
        if stype != "default":
            raise MXNetError("storage type %r is not ported to "
                             "mxnet_tpu_torch yet (ROADMAP A15)" % (stype,))
        return self

    # -- reductions and elementwise methods ----------------------------------
    def sum(self, axis=None, keepdims=False, exclude=False):
        return invoke_op("sum", [self], {"axis": axis, "keepdims": keepdims,
                                         "exclude": exclude})

    def mean(self, axis=None, keepdims=False, exclude=False):
        return invoke_op("mean", [self], {"axis": axis,
                                          "keepdims": keepdims,
                                          "exclude": exclude})

    def max(self, axis=None, keepdims=False):
        return invoke_op("max", [self], {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False):
        return invoke_op("min", [self], {"axis": axis, "keepdims": keepdims})

    def prod(self, axis=None, keepdims=False):
        return invoke_op("prod", [self], {"axis": axis, "keepdims": keepdims})

    def argmax(self, axis=None, keepdims=False):
        return invoke_op("argmax", [self], {"axis": axis,
                                            "keepdims": keepdims})

    def argmin(self, axis=None, keepdims=False):
        return invoke_op("argmin", [self], {"axis": axis,
                                            "keepdims": keepdims})

    def argsort(self, axis=-1, is_ascend=True):
        return invoke_op("argsort", [self], {"axis": axis,
                                             "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return invoke_op("sort", [self], {"axis": axis,
                                          "is_ascend": is_ascend})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return invoke_op("topk", [self], {"axis": axis, "k": k,
                                          "ret_typ": ret_typ,
                                          "is_ascend": is_ascend})

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke_op("norm", [self], {"ord": ord, "axis": axis,
                                          "keepdims": keepdims})

    def clip(self, a_min, a_max):
        return invoke_op("clip", [self], {"a_min": a_min, "a_max": a_max})

    def softmax(self, axis=-1):
        return invoke_op("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return invoke_op("log_softmax", [self], {"axis": axis})

    def _unary(name):
        def method(self):
            return invoke_op(name, [self])
        method.__name__ = name
        return method

    abs = _unary("abs")
    sign = _unary("sign")
    sqrt = _unary("sqrt")
    square = _unary("square")
    exp = _unary("exp")
    log = _unary("log")
    relu = _unary("relu")
    sigmoid = _unary("sigmoid")
    tanh = _unary("tanh")
    zeros_like = _unary("zeros_like")
    ones_like = _unary("ones_like")
    del _unary

    # -- arithmetic and comparison operators -------------------------------
    def __add__(self, other):
        return _binop(self, other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return _binop(self, other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return _binop(self, other, "broadcast_sub", "_rminus_scalar")

    def __mul__(self, other):
        return _binop(self, other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binop(self, other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _binop(self, other, "broadcast_div", "_rdiv_scalar")

    def __mod__(self, other):
        return _binop(self, other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return _binop(self, other, "broadcast_mod", "_rmod_scalar")

    def __pow__(self, other):
        return _binop(self, other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return _binop(self, other, "broadcast_power", "_rpower_scalar")

    def __neg__(self):
        return invoke_op("negative", [self])

    def __abs__(self):
        return invoke_op("abs", [self])

    def __eq__(self, other):
        if other is None:
            return False
        return _binop(self, other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        if other is None:
            return True
        return _binop(self, other, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, other):
        return _binop(self, other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return _binop(self, other, "broadcast_greater_equal",
                      "_greater_equal_scalar")

    def __lt__(self, other):
        return _binop(self, other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return _binop(self, other, "broadcast_lesser_equal",
                      "_lesser_equal_scalar")

    __hash__ = object.__hash__

    def _inplace(self, other, op):
        """``self op= other``: in place outside ``autograd.record()``;
        while recording, the result is rebound (a new graph node), as the
        JAX package rebinds its buffer."""
        from .. import autograd
        out = op(self, other)
        if out is NotImplemented:
            return out
        if autograd.is_recording():
            self._set_data(out._data)
        else:
            with torch.no_grad():
                self._data.copy_(out._data)
        return self

    def __iadd__(self, other):
        return self._inplace(other, NDArray.__add__)

    def __isub__(self, other):
        return self._inplace(other, NDArray.__sub__)

    def __imul__(self, other):
        return self._inplace(other, NDArray.__mul__)

    def __itruediv__(self, other):
        return self._inplace(other, NDArray.__truediv__)

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, key):
        """An NDArray key takes along axis 0 (clipped, as the JAX
        package's); ints, slices (negative steps included), ``...`` and
        None index as numpy does; other keys index the tensor as torch
        does."""
        from .. import autograd
        from ..ops.matrix import encode_index_key
        if isinstance(key, NDArray):
            return invoke_op("take", [self, key], {"axis": 0,
                                                   "mode": "clip"})
        enc = encode_index_key(key)
        if enc is not None:
            return invoke_op("_getitem", [self], {"key": enc})
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data[key])

    def __setitem__(self, key, value):
        from ..ops.matrix import basic_setitem, encode_index_key
        if isinstance(value, NDArray):
            value = value._data
        elif isinstance(value, np.ndarray):
            value = torch.from_numpy(np.ascontiguousarray(value))
        if isinstance(value, torch.Tensor):
            value = value.to(self._data.device, self._data.dtype)
        if isinstance(key, NDArray):
            key = key._data.long()
        with torch.no_grad():
            if encode_index_key(key) is not None:
                basic_setitem(self._data, key, value)
            else:
                self._data[key] = value


def array(source_array, ctx=None, dtype=None):
    """A new NDArray holding a copy of ``source_array`` on ``ctx``
    (default ``cuda:0``); dtype follows a typed source (float64 becomes
    float32), else float32."""
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    typed = isinstance(source_array, np.ndarray)
    arr = np.asarray(source_array)
    if dtype is None:
        dtype = arr.dtype if typed and arr.dtype != np.float64 \
            else np.float32
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":    # ml_dtypes' (asnumpy's), same bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return NDArray(t.to(_device(ctx), to_torch_dtype(dtype), copy=True))


def zeros(shape, ctx=None, dtype=None, **_kw):
    return NDArray(torch.zeros(_as_shape(shape), dtype=to_torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None, **_kw):
    return NDArray(torch.ones(_as_shape(shape), dtype=to_torch_dtype(dtype),
                              device=_device(ctx)))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def full(shape, val, ctx=None, dtype=None, **_kw):
    """An array of ``shape`` filled with ``val`` (the ``_full`` op)."""
    return invoke_op("_full", [], {"shape": _as_shape(shape), "value": val,
                                   "dtype": to_torch_dtype(dtype),
                                   "ctx": ctx})


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    """``start, start + step, ...`` below ``stop`` (the ``_arange`` op)."""
    return invoke_op("_arange", [], {"start": start, "stop": stop,
                                     "step": step, "repeat": repeat,
                                     "dtype": to_torch_dtype(dtype),
                                     "ctx": ctx})


def concat(*arrays, dim=1):
    return invoke_op("Concat", list(arrays), {"dim": dim})


def stack(*arrays, axis=0):
    return invoke_op("stack", list(arrays), {"axis": axis})


def waitall():
    """Block until all launched work is done (reference:
    MXNDArrayWaitAll): every CUDA card this process has used is
    synchronized; on the host there is nothing to wait for."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _as_shape(shape):
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)
