"""NDArray: a thin wrapper over one :class:`torch.Tensor`.

The subset of the JAX package's ``ndarray/ndarray.py`` that the Module
training path uses: shape/dtype/context, host copies, ``copy``/
``copyto``/``astype``, basic slicing and whole-array assignment, and the
creation helpers. As in the JAX package, ``_data`` is the backing array
and ``_set_data`` rebinds it. Unlike JAX arrays a tensor can be written
in place: whole-array assignment (``arr[:] = v``) fills the existing
tensor, and the executor's parameters are updated in place by the fused
optimizer kernel. The imperative op namespace (``nd.relu(...)``,
arithmetic between arrays) and autograd come with ROADMAP A12.

Creation helpers default to the host (``cpu``), as MXNet's own default
context is; pass ``ctx=gpu(0)`` for the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["NDArray", "array", "zeros", "ones", "empty", "to_torch_dtype"]

_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool,
}
_NP_DTYPES = {t: n for n, t in _DTYPES.items()}


def to_torch_dtype(dtype):
    """numpy dtype / name / torch dtype -> torch dtype (default float32)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    try:
        return _DTYPES[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise MXNetError("unsupported dtype %r" % (dtype,)) from None


def _device(ctx):
    if ctx is None:
        return torch.device("cpu")
    return torch.device(ctx)


class NDArray(object):
    """A multi-dimensional array on a device (reference: ndarray.h:82)."""

    __slots__ = ("_data", "__weakref__")

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise MXNetError("NDArray wraps a torch.Tensor, got %s"
                             % type(data).__name__)
        self._data = data

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
        return self._data.device

    ctx = context

    # -- host transfer (the sync point) -------------------------------------
    def asnumpy(self):
        return self._data.detach().cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape),
            self.context)

    # -- dtype / device movement ------------------------------------------
    def astype(self, dtype, copy=True):
        dt = to_torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return NDArray(self._data.to(dt, copy=True))

    def copy(self):
        return NDArray(self._data.detach().clone())

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, written in place) or onto a
        device (a new NDArray)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto: shape %s into %s"
                                 % (self.shape, other.shape))
            other._data.copy_(self._data)
            return other
        return NDArray(self._data.detach().to(_device(other), copy=True))

    def _set_data(self, new_tensor):
        self._data = new_tensor

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._data.long()
        return NDArray(self._data[key])

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        elif isinstance(value, np.ndarray):
            value = torch.from_numpy(np.ascontiguousarray(value))
        with torch.no_grad():
            if isinstance(value, torch.Tensor):
                self._data[key] = value.to(self._data.device,
                                           self._data.dtype)
            else:
                self._data[key] = value


def array(source_array, ctx=None, dtype=None):
    """A new NDArray holding a copy of ``source_array``; dtype follows a
    typed source (float64 becomes float32), else float32."""
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    typed = isinstance(source_array, np.ndarray)
    arr = np.asarray(source_array)
    if dtype is None:
        dtype = arr.dtype if typed and arr.dtype != np.float64 \
            else np.float32
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(
        _device(ctx), to_torch_dtype(dtype), copy=True)
    return NDArray(t)


def zeros(shape, ctx=None, dtype=None, **_kw):
    return NDArray(torch.zeros(_as_shape(shape), dtype=to_torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None, **_kw):
    return NDArray(torch.ones(_as_shape(shape), dtype=to_torch_dtype(dtype),
                              device=_device(ctx)))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def _as_shape(shape):
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)
