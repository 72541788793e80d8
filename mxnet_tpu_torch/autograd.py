"""Imperative autograd over ``torch.autograd``.

Counterpart of the JAX package's ``autograd.py`` (reference:
python/mxnet/autograd.py, src/imperative/imperative.cc). The JAX package
keeps its own tape and differentiates each entry with ``jax.vjp``; here
torch's graph is the tape:

* ``record()`` / ``pause()`` set a thread-local recording flag, and
  every NDArray operation runs under ``torch.set_grad_enabled`` of that
  flag (``ndarray.invoke_op``), so a graph is built only while
  recording; ``train_mode()`` / ``predict_mode()`` set the flag that ops
  with a ``train_mode`` attr (BatchNorm) read;
* ``mark_variables`` / ``NDArray.attach_grad`` make the array's tensor a
  leaf that requires grad and give it a zero gradient buffer; a
  post-accumulate hook moves each backward's gradient into the buffer,
  written or added per ``grad_req`` (torch sums a leaf's incoming
  gradients before the hook runs, once a backward);
* ``backward`` is ``torch.autograd.backward``, ``grad`` is
  ``torch.autograd.grad`` (``create_graph`` for higher orders; it leaves
  every ``.grad`` buffer alone);
* ``Function`` runs the user's ``forward`` / ``backward`` on NDArrays
  inside a ``torch.autograd.Function``.

A second backward through a graph without ``retain_graph`` raises, as in
the JAX package and the reference.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]

_state = threading.local()


def is_recording():
    return getattr(_state, "recording", False)


def is_training():
    return getattr(_state, "training", False)


def set_recording(is_record):
    prev = is_recording()
    _state.recording = bool(is_record)
    return prev


def set_training(train):
    prev = is_training()
    _state.training = bool(train)
    return prev


class _RecordingScope(object):
    def __init__(self, is_record, train):
        self._is_record = is_record
        self._train = train
        self._prev = None

    def __enter__(self):
        self._prev = (
            set_recording(self._is_record) if self._is_record is not None
            else None,
            set_training(self._train) if self._train is not None else None)
        return self

    def __exit__(self, *exc):
        if self._is_record is not None:
            set_recording(self._prev[0])
        if self._train is not None:
            set_training(self._prev[1])


def record(train_mode=True):
    """Scope that records operations for differentiation (reference:
    autograd.py:122)."""
    return _RecordingScope(True, train_mode)


def pause(train_mode=False):
    """Scope that stops recording."""
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)


# ---------------------------------------------------------------------------
# variables
# ---------------------------------------------------------------------------

def _accumulate_hook(ref):
    """The post-accumulate hook of a marked leaf: the backward's gradient
    (torch's ``.grad``) moves into the NDArray's buffer per its
    grad_req, and ``.grad`` is emptied again."""
    def hook(t):
        arr = ref()
        g, t.grad = t.grad, None
        if arr is None or g is None or arr._grad_req == "null":
            return
        buf = arr._grad
        if arr._grad_req == "add" and buf is not None:
            with torch.no_grad():
                buf._data.add_(g)
        elif buf is None or g.requires_grad:
            from .ndarray.ndarray import NDArray
            arr._grad = NDArray(g)
        else:
            buf._data = g
    return hook


def mark_variables(variables, gradients=None, grad_reqs="write"):
    """Mark NDArrays as variables to take gradients for (reference:
    autograd.py mark_variables). Each gets a zero gradient buffer, or
    the matching entry of ``gradients``."""
    import weakref
    from .ndarray.ndarray import NDArray, zeros
    if isinstance(variables, NDArray):
        variables = [variables]
        gradients = None if gradients is None else [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for i, (x, req) in enumerate(zip(variables, grad_reqs)):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (req,))
        t = x._data.detach()
        x._grad_req = req
        if req == "null":
            x._data, x._grad = t, None
            continue
        if not t.dtype.is_floating_point:
            raise MXNetError("attach_grad: %s arrays have no gradient"
                             % (t.dtype,))
        t.requires_grad_(True)
        t.register_post_accumulate_grad_hook(
            _accumulate_hook(weakref.ref(x)))
        x._data = t
        x._grad = (gradients[i] if gradients is not None
                   else zeros(x.shape, ctx=x.context, dtype=t.dtype))


# ---------------------------------------------------------------------------
# backward / grad
# ---------------------------------------------------------------------------

def _as_list(x):
    if x is None or isinstance(x, (list, tuple)):
        return x
    return [x]


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray
    hs = []
    for h in heads:
        if not h._data.requires_grad:
            raise MXNetError(
                "cannot differentiate a head that is not in a recorded "
                "computation (record the operations under "
                "autograd.record() on arrays marked by attach_grad)")
        hs.append(h._data)
    if head_grads is None:
        return hs, None
    gs = []
    for h, g in zip(hs, head_grads):
        if g is None:
            gs.append(torch.ones_like(h))
        else:
            g = g._data if isinstance(g, NDArray) else torch.as_tensor(g)
            gs.append(g.to(h.device, h.dtype))
    return hs, gs


def _run(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except RuntimeError as e:
        if "second time" in str(e) or "freed" in str(e):
            raise MXNetError(
                "Trying to backward through a graph whose saved buffers "
                "were already freed; pass retain_graph=True to the first "
                "backward to differentiate it again") from e
        raise


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to the marked variables,
    written or added into each variable's ``.grad`` per its grad_req
    (reference: Imperative::Backward). ``head_grads`` default to ones."""
    hs, gs = _heads(_as_list(heads), _as_list(head_grads))
    if gs is None:
        gs = [torch.ones_like(h) for h in hs]
    with _RecordingScope(False, train_mode):
        _run(torch.autograd.backward, hs, gs, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned
    without touching any ``.grad`` buffer (reference: autograd.py grad).
    With ``create_graph`` the gradients are themselves recorded, so a
    further backward differentiates them (higher-order gradients)."""
    from .ndarray.ndarray import NDArray
    single = isinstance(variables, NDArray)
    vs = [variables] if single else list(variables)
    for v in vs:
        if not (v._data.requires_grad and v._data.is_leaf):
            raise MXNetError("grad requires marked variables (call "
                             "attach_grad / mark_variables first)")
    hs, gs = _heads(_as_list(heads), _as_list(head_grads))
    if retain_graph is None:
        retain_graph = create_graph
    with _RecordingScope(bool(create_graph), train_mode):
        res = _run(torch.autograd.grad, hs, [v._data for v in vs], gs,
                   retain_graph=retain_graph, create_graph=create_graph,
                   allow_unused=True)
    outs = []
    for v, g in zip(vs, res):
        if g is None:
            raise MXNetError("one of the variables does not take part in "
                             "the computation of the heads")
        outs.append(NDArray(g))
    return outs[0] if single else outs


# ---------------------------------------------------------------------------
# Function
# ---------------------------------------------------------------------------

class _FunctionBridge(torch.autograd.Function):
    """Runs an :class:`Function` instance's NDArray forward and backward
    as a torch autograd node."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from .ndarray.ndarray import NDArray
        ctx.fn = fn
        with pause():
            outs = fn.forward(*[NDArray(t) for t in tensors])
        fn._single = not isinstance(outs, (tuple, list))
        outs = [outs] if fn._single else list(outs)
        # an output that is an input (or a view of one) is copied, as an
        # autograd Function's outputs must be new tensors
        return tuple(o._data.clone() if o._data._base is not None
                     or any(o._data is t for t in tensors) else o._data
                     for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        with pause():
            res = ctx.fn.backward(*[NDArray(g) for g in grads])
        res = res if isinstance(res, (tuple, list)) else (res,)
        return (None,) + tuple(None if r is None else r._data for r in res)


class Function(object):
    """A user-defined differentiable function (reference: autograd.py
    Function): subclass it with ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` on NDArrays; an instance is called
    once."""

    def __init__(self):
        self._used = False
        self.saved_tensors = ()

    def save_for_backward(self, *args):
        self.saved_tensors = args

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if self._used:
            raise MXNetError("each Function instance can only be called "
                             "once")
        self._used = True
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _FunctionBridge.apply(self, *[x._data for x in inputs])
        outs = tuple(NDArray(o) for o in outs)
        return outs[0] if self._single else outs

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
