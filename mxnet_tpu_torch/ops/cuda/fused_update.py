"""The fused optimizer updates, written by hand in CUDA for Hopper.

Counterpart of the JAX package's ``ops/pallas/fused_update.py``:
``sgd_fused_update`` and ``adam_fused_update`` apply the optimizer's
fused rule (``optimizer._sgd_fused`` / ``_adam_fused``, the same
operations in the same order) in place. The TPU launches one kernel per
parameter; here each wrapper takes the whole parameter list and runs ONE
launch of ``csrc/fused_update.cu`` over every tensor in it:

    sgd_fused_update(ws, gs, states, hypers)
    adam_fused_update(ws, gs, states, hypers)

``ws``/``gs`` are lists of float32 tensors, ``states`` a list of state
tuples (``(mom,)`` or ``()`` for SGD, ``(mean, var)`` for Adam) and
``hypers`` a list of the optimizer's ``fused_hyper`` dicts, one per
tensor. The weights and states are updated in place; a one-element list
is the per-tensor call. Beside them, ``_sgd_fused`` and ``_adam_fused``
are the plain PyTorch versions of the same function over the same lists.

A wrapper launches its kernel for CUDA tensors, on
``torch.cuda.current_stream()``, and raises when the launch returns a
CUDA error. It takes the plain version only because the tensors it was
given lie on the CPU; nothing falls back to it. Every kernel launch adds
one to :data:`LAUNCHES` (plain calls do not).

The kernel reads one table a launch, rebuilt on the host every step (the
gradients are new tensors every step): the shared scalars, each tensor's
weight, gradient and state pointers, size, lr and wd, and the prefix sum
of the tensors' chunk counts, by which each block finds its tensor. It is
staged in pinned memory from PyTorch's host allocator and copied to the
card with one asynchronous copy on the launch's stream; the allocator
keeps the pinned block until that copy is done.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...base import MXNetError
from . import _build

__all__ = ["sgd_fused_update", "adam_fused_update", "CUDA_KERNELS",
           "LAUNCHES", "reset_launches", "CHUNK"]

# kernel-contract registry: every CUDA kernel maps to its plain PyTorch
# version in this module (tests/test_torch_contract.py checks each has
# a csrc/<kernel>.cu source, or shares one, and a CPU test naming both)
CUDA_KERNELS = {
    "sgd_fused_update": "_sgd_fused",
    "adam_fused_update": "_adam_fused",
}

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {name: 0 for name in CUDA_KERNELS}

# both entries are one source, csrc/fused_update.cu
SOURCE = "fused_update"

# elements a CUDA block updates (a multiple of 4: 16-byte accesses)
CHUNK = 4096
_MODES = {"sgd": 0, "sgd_mom": 1, "adam": 2}
_SHARED_KEYS = {    # the scalars every tensor of one launch shares
    "sgd": ("rescale_grad",),
    "sgd_mom": ("rescale_grad", "momentum"),
    "adam": ("rescale_grad", "beta1", "one_minus_beta1", "beta2",
             "one_minus_beta2", "epsilon"),
}

_P, _I = ctypes.c_void_p, ctypes.c_int
# mode, clip, table, n_tensors, n_blocks, chunk, stream
_SYMBOLS = {"fused_update": [_I, _I, _P, _I, _I, _I, _P]}
# the table: 8 shared f32 scalars (32 bytes), one entry a tensor, then
# n + 1 int32 block offsets; an entry is 5 int64 (w, g, s0, s1 pointers,
# element count) and 2 f32 (lr, wd): 48 bytes, TensorEntry in the .cu
_SHARED_BYTES, _ENTRY_BYTES = 32, 48


def reset_launches():
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain versions: the JAX package's fused rules, op for op, in place
# ---------------------------------------------------------------------------

def _prep(g, h):
    """grad * rescale_grad, clipped when ``clip_gradient`` is present."""
    g = g * h["rescale_grad"]
    if "clip_gradient" in h:
        g = torch.clamp(g, -h["clip_gradient"], h["clip_gradient"])
    return g


def _sgd_fused(ws, gs, states, hypers):
    """Plain version of :func:`sgd_fused_update`: ``optimizer._sgd_fused``
    per tensor, written back in place."""
    for w, g, state, h in zip(ws, gs, states, hypers):
        g = _prep(g, h)
        if state:
            mom = h["momentum"] * state[0] - h["lr"] * (g + h["wd"] * w)
            w.copy_(w + mom)
            state[0].copy_(mom)
        else:
            w.copy_(w - h["lr"] * (g + h["wd"] * w))


def _adam_fused(ws, gs, states, hypers):
    """Plain version of :func:`adam_fused_update`:
    ``optimizer._adam_fused`` per tensor, written back in place."""
    for w, g, (mean, var), h in zip(ws, gs, states, hypers):
        g = _prep(g, h) + h["wd"] * w
        mean_new = h["beta1"] * mean + h["one_minus_beta1"] * g
        var_new = h["beta2"] * var + h["one_minus_beta2"] * (g * g)
        w.copy_(w - h["lr"] * mean_new / (torch.sqrt(var_new)
                                          + h["epsilon"]))
        mean.copy_(mean_new)
        var.copy_(var_new)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def sgd_fused_update(ws, gs, states, hypers):
    """SGD over a parameter list in one launch, in place: per tensor
    ``mom = momentum*mom - lr*(g' + wd*w); w += mom`` with state
    ``(mom,)``, or ``w -= lr*(g' + wd*w)`` with state ``()``, where
    ``g' = g*rescale_grad`` clipped to ``clip_gradient`` when the hyper
    dict has it. Every tensor of one call has the same kind of state."""
    stateful = _check(ws, gs, states, hypers, "sgd_fused_update", (0, 1))
    mode = "sgd_mom" if stateful else "sgd"
    if ws[0].device.type == "cpu":
        _sgd_fused(ws, gs, states, hypers)
        return
    _launch("sgd_fused_update", mode, ws, gs, states, hypers)


def adam_fused_update(ws, gs, states, hypers):
    """Adam over a parameter list in one launch, in place: per tensor
    ``g' = g*rescale_grad (clipped) + wd*w; m = b1*m + (1-b1)*g';
    v = b2*v + (1-b2)*g'^2; w -= lr*m / (sqrt(v) + eps)``, with ``lr``
    already bias-corrected by ``Adam.fused_hyper``. State ``(m, v)``."""
    _check(ws, gs, states, hypers, "adam_fused_update", (2,))
    if ws[0].device.type == "cpu":
        _adam_fused(ws, gs, states, hypers)
        return
    _launch("adam_fused_update", "adam", ws, gs, states, hypers)


def _check(ws, gs, states, hypers, fn, n_states):
    """Shared argument checks; returns whether the tensors carry state.
    One cheap pass over the list (this runs every step); the first
    tensor that fails is explained by ``_explain``."""
    n = len(ws)
    if not n:
        raise MXNetError("%s: empty parameter list" % fn)
    if not n == len(gs) == len(states) == len(hypers):
        raise MXNetError("%s: %d weights, %d grads, %d states, %d hypers"
                         % (fn, n, len(gs), len(states), len(hypers)))
    n_state = len(states[0])
    if n_state not in n_states:
        raise MXNetError("%s: %d state tensors per weight, expected %s"
                         % (fn, n_state, " or ".join(map(str, n_states))))
    if not isinstance(ws[0], torch.Tensor):
        raise MXNetError("%s: weight 0 is not a tensor" % fn)
    dev = ws[0].device
    f32 = torch.float32
    for i in range(n):
        w, g, st = ws[i], gs[i], states[i]
        try:
            ok = (len(st) == n_state and w.dtype == f32 and g.dtype == f32
                  and w.is_contiguous() and g.is_contiguous()
                  and g.shape == w.shape and w.device == dev
                  and g.device == dev)
            for t in st:
                ok = ok and (t.dtype == f32 and t.is_contiguous()
                             and t.shape == w.shape and t.device == dev)
        except AttributeError:          # not a tensor
            ok = False
        if not ok:
            _explain(fn, i, w, g, st, n_state, dev)
    if dev.type not in ("cpu", "cuda"):
        raise MXNetError("%s: unsupported device %s" % (fn, dev))
    return n_state > 0


def _explain(fn, i, w, g, state, n_state, dev):
    """Raise the error for tensor ``i`` that failed ``_check``."""
    if len(state) != n_state:
        raise MXNetError("%s: tensor %d has %d state tensors, tensor 0 has "
                         "%d; one launch takes one kind"
                         % (fn, i, len(state), n_state))
    for name, t in (("weight", w), ("grad", g)) + tuple(
            ("state %d" % k, s) for k, s in enumerate(state)):
        if not isinstance(t, torch.Tensor):
            raise MXNetError("%s: %s %d is not a tensor" % (fn, name, i))
        if t.dtype != torch.float32:
            raise MXNetError("%s: %s %d has dtype %s; the update takes "
                             "float32 only" % (fn, name, i, t.dtype))
        if t.device != dev:
            raise MXNetError("%s: %s %d is on %s, expected %s"
                             % (fn, name, i, t.device, dev))
        if t.shape != w.shape:
            raise MXNetError("%s: %s %d has shape %s, weight %s"
                             % (fn, name, i, tuple(t.shape), tuple(w.shape)))
        if not t.is_contiguous():
            raise MXNetError("%s: %s %d must be contiguous" % (fn, name, i))
    raise MXNetError("%s: tensor %d rejected" % (fn, i))


def _launch(name, mode, ws, gs, states, hypers):
    table, n_blocks, clip = _pack(name, mode, ws, gs, states, hypers)
    dev = ws[0].device
    lib = _build.load(SOURCE, _SYMBOLS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        table = torch.from_numpy(table).pin_memory().to(dev,
                                                        non_blocking=True)
        err = lib.fused_update(_MODES[mode], int(clip), table.data_ptr(),
                               len(ws), n_blocks, CHUNK, stream.cuda_stream)
    if err != 0:
        raise MXNetError("%s: CUDA kernel launch failed (cudaError_t %d)"
                         % (name, err))
    LAUNCHES[name] += 1


def _pack(name, mode, ws, gs, states, hypers):
    """The launch's table as numpy bytes (the layout is described at
    ``_SHARED_BYTES``), its block count and whether it clips."""
    h0 = hypers[0]
    shared_keys = _SHARED_KEYS[mode] + (
        ("clip_gradient",) if "clip_gradient" in h0 else ())
    try:
        shared = tuple(h0[k] for k in shared_keys)
        lrwd = [(h["lr"], h["wd"]) for h in hypers]
        same = all(tuple(h[k] for k in shared_keys) == shared
                   and ("clip_gradient" in h) == ("clip_gradient" in h0)
                   for h in hypers)
    except KeyError as e:
        raise MXNetError("%s: a hyper dict lacks %s" % (name, e)) from None
    if not same:
        raise MXNetError("%s: the hyper dicts differ in a scalar one launch "
                         "shares (%s)" % (name, ", ".join(shared_keys)))
    clip = "clip_gradient" in h0
    n = len(ws)
    sizes = np.array([w.numel() for w in ws], np.int64)
    first = np.zeros(n + 1, np.int64)
    np.cumsum(-(-sizes // CHUNK), out=first[1:])
    n_blocks = int(first[-1])
    if n_blocks >= 2 ** 31:
        raise MXNetError("%s: %d blocks exceed the grid" % (name, n_blocks))
    end = _SHARED_BYTES + _ENTRY_BYTES * n
    buf = np.zeros(end + 4 * (n + 1), np.uint8)
    scalars = buf[:_SHARED_BYTES].view(np.float32)
    scalars[0] = h0["rescale_grad"]
    if clip:
        scalars[1] = h0["clip_gradient"]
    if mode == "sgd_mom":
        scalars[2] = h0["momentum"]
    elif mode == "adam":
        scalars[2:7] = [h0["beta1"], h0["one_minus_beta1"], h0["beta2"],
                        h0["one_minus_beta2"], h0["epsilon"]]
    entries = buf[_SHARED_BYTES:end].view(np.int64).reshape(n, 6)
    entries[:, :4] = [
        (w.data_ptr(), g.data_ptr()) + tuple(t.data_ptr() for t in st)
        + (0,) * (2 - len(st)) for w, g, st in zip(ws, gs, states)]
    entries[:, 4] = sizes
    buf[_SHARED_BYTES:end].view(np.float32).reshape(n, 12)[:, 10:] = lrwd
    buf[end:].view(np.int32)[:] = first
    return buf, n_blocks, clip
