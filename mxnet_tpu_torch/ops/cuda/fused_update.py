"""The fused optimizer updates, written by hand in CUDA for Hopper.

Counterpart of the JAX package's ``ops/pallas/fused_update.py`` and of
the fused rules of its ``optimizer.py``: ``<rule>_fused_update`` applies
the optimizer's fused rule (``optimizer._sgd_fused``, ``_adam_fused``,
``_nag_fused``, ..., the same operations in the same order) in place.
The TPU launches one kernel per parameter (SGD and Adam only, float32
only); here each wrapper takes the whole parameter list and runs ONE
launch of ``csrc/fused_update.cu`` over every tensor in it:

    sgd_fused_update(ws, gs, states, hypers, masters=None)
    adam_fused_update(...), nag_fused_update(...), signum_fused_update,
    adagrad_fused_update, rmsprop_fused_update, adadelta_fused_update,
    ftrl_fused_update, ftml_fused_update, adamax_fused_update,
    test_fused_update

``ws``/``gs`` are lists of float32, bfloat16 or float16 tensors (a
tensor's gradient has its weight's type; one list may mix types),
``states`` a list of state tuples (``(mom,)`` or ``()`` for SGD, ``(mean,
var)`` for Adam, ...: ``_RULES`` gives each rule's counts) and
``hypers`` a list of the optimizer's ``fused_hyper`` dicts, one per
tensor. ``masters``, where given, holds per tensor None or the float32
master copy of a low-precision weight (``multi_precision``): that
tensor's states are float32, the rule runs in float32 on the master and
the weight becomes the new master rounded to its type, as the JAX
package's ``mp_sgd_mom_update`` and ``Optimizer.update_multi_precision``.
The weights, states and masters are updated in place; a one-element list
is the per-tensor call. Beside them, ``_sgd_fused``, ``_adam_fused``, ...
are the plain PyTorch versions of the same function over the same lists.

Each operation is rounded to the weight's type (float32 in the master
mode) before the next reads it, and each hyperparameter is rounded to
that type once (through float32, as both frameworks round a Python
scalar): what the JAX rule computes at bf16 and float16. The plain
versions hold the hyperparameters as 0-d tensors of that type on the
weights' device, which makes eager PyTorch compute exactly that.

A wrapper launches its kernel for CUDA tensors, on
``torch.cuda.current_stream()``, and raises when the launch returns a
CUDA error. It takes the plain version only because the tensors it was
given lie on the CPU; nothing falls back to it. Every kernel launch adds
one to :data:`LAUNCHES` under its wrapper's name (plain calls do not).

The kernel reads one table a launch, rebuilt on the host every step (the
gradients are new tensors every step): the shared scalars, each tensor's
type, weight, gradient, state and master pointers, size, lr, wd and two
per-tensor coefficients, and the prefix sum of the tensors' chunk
counts, by which each block finds its tensor. It is staged in pinned
memory from PyTorch's host allocator and copied to the card with one
asynchronous copy on the launch's stream; the allocator keeps the pinned
block until that copy is done.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...base import MXNetError
from . import _build

__all__ = ["sgd_fused_update", "adam_fused_update", "nag_fused_update",
           "signum_fused_update", "adagrad_fused_update",
           "rmsprop_fused_update", "adadelta_fused_update",
           "ftrl_fused_update", "ftml_fused_update", "adamax_fused_update",
           "test_fused_update", "CUDA_KERNELS", "LAUNCHES",
           "reset_launches", "CHUNK", "DTYPES"]

# rule -> {state tensors a weight: the kernel's mode}
_RULES = {
    "sgd": {0: "sgd", 1: "sgd_mom"},
    "adam": {2: "adam"},
    "nag": {0: "sgd", 1: "nag_mom"},    # stateless NAG is SGD
    "signum": {0: "signsgd", 1: "signum"},
    "adagrad": {1: "adagrad"},
    "rmsprop": {1: "rmsprop", 3: "rmspropalex"},
    "adadelta": {2: "adadelta"},
    "ftrl": {2: "ftrl"},
    "ftml": {3: "ftml"},
    "adamax": {2: "adamax"},
    "test": {1: "test"},
}

# kernel-contract registry: every CUDA kernel maps to its plain PyTorch
# version in this module (tests/test_torch_contract.py checks each has
# a csrc/<kernel>.cu source, or shares one, and a CPU test naming both)
CUDA_KERNELS = {"%s_fused_update" % r: "_%s_fused" % r for r in _RULES}

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {name: 0 for name in CUDA_KERNELS}

# every entry is one source, csrc/fused_update.cu
SOURCE = "fused_update"

# the weight types a launch takes, and their codes in the table (+ 3: the
# tensor has a float32 master copy)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# elements a CUDA block updates (a multiple of 8: 16-byte accesses of
# 2-byte types)
CHUNK = 4096
_MODES = {"sgd": 0, "sgd_mom": 1, "adam": 2, "nag_mom": 3, "signsgd": 4,
          "signum": 5, "adagrad": 6, "rmsprop": 7, "rmspropalex": 8,
          "adadelta": 9, "ftrl": 10, "ftml": 11, "adamax": 12, "test": 13}
_SHARED_KEYS = {    # the scalars every tensor of one launch shares: h[2..]
    "sgd": (), "signsgd": (), "test": (),
    "sgd_mom": ("momentum",), "nag_mom": ("momentum",),
    "signum": ("momentum", "one_minus_momentum"),
    "adam": ("beta1", "one_minus_beta1", "beta2", "one_minus_beta2",
             "epsilon"),
    "adagrad": ("eps",),
    "rmsprop": ("gamma1", "one_minus_gamma1", "epsilon"),
    "rmspropalex": ("gamma1", "one_minus_gamma1", "epsilon", "gamma2"),
    "adadelta": ("rho", "one_minus_rho", "epsilon"),
    "ftrl": ("lamda1", "beta"),
    "ftml": ("beta1", "one_minus_beta1", "beta2", "one_minus_beta2",
             "epsilon"),
    "adamax": ("beta1", "one_minus_beta1", "beta2"),
}
# per-tensor scalars beside lr and wd (folded on the host from the
# tensor's own lr, in float64, as the JAX package's fused_hyper)
_TENSOR_KEYS = {"signum": ("wdlh_coef", "lr_wd"),
                "ftml": ("d_coef", "v_coef")}
_CLIP, _CLIP_WEIGHTS = 1, 2     # the launch's flags

_P, _I = ctypes.c_void_p, ctypes.c_int
# mode, flags, table, n_tensors, n_blocks, chunk, stream
_SYMBOLS = {"fused_update": [_I, _I, _P, _I, _I, _I, _P]}
# the table: 16 shared f32 scalars (64 bytes), one entry a tensor, then
# n + 1 int32 block offsets; an entry is 6 pointers (w, g, s0, s1, s2,
# master), the element count (int64), 4 f32 (lr, wd, two coefficients)
# and 2 int32 (the type code, padding): 80 bytes, TensorEntry in the .cu
_SHARED_BYTES, _ENTRY_BYTES = 64, 80


def reset_launches():
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain versions: the JAX package's fused rules, op for op, in place
# ---------------------------------------------------------------------------

def _scalars(hypers, dtypes, device):
    """Each tensor's hyper dict as 0-d tensors of its compute type on
    ``device`` (float64 stays float64; the others round through float32,
    as a Python scalar does). One host-to-device copy a call."""
    keys = sorted(hypers[0])
    try:
        vals = torch.tensor([[float(h[k]) for k in keys] for h in hypers],
                            dtype=torch.float64)
    except KeyError as e:
        raise MXNetError("a hyper dict lacks %s" % e) from None
    vals = vals.to(device)
    f32 = vals.to(torch.float32)
    conv = {d: vals if d == torch.float64 else f32.to(d)
            for d in set(dtypes)}
    return [{k: conv[d][i, j] for j, k in enumerate(keys)}
            for i, d in enumerate(dtypes)]


def _prep(g, h):
    """grad * rescale_grad, clipped when ``clip_gradient`` is present."""
    g = g * h["rescale_grad"]
    if "clip_gradient" in h:
        g = torch.clamp(g, -h["clip_gradient"], h["clip_gradient"])
    return g


def _sqrt(x):
    """The correctly rounded square root in ``x``'s type, as the kernel's
    ``__fsqrt_rn`` and XLA's sqrt: PyTorch's CPU sqrt of float32 is off
    by an ULP in ~0.7% of values (its vectorised approximation), so the
    root is taken in float64 and rounded once (exact: 53 >= 2 * 24 + 2)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _sign(x):
    """``jnp.sign``: NaN stays NaN and a zero keeps its sign bit."""
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


def _plain(rule, ws, gs, states, hypers, masters):
    """``rule(w, g, state, h) -> (w_new, state_new)`` on each tensor, in
    place: on the float32 master (gradient in float32) where ``masters``
    gives one, the weight then set to the new master in its type."""
    masters = masters or [None] * len(ws)
    dtypes = [torch.float32 if m is not None else w.dtype
              for w, m in zip(ws, masters)]
    hs = _scalars(hypers, dtypes, ws[0].device)
    for w, g, st, h, m in zip(ws, gs, states, hs, masters):
        if m is not None:
            w_new, st_new = rule(m, g.float(), st, h)
            m.copy_(w_new)
        else:
            w_new, st_new = rule(w, g, st, h)
        w.copy_(w_new)
        for s, v in zip(st, st_new):
            s.copy_(v)


def _sgd(w, g, state, h):
    g = _prep(g, h)
    if state:
        mom = h["momentum"] * state[0] - h["lr"] * (g + h["wd"] * w)
        return w + mom, (mom,)
    return w - h["lr"] * (g + h["wd"] * w), ()


def _nag(w, g, state, h):
    if state:
        g = _prep(g, h) + h["wd"] * w
        mom = h["momentum"] * state[0] + g
        return w - h["lr"] * (g + h["momentum"] * mom), (mom,)
    return _sgd(w, g, state, h)


def _signum(w, g, state, h):
    g = _prep(g, h)
    if state:
        mom = h["momentum"] * state[0] - h["one_minus_momentum"] * g
        return (h["wdlh_coef"] * w + h["lr"] * _sign(mom)
                - h["lr_wd"] * w), (mom,)
    return w - h["lr"] * (_sign(g) + h["wd"] * w), ()


def _adam(w, g, state, h):
    g = _prep(g, h) + h["wd"] * w
    mean, var = state
    mean = h["beta1"] * mean + h["one_minus_beta1"] * g
    var = h["beta2"] * var + h["one_minus_beta2"] * (g * g)
    return (w - h["lr"] * mean / (_sqrt(var) + h["epsilon"]),
            (mean, var))


def _adagrad(w, g, state, h):
    g = _prep(g, h)
    hist = state[0] + g * g
    div = g / (_sqrt(hist) + h["eps"])
    return w - h["lr"] * (div + w * h["wd"]), (hist,)


def _clip_weights(w, h):
    if "clip_weights" in h:
        w = torch.clamp(w, -h["clip_weights"], h["clip_weights"])
    return w


def _rmsprop(w, g, state, h):
    g = _prep(g, h) + h["wd"] * w
    if len(state) == 1:                       # plain (Tieleman)
        n = h["gamma1"] * state[0] + h["one_minus_gamma1"] * (g * g)
        w = w - h["lr"] * g / _sqrt(n + h["epsilon"])
        return _clip_weights(w, h), (n,)
    n, g_acc, delta = state                   # centered (Graves)
    n = h["gamma1"] * n + h["one_minus_gamma1"] * (g * g)
    g_acc = h["gamma1"] * g_acc + h["one_minus_gamma1"] * g
    delta = h["gamma2"] * delta - h["lr"] * g / _sqrt(
        n - g_acc * g_acc + h["epsilon"])
    return _clip_weights(w + delta, h), (n, g_acc, delta)


def _adadelta(w, g, state, h):
    g = _prep(g, h)
    acc_g, acc_delta = state
    acc_g = h["rho"] * acc_g + h["one_minus_rho"] * g * g
    cd = (_sqrt(acc_delta + h["epsilon"])
          / _sqrt(acc_g + h["epsilon"])) * g
    acc_delta = h["rho"] * acc_delta + h["one_minus_rho"] * cd * cd
    return w - cd - h["wd"] * w, (acc_g, acc_delta)


def _ftrl(w, g, state, h):
    g = _prep(g, h)
    z, n = state
    n_new = n + g * g
    sigma = (_sqrt(n_new) - _sqrt(n)) / h["lr"]
    z = z + g - sigma * w
    w = torch.where(
        torch.abs(z) <= h["lamda1"], torch.zeros_like(w),
        -(z - _sign(z) * h["lamda1"])
        / ((h["beta"] + _sqrt(n_new)) / h["lr"] + h["wd"]))
    return w, (z, n_new)


def _ftml(w, g, state, h):
    g = _prep(g, h) + h["wd"] * w
    d, v, z = state
    v = h["beta2"] * v + h["one_minus_beta2"] * (g * g)
    d_new = h["d_coef"] * (_sqrt(v / h["v_coef"]) + h["epsilon"])
    sigma = d_new - h["beta1"] * d
    z = h["beta1"] * z + h["one_minus_beta1"] * g - sigma * w
    return -z / d_new, (d_new, v, z)


def _adamax(w, g, state, h):
    g = g * h["rescale_grad"] + h["wd"] * w
    if "clip_gradient" in h:
        g = torch.clamp(g, -h["clip_gradient"], h["clip_gradient"])
    m, u = state
    m = h["beta1"] * m + h["one_minus_beta1"] * g
    u = torch.maximum(h["beta2"] * u, torch.abs(g))
    return w - h["lr"] * m / u, (m, u)


def _test(w, g, state, h):
    return w - h["lr"] * g * h["rescale_grad"], (state[0] + g,)


def _sgd_fused(ws, gs, states, hypers, masters=None):
    """Plain version of :func:`sgd_fused_update`: ``optimizer._sgd_fused``
    per tensor, written back in place."""
    _plain(_sgd, ws, gs, states, hypers, masters)


def _adam_fused(ws, gs, states, hypers, masters=None):
    """Plain version of :func:`adam_fused_update`."""
    _plain(_adam, ws, gs, states, hypers, masters)


def _nag_fused(ws, gs, states, hypers, masters=None):
    """Plain version of :func:`nag_fused_update`."""
    _plain(_nag, ws, gs, states, hypers, masters)


def _signum_fused(ws, gs, states, hypers, masters=None):
    """Plain version of :func:`signum_fused_update`."""
    _plain(_signum, ws, gs, states, hypers, masters)


def _adagrad_fused(ws, gs, states, hypers, masters=None):
    """Plain version of :func:`adagrad_fused_update`."""
    _plain(_adagrad, ws, gs, states, hypers, masters)


def _rmsprop_fused(ws, gs, states, hypers, masters=None):
    """Plain version of :func:`rmsprop_fused_update`."""
    _plain(_rmsprop, ws, gs, states, hypers, masters)


def _adadelta_fused(ws, gs, states, hypers, masters=None):
    """Plain version of :func:`adadelta_fused_update`."""
    _plain(_adadelta, ws, gs, states, hypers, masters)


def _ftrl_fused(ws, gs, states, hypers, masters=None):
    """Plain version of :func:`ftrl_fused_update`."""
    _plain(_ftrl, ws, gs, states, hypers, masters)


def _ftml_fused(ws, gs, states, hypers, masters=None):
    """Plain version of :func:`ftml_fused_update`."""
    _plain(_ftml, ws, gs, states, hypers, masters)


def _adamax_fused(ws, gs, states, hypers, masters=None):
    """Plain version of :func:`adamax_fused_update`."""
    _plain(_adamax, ws, gs, states, hypers, masters)


def _test_fused(ws, gs, states, hypers, masters=None):
    """Plain version of :func:`test_fused_update`."""
    _plain(_test, ws, gs, states, hypers, masters)


# ---------------------------------------------------------------------------
# wrappers: the CPU takes the plain version, CUDA tensors one launch
# ---------------------------------------------------------------------------

def sgd_fused_update(ws, gs, states, hypers, masters=None):
    """SGD over a parameter list in one launch, in place: per tensor
    ``mom = momentum*mom - lr*(g' + wd*w); w += mom`` with state
    ``(mom,)``, or ``w -= lr*(g' + wd*w)`` with state ``()``, where
    ``g' = g*rescale_grad`` clipped to ``clip_gradient`` when the hyper
    dict has it. Every tensor of one call has the same kind of state."""
    if _on_cpu("sgd", ws, gs, states, hypers, masters):
        _sgd_fused(ws, gs, states, hypers, masters)


def adam_fused_update(ws, gs, states, hypers, masters=None):
    """Adam over a parameter list in one launch, in place: per tensor
    ``g' = g*rescale_grad (clipped) + wd*w; m = b1*m + (1-b1)*g';
    v = b2*v + (1-b2)*g'^2; w -= lr*m / (sqrt(v) + eps)``, with ``lr``
    already bias-corrected by ``Adam.fused_hyper``. State ``(m, v)``."""
    if _on_cpu("adam", ws, gs, states, hypers, masters):
        _adam_fused(ws, gs, states, hypers, masters)


def nag_fused_update(ws, gs, states, hypers, masters=None):
    """Nesterov momentum, state ``(mom,)``: ``g' = g*rescale (clipped) +
    wd*w; mom = momentum*mom + g'; w -= lr*(g' + momentum*mom)``; with
    state ``()`` the SGD step."""
    if _on_cpu("nag", ws, gs, states, hypers, masters):
        _nag_fused(ws, gs, states, hypers, masters)


def signum_fused_update(ws, gs, states, hypers, masters=None):
    """Signum, state ``(mom,)``: ``mom = momentum*mom - (1-momentum)*g';
    w = wdlh_coef*w + lr*sign(mom) - lr_wd*w``; with state ``()``
    signSGD, ``w -= lr*(sign(g') + wd*w)``."""
    if _on_cpu("signum", ws, gs, states, hypers, masters):
        _signum_fused(ws, gs, states, hypers, masters)


def adagrad_fused_update(ws, gs, states, hypers, masters=None):
    """AdaGrad, state ``(history,)``: ``history += g'^2;
    w -= lr*(g' / (sqrt(history) + eps) + w*wd)``."""
    if _on_cpu("adagrad", ws, gs, states, hypers, masters):
        _adagrad_fused(ws, gs, states, hypers, masters)


def rmsprop_fused_update(ws, gs, states, hypers, masters=None):
    """RMSProp: plain (Tieleman) with state ``(n,)``, centered (Graves)
    with state ``(n, g, delta)``; the weights clipped to
    ``clip_weights`` when the hyper dict has it."""
    if _on_cpu("rmsprop", ws, gs, states, hypers, masters):
        _rmsprop_fused(ws, gs, states, hypers, masters)


def adadelta_fused_update(ws, gs, states, hypers, masters=None):
    """AdaDelta, state ``(acc_g, acc_delta)``."""
    if _on_cpu("adadelta", ws, gs, states, hypers, masters):
        _adadelta_fused(ws, gs, states, hypers, masters)


def ftrl_fused_update(ws, gs, states, hypers, masters=None):
    """FTRL-proximal, state ``(z, n)``."""
    if _on_cpu("ftrl", ws, gs, states, hypers, masters):
        _ftrl_fused(ws, gs, states, hypers, masters)


def ftml_fused_update(ws, gs, states, hypers, masters=None):
    """FTML, state ``(d, v, z)``, with the per-tensor ``d_coef`` and
    ``v_coef`` of ``FTML.fused_hyper``."""
    if _on_cpu("ftml", ws, gs, states, hypers, masters):
        _ftml_fused(ws, gs, states, hypers, masters)


def adamax_fused_update(ws, gs, states, hypers, masters=None):
    """Adamax, state ``(m, u)``: ``g' = g*rescale + wd*w`` (then
    clipped); ``m = b1*m + (1-b1)*g'; u = max(b2*u, |g'|);
    w -= lr*m / u``."""
    if _on_cpu("adamax", ws, gs, states, hypers, masters):
        _adamax_fused(ws, gs, states, hypers, masters)


def test_fused_update(ws, gs, states, hypers, masters=None):
    """The Test optimizer, state ``(sum,)``: ``w -= lr*g*rescale;
    sum += g``."""
    if _on_cpu("test", ws, gs, states, hypers, masters):
        _test_fused(ws, gs, states, hypers, masters)



def _on_cpu(rule, ws, gs, states, hypers, masters):
    """Check the arguments; True for CPU tensors (the caller runs the
    plain version), else launch the kernel."""
    name = "%s_fused_update" % rule
    n_state = _check(ws, gs, states, hypers, masters, name,
                     tuple(_RULES[rule]))
    mode = _RULES[rule][n_state]
    if masters is not None and mode not in ("sgd", "sgd_mom"):
        for i, (w, m) in enumerate(zip(ws, masters)):
            if m is not None and w.dtype != torch.float16:
                raise MXNetError(
                    "%s: weight %d is %s with a float32 master; the master "
                    "mode takes float16 weights (float32 and bfloat16 ones "
                    "in SGD only)" % (name, i, w.dtype))
    if ws[0].device.type == "cpu":
        return True
    _launch(name, mode, ws, gs, states, hypers, masters)
    return False


def _check(ws, gs, states, hypers, masters, fn, n_states):
    """Shared argument checks; returns the number of state tensors a
    weight. One cheap pass over the list (this runs every step); the
    first tensor that fails is explained by ``_explain``."""
    n = len(ws)
    if not n:
        raise MXNetError("%s: empty parameter list" % fn)
    if not n == len(gs) == len(states) == len(hypers) or (
            masters is not None and len(masters) != n):
        raise MXNetError("%s: %d weights, %d grads, %d states, %d hypers%s"
                         % (fn, n, len(gs), len(states), len(hypers),
                            "" if masters is None
                            else ", %d masters" % len(masters)))
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
        m = masters[i] if masters is not None else None
        try:
            sdt = f32 if m is not None else w.dtype
            ok = (len(st) == n_state and w.dtype in DTYPES
                  and g.dtype == w.dtype and w.is_contiguous()
                  and g.is_contiguous() and g.shape == w.shape
                  and w.device == dev and g.device == dev)
            for t in st + ((m,) if m is not None else ()):
                ok = ok and (t.dtype == sdt and t.is_contiguous()
                             and t.shape == w.shape and t.device == dev)
        except AttributeError:          # not a tensor
            ok = False
        if not ok:
            _explain(fn, i, w, g, st, m, n_state, dev)
    if dev.type not in ("cpu", "cuda"):
        raise MXNetError("%s: unsupported device %s" % (fn, dev))
    return n_state


def _explain(fn, i, w, g, state, master, n_state, dev):
    """Raise the error for tensor ``i`` that failed ``_check``."""
    if len(state) != n_state:
        raise MXNetError("%s: tensor %d has %d state tensors, tensor 0 has "
                         "%d; one launch takes one kind"
                         % (fn, i, len(state), n_state))
    named = (("weight", w), ("grad", g)) + tuple(
        ("state %d" % k, s) for k, s in enumerate(state)) + (
        (("master", master),) if master is not None else ())
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise MXNetError("%s: %s %d is not a tensor" % (fn, name, i))
    if w.dtype not in DTYPES:
        raise MXNetError("%s: weight %d has dtype %s; the update takes "
                         "float32, bfloat16 or float16 weights"
                         % (fn, i, w.dtype))
    for name, t in named[1:]:
        want = w.dtype if name == "grad" or master is None \
            else torch.float32
        if t.dtype != want:
            raise MXNetError("%s: %s %d has dtype %s, expected %s (weight "
                             "%s%s)" % (fn, name, i, t.dtype, want, w.dtype,
                                        ", float32 master" if master
                                        is not None else ""))
    for name, t in named:
        if t.device != dev:
            raise MXNetError("%s: %s %d is on %s, expected %s"
                             % (fn, name, i, t.device, dev))
        if t.shape != w.shape:
            raise MXNetError("%s: %s %d has shape %s, weight %s"
                             % (fn, name, i, tuple(t.shape), tuple(w.shape)))
        if not t.is_contiguous():
            raise MXNetError("%s: %s %d must be contiguous" % (fn, name, i))
    raise MXNetError("%s: tensor %d rejected" % (fn, i))


def _launch(name, mode, ws, gs, states, hypers, masters):
    table, n_blocks, flags = _pack(name, mode, ws, gs, states, hypers,
                                   masters)
    dev = ws[0].device
    lib = _build.load(SOURCE, _SYMBOLS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        table = torch.from_numpy(table).pin_memory().to(dev,
                                                        non_blocking=True)
        err = lib.fused_update(_MODES[mode], flags, table.data_ptr(),
                               len(ws), n_blocks, CHUNK, stream.cuda_stream)
    if err != 0:
        raise MXNetError("%s: CUDA kernel launch failed (cudaError_t %d)"
                         % (name, err))
    LAUNCHES[name] += 1


def _pack(name, mode, ws, gs, states, hypers, masters=None):
    """The launch's table as numpy bytes (the layout is described at
    ``_SHARED_BYTES``), its block count and its flags."""
    h0 = hypers[0]
    shared_keys = ("rescale_grad",) + _SHARED_KEYS[mode] + tuple(
        k for k in ("clip_gradient", "clip_weights") if k in h0)
    tensor_keys = ("lr", "wd") + _TENSOR_KEYS.get(mode, ())
    try:
        shared = tuple(h0[k] for k in shared_keys)
        per = [tuple(h.get(k, 0.0) if k == "wd" else h[k]
                     for k in tensor_keys) for h in hypers]
        same = all(tuple(h[k] for k in shared_keys) == shared
                   and ("clip_gradient" in h) == ("clip_gradient" in h0)
                   and ("clip_weights" in h) == ("clip_weights" in h0)
                   for h in hypers)
    except KeyError as e:
        raise MXNetError("%s: a hyper dict lacks %s" % (name, e)) from None
    if not same:
        raise MXNetError("%s: the hyper dicts differ in a scalar one launch "
                         "shares (%s)" % (name, ", ".join(shared_keys)))
    flags = (_CLIP if "clip_gradient" in h0 else 0) | (
        _CLIP_WEIGHTS if "clip_weights" in h0 else 0)
    n = len(ws)
    masters = masters or [None] * n
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
    scalars[1] = h0.get("clip_gradient", 0.0)
    scalars[2:2 + len(_SHARED_KEYS[mode])] = [h0[k]
                                              for k in _SHARED_KEYS[mode]]
    scalars[8] = h0.get("clip_weights", 0.0)
    entries = buf[_SHARED_BYTES:end].view(np.int64).reshape(n, 10)
    entries[:, :6] = [
        (w.data_ptr(), g.data_ptr()) + tuple(t.data_ptr() for t in st)
        + (0,) * (3 - len(st)) + (m.data_ptr() if m is not None else 0,)
        for w, g, st, m in zip(ws, gs, states, masters)]
    entries[:, 6] = sizes
    f32 = buf[_SHARED_BYTES:end].view(np.float32).reshape(n, 20)
    f32[:, 14:14 + len(tensor_keys)] = per
    buf[_SHARED_BYTES:end].view(np.int32).reshape(n, 20)[:, 18] = [
        DTYPES[w.dtype] + (3 if m is not None else 0)
        for w, m in zip(ws, masters)]
    buf[end:].view(np.int32)[:] = first
    return buf, n_blocks, flags
