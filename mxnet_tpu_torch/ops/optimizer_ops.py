"""The optimizer update operators (``nd.sgd_update``, ``nd.adam_update``,
...).

Counterpart of the JAX package's ``ops/optimizer_ops.py`` (reference:
src/operator/optimizer_op.cc, where "the update IS an operator"). Each
op updates its weight and states in place (``mutate_inputs``: output i
is input ``mutate_inputs[i]``, the same tensor, and the NDArray layer
returns the weight) through the fused rule of
``ops/cuda/fused_update.py`` on a list of one: one kernel launch on the
card, the plain version on the CPU, nothing written twice. The ops'
attributes fold into the rule's hyperparameters as the JAX ops fold
them in Python (``1 - beta1``, FTML's ``(1 - beta1 ** t) / lr``, ...),
so each op computes the JAX op's function. ``clip_gradient`` (FTML's
``clip_grad``) and ``clip_weights`` apply when > 0, as there. The
``mp_`` ops keep a float32 master copy beside the weight (the kernel's
master mode).
"""
from __future__ import annotations

import torch

from .cuda import fused_update as _fu
from .registry import register

_COMMON = {"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0, "clip_gradient": -1.0}


def _hyper(lr, wd, rescale_grad, clip, **extra):
    h = {"lr": float(lr), "wd": float(wd),
         "rescale_grad": float(rescale_grad)}
    if clip is not None and clip > 0:
        h["clip_gradient"] = float(clip)
    h.update((k, float(v)) for k, v in extra.items())
    return h


def _update(rule, weight, grad, states, h, master=None):
    """``rule`` over the list of one, in place; the mutated tensors (the
    weight, the states, the master) as the op's outputs. Shape inference
    (meta tensors) updates nothing."""
    outs = (weight,) + tuple(states) + ((master,) if master is not None
                                         else ())
    if weight.device.type != "meta":
        with torch.no_grad():
            rule([weight], [grad], [tuple(states)], [h],
                 [master] if master is not None else None)
    return outs


def _op(name, mutate, **defaults):
    return register(name, mutate_inputs=mutate, num_outputs=len(mutate),
                    differentiable=False, attr_defaults=defaults)


@_op("sgd_update", (0,), lazy_update=True, **_COMMON)
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, **_ig):
    return _update(_fu.sgd_fused_update, weight, grad, (),
                   _hyper(lr, wd, rescale_grad, clip_gradient))


@_op("sgd_mom_update", (0, 2), momentum=0.0, lazy_update=True, **_COMMON)
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, **_ig):
    return _update(_fu.sgd_fused_update, weight, grad, (mom,),
                   _hyper(lr, wd, rescale_grad, clip_gradient,
                          momentum=momentum))


@_op("nag_mom_update", (0, 2), momentum=0.0, **_COMMON)
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, **_ig):
    return _update(_fu.nag_fused_update, weight, grad, (mom,),
                   _hyper(lr, wd, rescale_grad, clip_gradient,
                          momentum=momentum))


@_op("adam_update", (0, 2, 3), beta1=0.9, beta2=0.999, epsilon=1e-8,
     lazy_update=True, **dict(_COMMON, lr=0.001))
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 **_ig):
    return _update(_fu.adam_fused_update, weight, grad, (mean, var),
                   _hyper(lr, wd, rescale_grad, clip_gradient, beta1=beta1,
                          beta2=beta2, one_minus_beta1=1 - beta1,
                          one_minus_beta2=1 - beta2, epsilon=epsilon))


def _rms(clip_weights, **h):
    if clip_weights is not None and clip_weights > 0:
        h["clip_weights"] = float(clip_weights)
    return h


@_op("rmsprop_update", (0, 2), gamma1=0.95, epsilon=1e-8,
     clip_weights=-1.0, **dict(_COMMON, lr=0.001))
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0, **_ig):
    return _update(_fu.rmsprop_fused_update, weight, grad, (n,),
                   _rms(clip_weights, **_hyper(
                       lr, wd, rescale_grad, clip_gradient, gamma1=gamma1,
                       one_minus_gamma1=1 - gamma1, epsilon=epsilon)))


@_op("rmspropalex_update", (0, 2, 3, 4), gamma1=0.95, gamma2=0.9,
     epsilon=1e-8, clip_weights=-1.0, **dict(_COMMON, lr=0.001))
def _rmspropalex_update(weight, grad, n, g_acc, delta, lr=0.001, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0, **_ig):
    return _update(_fu.rmsprop_fused_update, weight, grad, (n, g_acc, delta),
                   _rms(clip_weights, **_hyper(
                       lr, wd, rescale_grad, clip_gradient, gamma1=gamma1,
                       one_minus_gamma1=1 - gamma1, gamma2=gamma2,
                       epsilon=epsilon)))


@_op("ftrl_update", (0, 2, 3), lamda1=0.01, beta=1.0, **dict(_COMMON, lr=0.1))
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0, **_ig):
    return _update(_fu.ftrl_fused_update, weight, grad, (z, n),
                   _hyper(lr, wd, rescale_grad, clip_gradient, lamda1=lamda1,
                          beta=beta))


@_op("ftml_update", (0, 2, 3, 4), lr=0.0025, beta1=0.6, beta2=0.999,
     epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=-1.0)
def _ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=-1.0,
                 **_ig):
    return _update(_fu.ftml_fused_update, weight, grad, (d, v, z),
                   _hyper(lr, wd, rescale_grad, clip_grad, beta1=beta1,
                          one_minus_beta1=1 - beta1, beta2=beta2,
                          one_minus_beta2=1 - beta2, epsilon=epsilon,
                          d_coef=(1 - beta1 ** t) / lr,
                          v_coef=1 - beta2 ** t))


@_op("signsgd_update", (0,), **_COMMON)
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, **_ig):
    return _update(_fu.signum_fused_update, weight, grad, (),
                   _hyper(lr, wd, rescale_grad, clip_gradient))


@_op("signum_update", (0, 2), momentum=0.0, wd_lh=0.0, **_COMMON)
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0, **_ig):
    return _update(_fu.signum_fused_update, weight, grad, (mom,),
                   _hyper(lr, wd, rescale_grad, clip_gradient,
                          momentum=momentum, one_minus_momentum=1 - momentum,
                          wdlh_coef=1 - lr * wd_lh, lr_wd=lr * wd))


@_op("mp_sgd_update", (0, 2), lazy_update=True, **_COMMON)
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, **_ig):
    """Mixed-precision SGD: the float32 master ``weight32`` updated, the
    weight its rounding (reference: optimizer_op.cc MP_SGD)."""
    return _update(_fu.sgd_fused_update, weight, grad, (),
                   _hyper(lr, wd, rescale_grad, clip_gradient), weight32)


@_op("mp_sgd_mom_update", (0, 2, 3), momentum=0.0, lazy_update=True,
     **_COMMON)
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, **_ig):
    """Mixed-precision SGD with momentum (float32 ``mom``)."""
    return _update(_fu.sgd_fused_update, weight, grad, (mom,),
                   _hyper(lr, wd, rescale_grad, clip_gradient,
                          momentum=momentum), weight32)
