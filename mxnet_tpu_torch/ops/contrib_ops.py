"""Contrib operators: CTC and flash attention.

Counterpart of the CTC part of the JAX package's ``ops/contrib_ops.py``
(:238-323; reference: src/operator/contrib/ctc_loss.cc). The JAX op is a
``lax.scan`` forward algorithm in log space that XLA compiles; here the
same negative log likelihood is ``F.ctc_loss`` (a CUDA kernel on the
card, ATen on the host), after the same ``log_softmax`` and relabelling.
``_contrib_flash_attention`` (:360-372) runs the port's
``flash_attention`` kernels, forward and backward. The file's other ops
(ROI, detection, the other transformer helpers) are ROADMAP A15.

One case differs by construction: for an alignment that cannot exist
(more labels, with their repeats, than time steps) torch gives ``inf``
where the JAX recursion's ``-1e30`` floor gives a loss of about 1e30.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda.flash_attention import flash_attention
from .registry import alias, register


@register("CTCLoss", attr_defaults={"use_data_lengths": False,
                                    "use_label_lengths": False,
                                    "blank_label": "first"})
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first", **_ig):
    """CTC loss a sequence (reference: contrib/ctc_loss.cc). ``data`` is
    (T, N, A) raw activations (softmax applied inside, as the reference
    does), ``label`` (N, L). With ``blank_label="first"`` the blank is
    class 0 and labels are 1..A-1 padded with 0 (or -1); with "last" the
    blank is A-1 and labels are 0-based, padded with -1. Without
    ``use_label_lengths`` a label's length is its count of classes."""
    T, N, A = data.shape
    if data.device.type == "meta":
        return data.new_empty((N,))
    log_probs = torch.log_softmax(data, dim=-1)
    labels = label.to(torch.int64)
    if blank_label == "last":
        # move the blank from A-1 to 0; classes shift up by one
        log_probs = torch.cat([log_probs[..., A - 1:], log_probs[..., :A - 1]],
                              dim=-1)
        labels = labels + 1
    if use_data_lengths and data_lengths is not None:
        in_lens = data_lengths.to(torch.int64)
    else:
        in_lens = torch.full((N,), T, dtype=torch.int64, device=data.device)
    if use_label_lengths and label_lengths is not None:
        lab_lens = label_lengths.to(torch.int64)
    else:
        lab_lens = (labels > 0).sum(dim=-1)
    return F.ctc_loss(log_probs, labels.clamp(min=0), in_lens, lab_lens,
                      blank=0, reduction="none", zero_infinity=False)


alias("_contrib_CTCLoss", "CTCLoss")
alias("ctc_loss", "CTCLoss")
alias("_contrib_ctc_loss", "CTCLoss")


@register("_contrib_flash_attention", attr_defaults={"causal": False,
                                                     "sm_scale": None,
                                                     "block_q": 128,
                                                     "block_k": 128,
                                                     "interpret": None})
def _flash_attention_op(q, k, v, causal=False, sm_scale=None, block_q=128,
                        block_k=128, interpret=None, **_ig):
    """Flash attention over q (batch, heads, s_q, head_dim) and k, v
    (batch, heads, s_k, head_dim): ``softmax(q k^T * sm_scale) v``,
    causal as ``kpos <= qpos`` (reference: the fused attention of
    src/operator/contrib/transformer-inl.h). ``sm_scale`` defaults to
    1/sqrt(head_dim). The ``flash_attention`` kernel runs the forward and
    ``flash_attention_bwd`` the gradients on the card (the plain versions
    on the host). ``block_q``, ``block_k`` and ``interpret`` are the TPU
    kernel's tile sizes and interpreter switch: accepted, and of no
    effect on this card, whose kernels pick their own tiles."""
    del block_q, block_k, interpret
    if q.device.type == "meta":
        return torch.empty_like(q)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=bool(causal),
                           sm_scale=None if sm_scale is None
                           else float(sm_scale))
