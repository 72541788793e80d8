"""Contrib operators: CTC.

Counterpart of the CTC part of the JAX package's ``ops/contrib_ops.py``
(:238-323; reference: src/operator/contrib/ctc_loss.cc). The JAX op is a
``lax.scan`` forward algorithm in log space that XLA compiles; here the
same negative log likelihood is ``F.ctc_loss`` (a CUDA kernel on the
card, ATen on the host), after the same ``log_softmax`` and relabelling.
The file's other ops (ROI, detection, transformer helpers) are ROADMAP
A15.

One case differs by construction: for an alignment that cannot exist
(more labels, with their repeats, than time steps) torch gives ``inf``
where the JAX recursion's ``-1e30`` floor gives a loss of about 1e30.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
