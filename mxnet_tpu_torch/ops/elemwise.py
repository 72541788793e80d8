"""Elementwise operators of the ResNet path: ``elemwise_add``, the
residual ``+`` of two symbols (the JAX package's ``ops/elemwise.py``
aliases it to ``broadcast_add``; the rest of that file is ROADMAP A15)."""
from __future__ import annotations

from .registry import alias, register


@register("broadcast_add")
def _broadcast_add(a, b):
    return a + b


alias("elemwise_add", "broadcast_add")
