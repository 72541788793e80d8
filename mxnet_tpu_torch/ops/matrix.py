"""Shape operators of the ResNet path (the JAX package's ``ops/matrix.py``
:117 Flatten; the rest of that file is ROADMAP A15)."""
from __future__ import annotations

from .registry import alias, register


@register("Flatten")
def _flatten(x):
    return x.reshape(x.shape[0], -1)


alias("flatten", "Flatten")
