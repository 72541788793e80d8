"""Contrib samplers (reference: gluon/contrib/data/)."""
from .sampler import IntervalSampler  # noqa: F401
