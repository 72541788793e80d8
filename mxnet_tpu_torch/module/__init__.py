"""Module API (reference: python/mxnet/module/): ``Module`` on one
device. Bucketing, sequential and Python modules come with ROADMAP A8.6."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
