"""Module API (reference: python/mxnet/module/): ``Module`` on one
device and ``BucketingModule`` over it. The sequential and Python modules
come with ROADMAP A8.6."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ["BaseModule", "BucketingModule", "Module"]
