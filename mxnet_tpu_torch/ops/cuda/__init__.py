"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), built with
``nvcc`` at first use (``_build``) and bound with ctypes. Importing this
package builds nothing and touches no GPU.

Each kernel module keeps its own ``CUDA_KERNELS`` registry and
``LAUNCHES`` counters: ``flash_attention`` (the attention kernels of
decode serving and transformer training), ``fused_update`` (the
optimizer updates of ``Module.fit``), ``int8_matmul`` (the int8
matmul and convolution of quantized serving; import them from
the module, whose name is also its first kernel's) and ``batch_norm``
(BatchNorm with the moving statistics, in every scoring forward)."""
from . import batch_norm as _bn
from . import flash_attention as _fa
from . import fused_update as _fu
from . import int8_matmul as _i8
from .flash_attention import (CUDA_KERNELS, LAUNCHES, flash_prefill_paged,
                              paged_decode_attention, reset_launches)
from .fused_update import adam_fused_update, sgd_fused_update

# every module that registers CUDA kernels
KERNEL_MODULES = (_fa, _fu, _i8, _bn)

__all__ = ["CUDA_KERNELS", "LAUNCHES", "KERNEL_MODULES", "adam_fused_update",
           "flash_prefill_paged", "paged_decode_attention", "reset_launches",
           "sgd_fused_update"]
