"""Operators of the PyTorch/CUDA package: the registry, the creation,
elementwise, reduction, shape / indexing and neural-network ops of the
JAX package's five core op files, the fused RNN op, CTC
(``contrib_ops``), the quantization ops and the optimizer updates
(importing this package populates the registry), and ``ops.cuda``, the
kernels written by hand for Hopper."""
from . import registry
from . import creation  # noqa: F401
from . import elemwise  # noqa: F401
from . import matrix    # noqa: F401
from . import nn        # noqa: F401
from . import reduce    # noqa: F401
from . import quantization_ops  # noqa: F401
from . import contrib_ops  # noqa: F401
from . import cuda
from . import optimizer_ops  # noqa: F401
from .registry import OpDef, alias, get_op, invoke, list_ops, register

__all__ = ["cuda", "registry", "OpDef", "alias", "get_op", "invoke",
           "list_ops", "register"]
