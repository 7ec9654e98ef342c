"""Kernel Gram operators: RBF / Laplace / Matérn, single device and sharded
over a mesh."""

from .configs import KernelConfig, _is_kernel_config  # noqa: F401
from .functions import KERNEL_KINDS, kernel_tile  # noqa: F401
from .linop import KernelLinOp  # noqa: F401
from .sharded import ShardedKernelLinOp  # noqa: F401
from .standard import *  # noqa: F401,F403
from . import standard as _standard

__all__ = [
    "KernelConfig",
    "KERNEL_KINDS",
    "kernel_tile",
    "KernelLinOp",
    "ShardedKernelLinOp",
] + list(_standard.__all__)
