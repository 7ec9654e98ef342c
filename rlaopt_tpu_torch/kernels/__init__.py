"""Kernel Gram operators: RBF / Laplace / Matérn, single device."""

from .configs import KernelConfig, _is_kernel_config  # noqa: F401
from .functions import KERNEL_KINDS, kernel_tile  # noqa: F401
from .linop import KernelLinOp  # noqa: F401
from .standard import *  # noqa: F401,F403
from . import standard as _standard

__all__ = [
    "KernelConfig",
    "KERNEL_KINDS",
    "kernel_tile",
    "KernelLinOp",
] + list(_standard.__all__)
