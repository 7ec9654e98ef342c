"""Matrix-free linear operators (single device)."""

from .base import LinOp, TwoSidedLinOp, SymmetricLinOp, aslinop  # noqa: F401
from .types import LinOpType, _is_linop_or_tensor, is_linop  # noqa: F401
from .enums import _DistributionMode  # noqa: F401

__all__ = [
    "LinOp",
    "TwoSidedLinOp",
    "SymmetricLinOp",
    "aslinop",
    "LinOpType",
    "is_linop",
]
