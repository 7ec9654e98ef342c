"""Matrix-free linear operators, single device and sharded over a mesh."""

from .base import LinOp, TwoSidedLinOp, SymmetricLinOp, aslinop  # noqa: F401
from .types import LinOpType, _is_linop_or_tensor, is_linop  # noqa: F401
from .enums import _DistributionMode  # noqa: F401
from .sharded import (  # noqa: F401
    DistributedLinOp,
    DistributedSymmetricLinOp,
    DistributedTwoSidedLinOp,
    ShardedLinOp,
)

__all__ = [
    "LinOp",
    "TwoSidedLinOp",
    "SymmetricLinOp",
    "aslinop",
    "ShardedLinOp",
    "DistributedLinOp",
    "DistributedTwoSidedLinOp",
    "DistributedSymmetricLinOp",
    "LinOpType",
    "is_linop",
]
