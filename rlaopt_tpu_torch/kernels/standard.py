"""Standard kernel operator classes (port of ``rlaopt_tpu/kernels/standard.py``):
one (single, sharded) class pair per kernel family, and the ``Distributed*``
aliases of the reference API."""

from .factory import _create_kernel_classes


__all__ = [
    "RBFLinOp",
    "ShardedRBFLinOp",
    "DistributedRBFLinOp",
    "LaplaceLinOp",
    "ShardedLaplaceLinOp",
    "DistributedLaplaceLinOp",
    "Matern12LinOp",
    "ShardedMatern12LinOp",
    "DistributedMatern12LinOp",
    "Matern32LinOp",
    "ShardedMatern32LinOp",
    "DistributedMatern32LinOp",
    "Matern52LinOp",
    "ShardedMatern52LinOp",
    "DistributedMatern52LinOp",
]


RBFLinOp, ShardedRBFLinOp = _create_kernel_classes("RBF", "rbf")
LaplaceLinOp, ShardedLaplaceLinOp = _create_kernel_classes("Laplace", "laplace")
Matern12LinOp, ShardedMatern12LinOp = _create_kernel_classes("Matern12", "matern12")
Matern32LinOp, ShardedMatern32LinOp = _create_kernel_classes("Matern32", "matern32")
Matern52LinOp, ShardedMatern52LinOp = _create_kernel_classes("Matern52", "matern52")

# Reference-API aliases
DistributedRBFLinOp = ShardedRBFLinOp
DistributedLaplaceLinOp = ShardedLaplaceLinOp
DistributedMatern12LinOp = ShardedMatern12LinOp
DistributedMatern32LinOp = ShardedMatern32LinOp
DistributedMatern52LinOp = ShardedMatern52LinOp
