"""Kernel class factory (port of ``rlaopt_tpu/kernels/factory.py``).

One named class pair per kernel family: the single-device operator and the
mesh-sharded one (:mod:`rlaopt_tpu_torch.kernels.sharded`).
"""

from typing import Tuple

import torch

from .configs import KernelConfig
from .linop import KernelLinOp
from .sharded import ShardedKernelLinOp


__all__ = ["_create_kernel_classes"]


def _create_kernel_classes(kernel_name: str, kind: str) -> Tuple[type, type]:
    """Create the ``{Name}LinOp`` and ``Sharded{Name}LinOp`` classes."""

    def single_init(
        self,
        A1: torch.Tensor,
        A2: torch.Tensor,
        kernel_config: KernelConfig,
        impl: str = "auto",
        compute_dtype=None,
    ):
        KernelLinOp.__init__(
            self, A1, A2, kernel_config, kind=kind, impl=impl,
            compute_dtype=compute_dtype,
        )

    single = type(
        f"{kernel_name}LinOp",
        (KernelLinOp,),
        {
            "__init__": single_init,
            "__doc__": f"{kernel_name} kernel Gram operator (matrix-free).",
        },
    )

    def sharded_init(
        self,
        A1: torch.Tensor,
        A2: torch.Tensor,
        kernel_config: KernelConfig,
        mesh=None,
        axis="i",
        impl: str = "auto",
        use_full_kernel: bool = True,
        memory_mode: str = "replicated",
        compute_dtype=None,
    ):
        ShardedKernelLinOp.__init__(
            self, A1, A2, kernel_config, kind=kind, mesh=mesh, axis=axis,
            impl=impl, use_full_kernel=use_full_kernel, memory_mode=memory_mode,
            compute_dtype=compute_dtype,
        )

    sharded = type(
        f"Sharded{kernel_name}LinOp",
        (ShardedKernelLinOp,),
        {
            "__init__": sharded_init,
            "__doc__": (
                f"{kernel_name} kernel Gram operator, row-sharded over a "
                "device mesh."
            ),
        },
    )
    return single, sharded
