"""Kernel class factory (port of ``rlaopt_tpu/kernels/factory.py``).

One named single-device operator class per kernel family. The sharded
variants wait for the port of ``kernels/sharded.py``.
"""

import torch

from .configs import KernelConfig
from .linop import KernelLinOp


__all__ = ["_create_kernel_class"]


def _create_kernel_class(kernel_name: str, kind: str) -> type:
    """Create the ``{Name}LinOp`` class for a kernel family."""

    def init(
        self,
        A1: torch.Tensor,
        A2: torch.Tensor,
        kernel_config: KernelConfig,
        compute_dtype=None,
    ):
        KernelLinOp.__init__(
            self, A1, A2, kernel_config, kind=kind, compute_dtype=compute_dtype
        )

    return type(
        f"{kernel_name}LinOp",
        (KernelLinOp,),
        {
            "__init__": init,
            "__doc__": f"{kernel_name} kernel Gram operator (matrix-free).",
        },
    )
