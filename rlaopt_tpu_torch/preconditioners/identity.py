"""Identity preconditioner (port of ``rlaopt_tpu/preconditioners/identity.py``)."""

import torch

from .base import Preconditioner
from .configs import IdentityConfig


__all__ = ["Identity"]


class Identity(Preconditioner):
    """No-op preconditioner: forward and inverse both return the input."""

    def __init__(self, config: IdentityConfig):
        super().__init__(config)

    def _update(self, A, *args, key=None, **kwargs):
        pass

    def _matmul(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def _inverse_matmul_1d(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def _inverse_matmul_2d(self, x: torch.Tensor) -> torch.Tensor:
        return x
