"""Frobenius-norm estimation (port of
``rlaopt_tpu/spectral_estimators/frobenius_norm.py``): tr(AᵀA) = ‖A‖²_F by
Hutchinson on the (ncols, ncols) Gram operator."""

from typing import Optional, Tuple

import torch

from .trace import hutchinson
from ..linops.base import LinOp, SymmetricLinOp


__all__ = ["fro_norm_est"]


def fro_norm_est(
    A,
    k: int,
    sketch: str = "gauss",
    key=None,
    Omega: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimate (‖A‖²_F, variance) via Hutchinson on G = AᵀA; ``Omega``
    (k, ncols) as in :func:`hutchinson`."""
    if isinstance(A, LinOp):
        n = A.shape[1]

        def mv(v):
            return A.T @ (A @ v)

        G = SymmetricLinOp((n, n), matvec=mv, matmat=mv, dtype=A.dtype, device=A.device)
    else:
        G = A.T @ A
    return hutchinson(G, k, sketch, key, Omega=Omega)
