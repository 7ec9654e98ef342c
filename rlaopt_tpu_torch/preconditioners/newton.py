"""Newton preconditioner.

Port of ``rlaopt_tpu/preconditioners/newton.py``: ``L = chol(A + ρI)``,
``P x = L(Lᵀx)``, ``P⁻¹x`` by two triangular solves. The functional core
(:func:`newton_update`, :func:`newton_apply`, :func:`newton_apply_inv`) is
what SAP calls on every block; a failed factorization gives an all-NaN
factor, as ``jnp.linalg.cholesky`` does, so that SAP skips the block.
"""

import torch

from .base import Preconditioner
from .configs import NewtonConfig
from ..utils.linalg import (
    cholesky_or_nan,
    densify,
    hmm,
    solve_tri_lower,
    solve_tri_upper,
)


__all__ = ["Newton", "newton_update", "newton_apply", "newton_apply_inv"]


def newton_update(A_dense: torch.Tensor, rho) -> torch.Tensor:
    """Cholesky factor of A + ρI (lower); all NaN if it fails."""
    n = A_dense.shape[0]
    eye = torch.eye(n, dtype=A_dense.dtype, device=A_dense.device)
    return cholesky_or_nan(A_dense + rho * eye)


def newton_apply(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P x = L (Lᵀ x)."""
    return hmm(L, hmm(L.T, x))


def newton_apply_inv(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P⁻¹ x via two triangular solves."""
    x_in = x[:, None] if x.ndim == 1 else x
    out = solve_tri_upper(L.T, solve_tri_lower(L, x_in))
    return out[:, 0] if x.ndim == 1 else out


class Newton(Preconditioner):
    """Exact (damped) Newton preconditioner.

    Attributes:
        L: lower Cholesky factor of A + ρI.
    """

    def __init__(self, config: NewtonConfig):
        super().__init__(config)
        self.L = None

    def _update(self, A, *args, key=None, **kwargs):
        self.L = newton_update(densify(A), self.config.rho)

    def _matmul(self, x):
        return newton_apply(self.L, x)

    def _inverse_matmul_1d(self, x):
        return newton_apply_inv(self.L, x)

    def _inverse_matmul_2d(self, x):
        return newton_apply_inv(self.L, x)
