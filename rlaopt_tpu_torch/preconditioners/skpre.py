"""Sketch-and-precondition preconditioner.

Port of ``rlaopt_tpu/preconditioners/skpre.py``: left sketch Y = ΩA,
G = YᵀY (+ρI), L = chol(G); forward P x = Lᵀ(L x); inverse via two
triangular solves. Warns when the sketch size is below ncols. A failed
factorization gives an all-NaN factor, as ``jnp.linalg.cholesky`` does.
"""

from warnings import warn

import torch

from .base import Preconditioner
from .configs import SkPreConfig
from ..sketches.embeddings import sketch_apply_left
from ..utils.checkers import _as_generator
from ..utils.linalg import cholesky_or_nan, hmm, solve_tri_lower, solve_tri_upper


__all__ = ["SkPre", "skpre_update", "skpre_apply", "skpre_apply_inv"]


# -- functional core ---------------------------------------------------------
def skpre_update(Y: torch.Tensor, rho) -> torch.Tensor:
    """Cholesky factor of G = YᵀY + ρI from the sketched matrix Y (s, d)."""
    G = hmm(Y.T, Y)
    d = G.shape[0]
    G = G + rho * torch.eye(d, dtype=G.dtype, device=G.device)
    return cholesky_or_nan(G)


def skpre_apply(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P x = Lᵀ (L x) — matches the reference's operator ordering."""
    return hmm(L.T, hmm(L, x))


def skpre_apply_inv(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P⁻¹ x = L⁻¹ L⁻ᵀ x."""
    unsqueeze = x.ndim == 1
    x_in = x[:, None] if unsqueeze else x
    y = solve_tri_upper(L.T, x_in)
    out = solve_tri_lower(L, y)
    return out[:, 0] if unsqueeze else out


# -- OO shell -----------------------------------------------------------------
class SkPre(Preconditioner):
    """Sketched preconditioner for overdetermined least-squares systems.

    Attributes:
        L: lower Cholesky factor of the sketched Gram matrix.
    """

    def __init__(self, config: SkPreConfig):
        super().__init__(config)
        self.L = None

    def _update(self, A, *args, key=None, **kwargs):
        if self.config.sketch_size < A.shape[1]:
            warn(
                f"Sketch size ({self.config.sketch_size}) is smaller than "
                f"the number of columns in input matrix A ({A.shape[1]}). "
                "This may lead to a poor and/or unstable approximation."
            )
        # Y = Ω @ A, structure-exploiting (SRHT on a dense A takes the fast
        # transform; an operator gets (Aᵀ Ωᵀ)ᵀ with Ωᵀ drawn in its layout).
        Y = sketch_apply_left(
            self.config.sketch, _as_generator(key), self.config.sketch_size, A,
            A.dtype,
        )
        self.L = skpre_update(Y, self.config.rho)

    def _matmul(self, x):
        return skpre_apply(self.L, x)

    def _inverse_matmul_1d(self, x):
        return skpre_apply_inv(self.L, x)

    def _inverse_matmul_2d(self, x):
        return skpre_apply_inv(self.L, x)
