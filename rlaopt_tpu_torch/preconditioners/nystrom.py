"""Randomized Nyström preconditioner.

Port of ``rlaopt_tpu/preconditioners/nystrom.py``, keeping:

* the eps·trace(Core) stabilization shift before the core Cholesky,
* the low-precision inverse through an extra Cholesky of
  ``ρ·diag(S⁻¹) + UᵀU``, taken whenever the operator dtype is not float64,
* the S floor at eps·ρ in that Cholesky (S entries at the max(σ²−shift, 0)
  floor would make ρ·S⁻¹ infinite),
* adaptive damping ``ρ ← baseline + S[-1]``,
* NaN factors, not an error, when a factorization fails (as
  ``jnp.linalg.cholesky`` gives), so that SAP skips a degenerate block.

The sketch product ``Y = A @ Ω`` is the one Gram product here: on a card
it runs through the general CUDA kernel (Ω has ``rank`` columns).
"""

import warnings
from typing import NamedTuple, Optional

import torch

from .base import Preconditioner
from .configs import NystromConfig
from .enums import _DampingMode
from ..sketches.embeddings import right_embedding
from ..utils.checkers import _as_generator
from ..utils.linalg import (
    as_matmat,
    cholesky_or_nan,
    hmm,
    solve_tri_lower,
    solve_tri_upper,
)
from ..utils.profiling import annotate_sync, traced


__all__ = [
    "Nystrom",
    "NystromFactors",
    "nystrom_update",
    "nystrom_damping",
    "nystrom_inv_chol",
    "nystrom_apply",
    "nystrom_apply_inv",
]


class NystromFactors(NamedTuple):
    """Rank-r Nyström eigen-factors: A ≈ U diag(S) Uᵀ."""

    U: torch.Tensor  # (n, r) left singular vectors
    S: torch.Tensor  # (r,)  nonneg eigenvalue estimates


def nystrom_update(
    A_mm,
    n: int,
    rank: int,
    sketch: str,
    key,
    dtype: torch.dtype,
    device=None,
    _route: Optional[str] = None,
    Omega: Optional[torch.Tensor] = None,
) -> NystromFactors:
    """Build the Nyström approximation of an SPD operator.

    Args:
        A_mm: callable X ↦ A @ X (n×r matmat through the operator).
        n: operator dimension.
        rank: sketch rank r.
        sketch: sketch family name for the range finder.
        key: ``torch.Generator`` (unused when ``Omega`` is given).
        dtype, device: of the sketch; ``device`` None is the CUDA card.
        _route: test hook — "eigh" or "svd" instead of the n > 64·rank rule.
        Omega: an (n, r) sketch to use in place of a fresh draw, so that
            tests can hand both packages the same one.
    """
    if rank > n:
        warnings.warn(
            f"Nyström sketch rank {rank} exceeds the operator dimension "
            f"{n}; clamping to {n} (rank-n is already exact).",
            stacklevel=2,
        )
        rank = n
    if Omega is None:
        Omega = right_embedding(sketch, key, rank, n, dtype, device)  # (n, r)
    rank = Omega.shape[1]
    Y = A_mm(Omega)  # (n, r)
    Core = hmm(Omega.T, Y)  # (r, r)
    eps = torch.finfo(dtype).eps
    shift = eps * torch.trace(Core)
    eye = torch.eye(rank, dtype=dtype, device=Core.device)
    L = cholesky_or_nan(Core + shift * eye)
    B = solve_tri_lower(L, Y.T)  # (r, n)
    # eigh and svd raise on NaN: factor a stand-in and return NaN factors
    ok = torch.all(torch.isfinite(B))
    B = torch.where(ok, B, torch.zeros_like(B))
    # On a card the copy of a host value and the factorizations' error
    # checks wait for the device.
    with annotate_sync("rlaopt.sync.nystrom", Core):
        nan = torch.tensor(float("nan"), dtype=dtype, device=Core.device)
    use_eigh = n > 64 * rank if _route is None else _route == "eigh"
    if use_eigh:
        # B Bᵀ = V diag(σ²) Vᵀ  ⇒  U = Bᵀ V diag(1/σ): one (r, r) eigh and
        # one extra (n, r) product instead of an (n, r) SVD.
        G = hmm(B, B.T) + torch.where(ok, 0.0, 1.0) * eye
        with annotate_sync("rlaopt.sync.nystrom", G):
            evals, V = torch.linalg.eigh(G)
        evals = torch.flip(evals, (0,))
        V = torch.flip(V, (1,))
        sig = torch.sqrt(torch.clamp(evals, min=0.0))
        inv_sig = torch.where(
            sig > eps * torch.max(sig), 1.0 / sig, torch.zeros_like(sig)
        )
        U = hmm(B.T, V * inv_sig[None, :])
        S = torch.clamp(evals - shift, min=0.0)
        return NystromFactors(U=torch.where(ok, U, nan), S=torch.where(ok, S, nan))
    with annotate_sync("rlaopt.sync.nystrom", B):
        U, Svals, _ = torch.linalg.svd(B.T, full_matrices=False)
    S = torch.clamp(Svals**2 - shift, min=0.0)
    return NystromFactors(U=torch.where(ok, U, nan), S=torch.where(ok, S, nan))


def nystrom_damping(S: torch.Tensor, rho, baseline_rho, adaptive: bool):
    """Final damping: baseline + λ_min(approx) in adaptive mode, else rho."""
    if adaptive:
        return baseline_rho + S[-1]
    return rho


def nystrom_inv_chol(U: torch.Tensor, S: torch.Tensor, rho) -> torch.Tensor:
    """Low-precision factor: chol(ρ·diag(S⁻¹) + UᵀU), S floored at eps·ρ."""
    finfo = torch.finfo(S.dtype)
    rho_t = torch.as_tensor(rho, dtype=S.dtype, device=S.device)
    floor = finfo.eps * torch.clamp(rho_t, min=finfo.tiny)
    S_safe = torch.maximum(S, floor)
    M = rho_t * torch.diag(S_safe**-1.0) + hmm(U.T, U)
    return cholesky_or_nan(M)


def nystrom_apply(f: NystromFactors, rho, x: torch.Tensor) -> torch.Tensor:
    """P x = U diag(S) Uᵀ x + ρ x."""
    x_in = x[:, None] if x.ndim == 1 else x
    out = hmm(f.U, f.S[:, None] * hmm(f.U.T, x_in)) + rho * x_in
    return out[:, 0] if x.ndim == 1 else out


def nystrom_apply_inv(
    f: NystromFactors,
    rho,
    x: torch.Tensor,
    L: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """P⁻¹ x.

    With ``L`` (low-precision path): (1/ρ)(x − U (LLᵀ)⁻¹ Uᵀ x).
    Without: (1/ρ)(x − UUᵀx) + U (S+ρ)⁻¹ Uᵀ x.
    """
    x_in = x[:, None] if x.ndim == 1 else x
    UTx = hmm(f.U.T, x_in)
    if L is not None:
        y = solve_tri_upper(L.T, solve_tri_lower(L, UTx))
        out = (1.0 / rho) * (x_in - hmm(f.U, y))
    else:
        out = (1.0 / rho) * (x_in - hmm(f.U, UTx)) + hmm(
            f.U, UTx / (f.S + rho)[:, None]
        )
    return out[:, 0] if x.ndim == 1 else out


class Nystrom(Preconditioner):
    """Randomized Nyström preconditioner.

    Attributes:
        U, S: Nyström eigen-factors.
        rho: effective damping (config.rho, or baseline + S[-1] after an
            adaptive ``_update_damping``).
        L: the low-precision inverse factor (built lazily), or None.
    """

    def __init__(self, config: NystromConfig):
        super().__init__(config)
        self.U = None
        self.S = None
        self.rho = config.rho
        self.low_precision = False
        self.L = None

    @traced("rlaopt.nystrom.build")
    def _update(self, A, *args, key=None, Omega=None, **kwargs):
        dtype = A.dtype
        self.low_precision = dtype != torch.float64
        f = nystrom_update(
            as_matmat(A), A.shape[1], self.config.rank, self.config.sketch,
            _as_generator(key), dtype, A.device, Omega=Omega,
        )
        self.U, self.S = f.U, f.S
        self.rho = self.config.rho
        self.L = None

    def _factors(self) -> NystromFactors:
        return NystromFactors(U=self.U, S=self.S)

    def _matmul(self, x):
        return nystrom_apply(self._factors(), self.rho, x)

    def _ensure_L(self):
        if self.low_precision and self.L is None:
            self.L = nystrom_inv_chol(self.U, self.S, self.rho)

    @traced("rlaopt.nystrom.apply")
    def _inverse_matmul_1d(self, x):
        self._ensure_L()
        return nystrom_apply_inv(self._factors(), self.rho, x, self.L)

    @traced("rlaopt.nystrom.apply")
    def _inverse_matmul_2d(self, x):
        self._ensure_L()
        return nystrom_apply_inv(self._factors(), self.rho, x, self.L)

    def _update_damping(self, baseline_rho: float) -> None:
        """ρ ← baseline + S[-1] in adaptive mode; invalidates the factor L."""
        if self.config.damping_mode == _DampingMode.ADAPTIVE:
            self.rho = nystrom_damping(self.S, self.rho, baseline_rho, adaptive=True)
            self.L = None
