"""Preconditioned LSQR for (damped) least squares.

Port of ``rlaopt_tpu/solvers/lsqr.py``: Paige–Saunders LSQR with damping
rotations, vectorized over right-hand-side columns, with a per-column
convergence mask. Paired with :class:`~rlaopt_tpu_torch.preconditioners.SkPre`,
whose Cholesky factor L (G = ΩA → L Lᵀ = (ΩA)ᵀ(ΩA) + ρI) right-preconditions
the operator as Â = A L⁻ᵀ (sketch-and-precondition least squares).

A step has no host test: the mask and the zero-division guards are
``torch.where``. ``_run_chunk(n)`` is a plain loop of n steps; the model's
logging boundary after it is the chunk's one sync.
"""

from typing import NamedTuple, TYPE_CHECKING

import torch

from .solver import Solver
from ..linops.base import LinOp
from ..preconditioners import (
    IdentityConfig,
    PreconditionerConfig,
    SkPreConfig,
    _get_precond,
)
from ..utils.checkers import _as_generator
from ..utils.linalg import hmm, solve_tri_lower, solve_tri_upper

if TYPE_CHECKING:
    from ..models import LstSq


__all__ = ["LSQR", "LSQRState"]

VALID_PRECONDS = (IdentityConfig, SkPreConfig)


class LSQRState(NamedTuple):
    Y: torch.Tensor  # solution in preconditioned space (n, k)
    U: torch.Tensor  # (m, k)
    V: torch.Tensor  # (n, k)
    W: torch.Tensor  # (n, k) direction
    alpha: torch.Tensor  # (k,)
    phibar: torch.Tensor  # (k,)
    rhobar: torch.Tensor  # (k,)


def _colnorm(X):
    return torch.sqrt(torch.sum(X * X, dim=0))


def _safe_div(num, den):
    return num / torch.where(den == 0, torch.ones_like(den), den)


class LSQR(Solver):
    """LSQR over a :class:`~rlaopt_tpu_torch.models.LstSq` problem."""

    def __init__(
        self,
        system: "LstSq",
        W_init: torch.Tensor,
        precond_config: PreconditionerConfig,
        damp: float = 0.0,
        key=None,
        preconditioner=None,
    ):
        if not isinstance(precond_config, VALID_PRECONDS):
            raise TypeError(
                f"Valid preconditioner configs for LSQR are {VALID_PRECONDS}, "
                f"but received {type(precond_config)}"
            )
        self.system = system
        self.damp = damp
        self._key = _as_generator(key)
        self.precond_config = precond_config
        self.P = (
            preconditioner if preconditioner is not None
            else self._get_precond()
        )
        self._L = getattr(self.P, "L", None)  # None for Identity

        # LSQR starts its bidiagonalization from W = 0 (a nonzero W_init
        # would require shifting the right-hand side; as in scipy's lsqr).
        self.state = self._init_state()

    # preconditioned operator: Â v = A L⁻ᵀ v;  Âᵀ u = L⁻¹ Aᵀ u
    def _amv(self, V):
        A, L = self.system.A, self._L
        if L is not None:
            V = solve_tri_upper(L.T, V)
        return A @ V if isinstance(A, LinOp) else hmm(A, V)

    def _armv(self, U):
        A, L = self.system.A, self._L
        out = A.__rmatmul__(U.T).T if isinstance(A, LinOp) else hmm(A.T, U)
        if L is not None:
            out = solve_tri_lower(L, out)
        return out

    def _back_transform(self, Y):
        if self._L is not None:
            return solve_tri_upper(self._L.T, Y)
        return Y

    @property
    def W(self):
        return self._back_transform(self.state.Y)

    def _get_precond(self):
        P = _get_precond(self.precond_config)
        P._update(self.system.A, key=self._key)
        return P

    def _init_state(self) -> LSQRState:
        B = self.system.B
        beta = _colnorm(B)
        U = _safe_div(B, beta[None, :])
        V_raw = self._armv(U)
        alpha = _colnorm(V_raw)
        V = _safe_div(V_raw, alpha[None, :])
        return LSQRState(
            Y=torch.zeros((V.shape[0], B.shape[1]), dtype=B.dtype, device=B.device),
            U=U,
            V=V,
            W=V,
            alpha=alpha,
            phibar=beta,
            rhobar=alpha,
        )

    def _step_fn(self, s: LSQRState, mask) -> LSQRState:
        dtype = s.Y.dtype
        m = mask.to(dtype)[None, :]
        damp = torch.tensor(self.damp, dtype=dtype, device=s.Y.device)

        # bidiagonalization
        U_raw = self._amv(s.V) - s.alpha[None, :] * s.U
        beta = _colnorm(U_raw)
        U = _safe_div(U_raw, beta[None, :])
        V_raw = self._armv(U) - beta[None, :] * s.V
        alpha = _colnorm(V_raw)
        V = _safe_div(V_raw, alpha[None, :])

        # damping rotation
        rhobar1 = torch.sqrt(s.rhobar**2 + damp**2)
        c1 = _safe_div(s.rhobar, rhobar1)
        phibar = c1 * s.phibar

        # main rotation
        rho = torch.sqrt(rhobar1**2 + beta**2)
        c = _safe_div(rhobar1, rho)
        sn = _safe_div(beta, rho)
        theta = sn * alpha
        rhobar = -c * alpha
        phi = c * phibar
        phibar = sn * phibar

        Y = s.Y + _safe_div(phi, rho)[None, :] * s.W * m
        Wd = V - _safe_div(theta, rho)[None, :] * s.W

        keep = mask[None, :]
        return LSQRState(
            Y=torch.where(keep, Y, s.Y),
            U=torch.where(keep, U, s.U),
            V=torch.where(keep, V, s.V),
            W=torch.where(keep, Wd, s.W),
            alpha=torch.where(mask, alpha, s.alpha),
            phibar=torch.where(mask, phibar, s.phibar),
            rhobar=torch.where(mask, rhobar, s.rhobar),
        )

    def _step(self):
        self._run_chunk(1)

    def _run_chunk(self, n_steps: int):
        mask = self.system.mask
        for _ in range(n_steps):
            self.state = self._step_fn(self.state, mask)
