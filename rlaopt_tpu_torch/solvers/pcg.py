"""Block preconditioned conjugate gradient.

Port of ``rlaopt_tpu/solvers/pcg.py`` with the same iterates:

* **Masked embedding.** Every iteration computes full-width updates and
  embeds the masked sub-solves: with column mask m and M = P_ᵀAP_, the
  solve over the masked submatrix equals solving
  ``(M ⊙ mmᵀ + diag(1−m)) α = RZ ⊙ mmᵀ``, so α has zero rows and columns
  off-mask.
* **Breakdown guard.** A column whose RᵀZ diagonal stops being positive and
  finite is frozen (``ok``), and a chunk that ends with a frozen active
  column restarts from a true residual (``_resync``).
* **Chunks.** ``_run_chunk(n)`` is a Python loop of n steps with one host
  sync at its end (the breakdown check), never one per step.

The preconditioner enters as the JAX package's pair ``(inv_fn, pstate)``:
``inv_fn(pstate, R)`` is P⁻¹R (``Preconditioner._functional_inverse``).
"""

from typing import NamedTuple, TYPE_CHECKING

import torch

from .solver import Solver
from ..linops.base import LinOp
from ..preconditioners import PreconditionerConfig, _get_precond
from ..utils.checkers import _as_generator
from ..utils.linalg import hmm
from ..utils.profiling import annotate_sync, count, traced

if TYPE_CHECKING:
    from ..models import LinSys


__all__ = ["PCG", "PCGState", "pcg_init", "pcg_step"]


class PCGState(NamedTuple):
    W: torch.Tensor
    R: torch.Tensor
    Z: torch.Tensor
    P_: torch.Tensor
    RZ: torch.Tensor
    ok: torch.Tensor  # per-column health: False once CG breaks down


def _op_mm(A, X):
    """A @ X for a LinOp or a dense operand."""
    if isinstance(A, LinOp):
        return A @ X
    return hmm(A, X)


def _is_zero(W: torch.Tensor) -> bool:
    """Whether the init iterate is exactly zero (one host sync)."""
    with annotate_sync("rlaopt.sync.is_zero", W):
        return not bool(torch.any(W != 0))


def pcg_init(A, B, reg, W, inv_fn, pstate, w_zero: bool = False) -> PCGState:
    """R = B − (A + reg·I)W;  Z = P⁻¹R;  P_ = Z;  RZ = RᵀZ.

    For f32 kernel operators the residual is evaluated compensated
    (``matmat_compensated``), so residual-replacement restarts converge to
    the compensated floor. ``w_zero=True`` asserts W == 0, so R = B and no
    operator apply runs.
    """
    if w_zero:
        R = B
    elif B.dtype == torch.float32 and hasattr(A, "matmat_compensated"):
        hi, lo = A.matmat_compensated(W)
        R = (B - reg * W - hi) - lo
    else:
        R = B - (_op_mm(A, W) + reg * W)
    Z = inv_fn(pstate, R)
    RZ = hmm(R.T, Z)
    ok = torch.ones((W.shape[1],), dtype=torch.bool, device=W.device)
    return PCGState(W=W, R=R, Z=Z, P_=Z, RZ=RZ, ok=ok)


def _masked_embed(M, m):
    """Embed the masked submatrix of M as a block-identity full matrix."""
    return M * torch.outer(m, m) + torch.diag(1.0 - m)


def _safe_solve(M, B):
    """Solve M X = B with a relative-eps ridge on M.

    Near convergence the small k×k systems become numerically singular in
    f32; the eps·max|diag| ridge keeps the solve finite while perturbing
    well-conditioned systems at rounding level. On a card
    ``torch.linalg.solve`` waits for the device (its singularity check).
    """
    k = M.shape[0]
    delta = torch.finfo(M.dtype).eps * torch.max(torch.abs(torch.diagonal(M)))
    eye = torch.eye(k, dtype=M.dtype, device=M.device)
    with annotate_sync("rlaopt.sync.safe_solve", M):
        return torch.linalg.solve(M + delta * eye, B)


@traced("rlaopt.pcg.step")
def pcg_step(A, reg, inv_fn, pstate, state: PCGState, mask) -> PCGState:
    """One masked PCG iteration (full-width, mask-frozen columns).

    Columns are active when unconverged (``mask``) and healthy
    (``state.ok``).
    """
    dtype = state.W.dtype
    active = mask & state.ok
    m = active.to(dtype)
    mm = torch.outer(m, m)

    AP = _op_mm(A, state.P_) + reg * state.P_
    M = _masked_embed(hmm(state.P_.T, AP), m)
    alpha = _safe_solve(M, state.RZ * mm)  # zero rows/cols off-mask

    W = state.W + hmm(state.P_, alpha) * m[None, :]
    R = state.R - hmm(AP, alpha) * m[None, :]

    Z_new = inv_fn(pstate, R)
    Z = torch.where(active[None, :], Z_new, state.Z)

    RZ_new = hmm(R.T, Z_new) * mm
    beta = _safe_solve(_masked_embed(state.RZ, m), RZ_new)
    P_ = torch.where(active[None, :], Z_new + hmm(state.P_, beta), state.P_)

    # Per-column health check on the candidate state.
    col_finite = (
        torch.all(torch.isfinite(W), dim=0)
        & torch.all(torch.isfinite(R), dim=0)
        & torch.all(torch.isfinite(P_), dim=0)
        & torch.all(torch.isfinite(RZ_new), dim=0)
    )
    col_pd = torch.diagonal(RZ_new) > 0
    healthy = torch.where(active, col_finite & col_pd, state.ok)

    # Freeze columns that just went unhealthy: keep the previous state there.
    keep = (~active | healthy)[None, :]
    W = torch.where(keep, W, state.W)
    R = torch.where(keep, R, state.R)
    Z = torch.where(keep, Z, state.Z)
    P_ = torch.where(keep, P_, state.P_)
    hh = torch.outer(healthy, healthy)
    RZ_out = torch.where(hh, RZ_new, torch.zeros_like(RZ_new))
    return PCGState(W=W, R=R, Z=Z, P_=P_, RZ=RZ_out, ok=healthy)


class PCG(Solver):
    """PCG solver over a :class:`~rlaopt_tpu_torch.models.LinSys` system."""

    def __init__(
        self,
        system: "LinSys",
        W_init: torch.Tensor,
        precond_config: PreconditionerConfig,
        key=None,
        preconditioner=None,
    ):
        self.system = system
        self.precond_config = precond_config
        self._key = _as_generator(key)
        # A prebuilt preconditioner (same operator and reg) skips the sketch.
        self.P = (
            preconditioner if preconditioner is not None
            else self._get_precond()
        )
        self._inv_fn, self._pstate = self.P._functional_inverse()
        self._reg = system.reg
        W0 = W_init[:, None] if W_init.ndim == 1 else W_init
        self.state = pcg_init(
            system.A, system.B, self._reg, W0, self._inv_fn, self._pstate,
            w_zero=_is_zero(W0),
        )

    @property
    def W(self):
        return self.state.W

    def residual(self):
        """Carried recurrence residual R (see ``Solver.residual``)."""
        return self.state.R

    def _get_precond(self):
        P = _get_precond(self.precond_config)
        P._update(self.system.A, key=self._key)
        P._update_damping(baseline_rho=self.system.reg)
        return P

    def _step(self):
        self._run_chunk(1)

    def _resync(self):
        """Restart from the current iterate with a freshly computed residual
        (residual replacement): one extra operator apply."""
        count("rlaopt.pcg.resyncs")
        self.state = pcg_init(
            self.system.A, self.system.B, self._reg, self.state.W, self._inv_fn, self._pstate
        )

    def _run_chunk(self, n_steps: int):
        A, mask = self.system.A, self.system.mask
        for _ in range(n_steps):
            self.state = pcg_step(A, self._reg, self._inv_fn, self._pstate, self.state, mask)
        # Breakdown in any active column → restart with a true residual.
        with annotate_sync("rlaopt.sync.breakdown", mask):
            healthy = bool(torch.all(self.state.ok | ~mask))
        if not healthy:
            self._resync()
