"""LinSys model: solve (A + reg·I)W = B.

Port of the base solve of ``rlaopt_tpu/models/linsys.py``: B promoted to
2-D, per-column absolute/relative residual metrics from a true residual,
the solver's recurrence residual or sampled rows; every convergence claim
made from an estimator is confirmed on a true residual, with the confirm
gap, the exponential backoff and the stall certificate of the reference.
The confirm state lives in one :class:`_MetricsState` per solve.

Not ported yet: float64 refinement (``f64_refine_rounds > 0``, slice 2),
checkpoints (``checkpoint_dir``) and wandb logging.
"""

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from .model import Model
from ..linops.base import LinOp
from ..linops.types import _is_linop_or_tensor
from ..solvers import Solver, _get_solver, _is_solver_config
from ..utils.checkers import (
    _as_generator,
    _is_callable,
    _is_nonneg_float,
    _is_tensor,
)
from ..utils.linalg import hmm
from ..utils.logger import Logger


__all__ = ["LinSys"]


@dataclass
class _MetricsState:
    """Where a solve's metrics come from and what its confirms have shown.

    gap: measured (true / estimator) ratio of the last confirm; estimator
        metrics are reported multiplied by it, and the next confirm fires
        only when that prediction clears the tolerance.
    backoff: extra contraction demanded after stalled confirms (doubles per
        stalled failure, up to 64; any progress resets it to 1).
    stall_confirms: consecutive confirms that failed on a flat true residual.
    stalled: set once the stall certificate holds; the solve then stops at
        the operator floor (never a convergence claim).
    """

    solver: Solver
    atol: float
    rtol: float
    recurrence: bool = False
    sampled: bool = False
    sample_round: int = 0
    gap: float = 1.0
    backoff: float = 1.0
    last_confirm_true: Optional[float] = None
    stall_confirms: int = 0
    stalled: bool = False


class LinSys(Model):
    """Positive-definite linear system (A + reg·I)W = B."""

    def __init__(
        self,
        A,
        B: torch.Tensor,
        reg: float = 0.0,
        A_row_oracle: Optional[Callable] = None,
        A_blk_oracle: Optional[Callable] = None,
    ):
        """Args:
        A: LinOp or dense matrix.
        B: right-hand side (n,) or (n, k).
        reg: nonnegative ridge regularization.
        A_row_oracle: ``blk → K[blk, :]`` operator; paired with A_blk_oracle.
        A_blk_oracle: ``blk → K[blk, blk]`` operator.
        """
        self._check_inputs(A, B, reg, A_row_oracle, A_blk_oracle)
        self._A = A
        self._B = B[:, None] if B.ndim == 1 else B
        self._reg = reg
        self._A_row_oracle = A_row_oracle
        self._A_blk_oracle = A_blk_oracle
        self._mask = torch.ones(
            (self._B.shape[1],), dtype=torch.bool, device=self._B.device
        )
        self._ms: Optional[_MetricsState] = None
        self.stalled = False
        self.phase_walls = {}

    @property
    def A(self):
        return self._A

    @property
    def B(self):
        return self._B

    @property
    def reg(self):
        return self._reg

    @property
    def A_row_oracle(self):
        return self._A_row_oracle

    @property
    def A_blk_oracle(self):
        return self._A_blk_oracle

    @property
    def mask(self):
        return self._mask

    def _check_inputs(
        self, A: Any, B: Any, reg: Any, A_row_oracle: Any, A_blk_oracle: Any
    ):
        _is_linop_or_tensor(A, "A")
        _is_tensor(B, "B")
        _is_nonneg_float(reg, "reg")
        if A_row_oracle is not None:
            _is_callable(A_row_oracle, "A_row_oracle")
        if A_blk_oracle is not None:
            _is_callable(A_blk_oracle, "A_blk_oracle")
        if (A_row_oracle is None) != (A_blk_oracle is None):
            raise ValueError(
                "A_row_oracle and A_blk_oracle must be provided together"
            )

    def _apply_A(self, W):
        if isinstance(self._A, LinOp):
            return self._A @ W
        return hmm(self._A, W)

    def _b_norms(self):
        return torch.linalg.norm(self._B, dim=0)

    def _tol(self, ms: _MetricsState):
        return torch.clamp(ms.rtol * self._b_norms(), min=ms.atol)

    def _compute_internal_metrics(self, W: torch.Tensor, force_true: bool = False):
        ms = self._ms
        est_abs = None
        raw_abs = None  # estimator before the gap adjustment (stall evidence)
        if not force_true and ms.recurrence:
            raw_abs = torch.linalg.norm(ms.solver.residual(), dim=0)
            abs_res = raw_abs * ms.gap
            if not bool(torch.all(abs_res * ms.backoff <= self._tol(ms))):
                return {
                    "abs_res": abs_res,
                    "rel_res": abs_res / self._b_norms(),
                    "source": "recurrence",
                }
            est_abs = abs_res
        if not force_true and ms.sampled:
            # Unbiased estimate from s uniformly sampled rows:
            # E[(n/s)·Σ r_i²] = ‖r‖², ~1/√(2s) relative standard error.
            n = self._B.shape[0]
            s = min(4096, n)
            ms.sample_round += 1
            rng = np.random.default_rng((0x5A17 << 32) ^ ms.sample_round)
            idx = torch.as_tensor(
                np.sort(rng.choice(n, size=s, replace=False)), device=W.device
            )
            if self._A_row_oracle is not None:
                Kr = self._A_row_oracle(idx) @ W
            else:  # dense operand (validated at solve time)
                Kr = hmm(self._A[idx], W)
            r = self._B[idx] - (Kr + self._reg * W[idx])
            raw_abs = torch.linalg.norm(r, dim=0) * (n / s) ** 0.5
            abs_est = raw_abs * ms.gap
            if not bool(torch.all(abs_est * 0.7 * ms.backoff <= self._tol(ms))):
                return {
                    "abs_res": abs_est,
                    "rel_res": abs_est / self._b_norms(),
                    "source": "sampled",
                    "rel_stderr_est": (2.0 * s) ** -0.5,
                }
            est_abs = abs_est
        m = self._true_internal_metrics(W)
        if est_abs is not None:
            self._record_confirm(ms, m, est_abs, raw_abs, W.dtype)
        return m

    def _record_confirm(self, ms, m, est_abs, raw_abs, dtype):
        """Update the confirm state after a true residual checked a claim.

        A confirm that fails on a flat true residual (within 0.77 of the
        last) doubles the backoff. The stall certificate holds after two
        such confirms with the raw estimator ≥10x below tolerance — a
        signature only an operator-precision floor shows — or after four.
        The last true metrics then carry ``stalled: True``.
        """
        ratio = m["abs_res"] / torch.clamp(est_abs, min=torch.finfo(dtype).tiny)
        ms.gap = max(ms.gap * float(torch.max(ratio)), 1.0)
        tol = self._tol(ms)
        failed = not bool(torch.all(m["abs_res"] <= tol))
        cur = float(torch.max(m["abs_res"]))
        prev = ms.last_confirm_true
        if failed and prev is not None and cur > 0.77 * prev:
            ms.backoff = min(ms.backoff * 2.0, 64.0)
            ms.stall_confirms += 1
            raw_far_below = raw_abs is not None and bool(
                torch.all(raw_abs <= 0.1 * tol)
            )
            if (ms.stall_confirms >= 2 and raw_far_below) or ms.stall_confirms >= 4:
                ms.stalled = True
                m["stalled"] = True
        else:
            ms.backoff = 1.0
            ms.stall_confirms = 0
        ms.last_confirm_true = cur

    def _true_internal_metrics(self, W: torch.Tensor):
        """Residual metrics from a full operator apply (the ground truth).

        f32 kernel operators evaluate compensated: ``hi + lo`` carries the
        matmat's cross-tile rounding errors, and ``lo`` is subtracted last.
        """
        if W.dtype == torch.float32 and hasattr(self._A, "matmat_compensated"):
            hi, lo = self._A.matmat_compensated(W)
            R = (self._B - self._reg * W - hi) - lo
        else:
            R = self._B - (self._apply_A(W) + self._reg * W)
        abs_res = torch.linalg.norm(R, dim=0)
        return {"abs_res": abs_res, "rel_res": abs_res / self._b_norms()}

    def _check_termination_criteria(
        self, internal_metrics: dict, atol: float, rtol: float
    ) -> bool:
        abs_res = internal_metrics["abs_res"]
        comp_tol = torch.clamp(rtol * self._b_norms(), min=atol)
        # Estimator-sourced metrics freeze a column only at 0.5× tolerance
        # and never decide termination; a certified stall terminates.
        estimated = internal_metrics.get("source") in ("recurrence", "sampled")
        self._mask = abs_res > (0.5 * comp_tol if estimated else comp_tol)
        if internal_metrics.get("stalled"):
            return True
        if estimated:
            return False
        return bool(torch.all(abs_res <= comp_tol))

    def solve(
        self,
        solver_config,
        W_init: torch.Tensor,
        callback_fn: Optional[Callable] = None,
        callback_args: Optional[list] = None,
        callback_kwargs: Optional[dict] = None,
        callback_freq: int = 10,
        log_in_wandb: bool = False,
        wandb_init_kwargs: Optional[dict] = None,
        key=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_freq: Optional[int] = None,
        resume: bool = False,
        f64_refine_rounds: int = 0,
        f64_refine_device: str = "cpu",
        f64_refine_residual: str = "evaluate",
        f64_refine_certify: str = "full",
        preconditioner=None,
        metrics: str = "auto",
    ):
        """Solve the system; returns ``(solution, log)``.

        The keywords are the JAX package's. ``metrics``: ``"true"``
        evaluates a true residual at every logging boundary;
        ``"recurrence"`` reads the solver's carried residual and confirms
        every convergence claim on a true one; ``"auto"`` picks recurrence
        when n ≥ 2**17 and the solver carries a residual; ``"sampled"``
        estimates from 4096 sampled rows (needs ``A_row_oracle`` or a dense
        operand). ``key`` (int seed, ``torch.Generator`` or None) seeds the
        preconditioner sketch. ``preconditioner`` supplies a prebuilt one.

        A certified stall is reported as ``model.stalled`` and as
        ``stalled: True`` in the final iteration's metrics; the log's keys
        stay iteration numbers. ``model.phase_walls`` holds the wall-clock
        seconds of solver set-up (sketch and factorization included) and of
        the iterations.
        """
        if f64_refine_rounds > 0:
            raise NotImplementedError(
                "f64_refine_rounds > 0: float64 refinement is slice 2 of the "
                "port (ROADMAP Queue 1, item 9)"
            )
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint_dir: utils/checkpoint.py is not ported yet "
                "(ROADMAP Queue 1, item 13)"
            )
        _is_solver_config(solver_config, "solver_config")
        _is_tensor(W_init, "W_init")
        if W_init.ndim == 1:
            W_init = W_init[:, None]
        if W_init.shape != self._B.shape:
            raise ValueError(
                f"W_init shape {tuple(W_init.shape)} does not match the "
                f"right-hand side shape {tuple(self._B.shape)}"
            )
        if log_in_wandb and wandb_init_kwargs is None:
            raise ValueError(
                "wandb_init_kwargs must be specified if log_in_wandb is True"
            )
        if log_in_wandb:
            raise NotImplementedError(
                "wandb logging is not ported yet (utils/wandb_.py)"
            )
        if metrics not in ("auto", "true", "recurrence", "sampled"):
            raise ValueError(
                "metrics must be one of 'auto', 'true', 'recurrence', "
                f"'sampled', but received {metrics!r}"
            )
        if metrics == "sampled" and self._A_row_oracle is None and isinstance(
            self._A, LinOp
        ):
            raise ValueError(
                "metrics='sampled' needs row access: an A_row_oracle or a "
                "dense operand"
            )

        self._mask = torch.ones(
            (self._B.shape[1],), dtype=torch.bool, device=self._B.device
        )
        atol, rtol = solver_config.atol, solver_config.rtol

        def termination_fn(internal_metrics):
            return self._check_termination_criteria(internal_metrics, atol, rtol)

        logger = Logger(
            log_freq=callback_freq,
            log_fn=self._get_log_fn(
                callback_fn, callback_args or [], callback_kwargs or {}
            ),
        )

        t_init = time.perf_counter()
        solver = _get_solver(
            model=self, W_init=W_init, solver_config=solver_config,
            key=_as_generator(key), preconditioner=preconditioner,
        )
        _sync(self._B)
        phase_walls = {"solver_init": round(time.perf_counter() - t_init, 3)}
        self._ms = _MetricsState(
            solver=solver,
            atol=atol,
            rtol=rtol,
            recurrence=(
                metrics == "recurrence"
                or (metrics == "auto" and self._B.shape[0] >= (1 << 17))
            ) and solver.residual() is not None,
            sampled=metrics == "sampled",
        )

        t_train = time.perf_counter()
        solution, log = self._train(
            logger=logger,
            termination_fn=termination_fn,
            solver=solver,
            max_iters=solver_config.max_iters,
        )
        _sync(self._B)
        phase_walls["train"] = round(time.perf_counter() - t_train, 3)
        self.phase_walls = phase_walls
        self.stalled = bool(self._ms.stalled)
        return solution, log


def _sync(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
