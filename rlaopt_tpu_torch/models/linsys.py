"""LinSys model: solve (A + reg·I)W = B.

Port of ``rlaopt_tpu/models/linsys.py``: B promoted to 2-D, per-column
absolute/relative residual metrics from a true residual, the solver's
recurrence residual or sampled rows; every convergence claim made from an
estimator is confirmed on a true residual, with the confirm gap, the
exponential backoff and the stall certificate of the reference. The confirm
state lives in one :class:`_MetricsState` per solve.

Mixed-precision float64 refinement (``f64_refine_rounds > 0``) follows the
reference round for round: the three residual modes, both certify modes,
the update-mode guard and the sampled certificate's host second opinion.
Its float64 residuals run through
:func:`rlaopt_tpu_torch.ops.kernel_dispatch.kernel_matmat_f64` (the CUDA
kernels K7 and K8 on a card) in place of the two-float value64 engine. The
samplers fold a draw counter into their seeds, so two certificates of one
solve draw different rows (the reference reuses one fixed seed). A sharded
kernel operator (:class:`~rlaopt_tpu_torch.kernels.sharded.
ShardedKernelLinOp`) refines through its own mesh routes: its float64 ring
(``matmat_f64``: K7 and K8 at the positions, the points left where they
are), its compensated product and its column-distributed float64 rows.
"""

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from .model import Model, _wrap_sparse
from ..linops.base import LinOp
from ..linops.types import _is_linop_or_tensor
from ..solvers import Solver, _get_solver, _get_solver_name, _is_solver_config
from ..utils.checkers import (
    _as_generator,
    _is_callable,
    _is_nonneg_float,
    _is_tensor,
)
from ..utils.checkpoint import SolveCheckpointer
from ..utils.linalg import hmm
from ..utils.logger import Logger
from ..utils.profiling import annotate, annotate_sync, count, traced
from ..utils.rng import fold_in


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


@dataclass(frozen=True)
class _RefineConfig:
    """The four ``f64_refine_*`` keywords of :meth:`LinSys.solve`."""

    rounds: int = 0
    device: str = "cpu"
    residual: str = "evaluate"
    certify: str = "full"


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
        A: LinOp, dense matrix or sparse tensor (wrapped as an operator).
        B: right-hand side (n,) or (n, k).
        reg: nonnegative ridge regularization.
        A_row_oracle: ``blk → K[blk, :]`` operator; paired with A_blk_oracle.
        A_blk_oracle: ``blk → K[blk, blk]`` operator.
        """
        self._check_inputs(A, B, reg, A_row_oracle, A_blk_oracle)
        self._A = _wrap_sparse(A)
        self._B = B[:, None] if B.ndim == 1 else B
        self._reg = reg
        self._A_row_oracle = A_row_oracle
        self._A_blk_oracle = A_blk_oracle
        self._mask = torch.ones(
            (self._B.shape[1],), dtype=torch.bool, device=self._B.device
        )
        self._ms: Optional[_MetricsState] = None
        self._sample_draws = 0  # refinement samplers' draws (seed counter)
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

    @traced("rlaopt.linsys.metrics")
    def _compute_internal_metrics(self, W: torch.Tensor, force_true: bool = False):
        """A boundary's residual metrics. Counters: ``rlaopt.metrics.recurrence``
        and ``.sampled`` (an estimate reported), ``.true`` (a true residual),
        ``.confirm`` (a true residual that checked an estimate's claim) and
        ``.stall`` (the stall certificate)."""
        ms = self._ms
        est_abs = None
        raw_abs = None  # estimator before the gap adjustment (stall evidence)
        if not force_true and ms.recurrence:
            raw_abs = torch.linalg.norm(ms.solver.residual(), dim=0)
            abs_res = raw_abs * ms.gap
            with annotate_sync("rlaopt.sync.metrics", abs_res):
                claimed = bool(torch.all(abs_res * ms.backoff <= self._tol(ms)))
            if not claimed:
                count("rlaopt.metrics.recurrence")
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
            with annotate_sync("rlaopt.sync.metrics", W):
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
            with annotate_sync("rlaopt.sync.metrics", abs_est):
                claimed = bool(torch.all(abs_est * 0.7 * ms.backoff <= self._tol(ms)))
            if not claimed:
                count("rlaopt.metrics.sampled")
                return {
                    "abs_res": abs_est,
                    "rel_res": abs_est / self._b_norms(),
                    "source": "sampled",
                    "rel_stderr_est": (2.0 * s) ** -0.5,
                }
            est_abs = abs_est
        m = self._true_internal_metrics(W)
        count("rlaopt.metrics.true")
        if est_abs is not None:
            count("rlaopt.metrics.confirm")
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
        with annotate_sync("rlaopt.sync.metrics", ratio):
            ms.gap = max(ms.gap * float(torch.max(ratio)), 1.0)
        tol = self._tol(ms)
        with annotate_sync("rlaopt.sync.metrics", tol):
            failed = not bool(torch.all(m["abs_res"] <= tol))
        with annotate_sync("rlaopt.sync.metrics", tol):
            cur = float(torch.max(m["abs_res"]))
        prev = ms.last_confirm_true
        if failed and prev is not None and cur > 0.77 * prev:
            ms.backoff = min(ms.backoff * 2.0, 64.0)
            ms.stall_confirms += 1
            raw_far_below = False
            if raw_abs is not None:
                with annotate_sync("rlaopt.sync.metrics", raw_abs):
                    raw_far_below = bool(torch.all(raw_abs <= 0.1 * tol))
            if (ms.stall_confirms >= 2 and raw_far_below) or ms.stall_confirms >= 4:
                count("rlaopt.metrics.stall")
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
        with annotate_sync("rlaopt.sync.termination", abs_res):
            return bool(torch.all(abs_res <= comp_tol))

    @traced("rlaopt.linsys.solve")
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

        ``checkpoint_dir`` saves the solver state and the mask there every
        ``checkpoint_freq`` (default 1) logging rounds and at convergence
        (:class:`~rlaopt_tpu_torch.utils.checkpoint.SolveCheckpointer`);
        ``resume=True`` continues from the latest one. A resumed solve
        rebuilds its preconditioner from ``key`` and SAP draws its blocks
        from ``key`` and the iteration counter, so with the same ``key`` it
        repeats the uninterrupted solve; ``phase_walls`` then covers the
        resumed part only. ``log_in_wandb`` mirrors every log round to
        wandb, initialized with ``wandb_init_kwargs``.

        ``f64_refine_rounds > 0`` runs mixed-precision iterative refinement
        after the base solve (the reference's semantics): the residual is
        re-evaluated in float64, and correction systems are solved in the
        working precision with the base solve's preconditioner. The returned
        solution is then a float64 tensor, on the operator's device for
        ``f64_refine_device="accel"`` (float64 residuals through the CUDA
        kernels K7/K8 on a card) and on the CPU for ``"cpu"`` (the plain
        float64 version on the host). The log gains an ``"f64_refine"``
        entry (its only key that is not an iteration number) with the
        per-round float64 relative residuals, their ``residual_sources``,
        ``phase_walls`` and, where taken, ``sampled_certificate`` or
        ``update_check``. ``f64_refine_residual``: ``"evaluate"`` (a
        float64 residual after every correction), ``"update"`` (``R ← R −
        (A δ + reg δ)`` through the compensated kernel) or ``"hybrid"``
        (first round from the compensated residual); ``"update"`` and
        ``"hybrid"`` need a kernel operator and ``"accel"``.
        ``f64_refine_certify="sampled"`` (with ``"update"``/``"hybrid"``)
        certifies from float64 rows sampled through K8, accepted with a
        5-sigma margin and an independent host float64 second opinion, and
        falls back to a full evaluation otherwise.
        """
        if f64_refine_residual not in ("evaluate", "update", "hybrid"):
            raise ValueError(
                f"unknown f64_refine_residual {f64_refine_residual!r}"
            )
        refine = _RefineConfig(
            f64_refine_rounds, f64_refine_device, f64_refine_residual,
            f64_refine_certify,
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

        wandb_kwargs = self._get_wandb_kwargs(
            log_in_wandb=log_in_wandb,
            wandb_init_kwargs=wandb_init_kwargs,
            solver_name=_get_solver_name(solver_config),
            solver_config=solver_config,
            callback_freq=callback_freq,
        )
        logger = Logger(
            log_freq=callback_freq,
            log_fn=self._get_log_fn(
                callback_fn, callback_args or [], callback_kwargs or {}
            ),
            wandb_kwargs=wandb_kwargs,
        )

        t_init = time.perf_counter()
        with annotate("rlaopt.linsys.init"):
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

        checkpointer = None
        if checkpoint_dir is not None:
            checkpointer = SolveCheckpointer(checkpoint_dir)

        t_train = time.perf_counter()
        solution, log = self._train(
            logger=logger,
            termination_fn=termination_fn,
            solver=solver,
            max_iters=solver_config.max_iters,
            checkpointer=checkpointer,
            checkpoint_freq=checkpoint_freq or 1,
            resume=resume,
        )
        _sync(self._B)
        phase_walls["train"] = round(time.perf_counter() - t_train, 3)
        self.phase_walls = phase_walls
        self.stalled = bool(self._ms.stalled)
        if refine.rounds > 0:
            solution, log["f64_refine"] = self._refine_f64(
                solution, solver_config, refine, atol, rtol, callback_freq, key,
                preconditioner=getattr(solver, "P", None),
            )
        return solution, log

    # -- mixed-precision iterative refinement ---------------------------------
    def _kernel_op(self):
        """The kernel operator (single-device or sharded), or None."""
        from ..kernels.linop import KernelLinOp
        from ..kernels.sharded import ShardedKernelLinOp

        return self._A if isinstance(self._A, (KernelLinOp, ShardedKernelLinOp)) else None

    def _f64_matmat(self, device: str = "cpu"):
        """Float64 matmat ``W64 ↦ A @ W64`` for refinement, or None.

        ``"accel"`` evaluates on the operand's device (a kernel operator
        through :meth:`_value64_matmat`); anything else on the host, with
        the plain float64 version (a sharded operator's points gathered
        there once, as the JAX package does). The result lies where ``W64``
        is moved: the operand's device for ``"accel"``, the CPU otherwise.
        """
        op = self._kernel_op()
        if op is not None:
            if device == "accel":
                return self._value64_matmat(op)
            with annotate_sync("rlaopt.sync.refine", op.A1):
                X1, X2, ls = op.A1.cpu(), op.A2.cpu(), op.lengthscale64.cpu()
            symmetric = op.A1 is op.A2
            from ..ops.kernel_dispatch import kernel_matmat_f64

            def mm_host(W64):
                return kernel_matmat_f64(
                    op.kind, X1, X1 if symmetric else X2, W64.cpu(), ls,
                    op.const_scaling,
                )

            return mm_host
        if not isinstance(self._A, LinOp):
            A64 = self._A.double()
            if device != "accel":
                A64 = _moved(A64, "cpu", torch.float64)
            return lambda W64: A64 @ W64.to(A64.device)
        return None

    def _compensated_update_matmat(self, device: str):
        """``δ ↦ A @ δ`` (float64 out) through the compensated kernel (K1c),
        for residual UPDATES inside refinement; None unless refining a
        kernel operator on ``"accel"``."""
        op = self._kernel_op()
        if device != "accel" or op is None:
            return None

        def mm(delta):
            hi, lo = op.matmat_compensated(delta.to(op.device, torch.float32))
            return hi.double() + lo.double()

        return mm

    def _value64_matmat(self, op):
        """Float64 kernel matmat on the operator's device: one call of
        :func:`kernel_matmat_f64` (K7 on one data set, K8 otherwise), W64
        taken in float64 as it is (no hi/lo split: the card has FP64); a
        sharded operator's ``matmat_f64`` over its mesh."""
        from ..kernels.sharded import ShardedKernelLinOp
        from ..ops.kernel_dispatch import kernel_matmat_f64

        if isinstance(op, ShardedKernelLinOp):
            return op.matmat_f64

        @traced("rlaopt.linop.matmat_f64")
        def mm(W64):
            return kernel_matmat_f64(
                op.kind, op.A1, op.A2, W64.to(op.device, torch.float64),
                op.lengthscale64, op.const_scaling, symmetric=op.A1 is op.A2,
            )

        return mm

    def _sample_rows(self, salt: int, n: int, s: int) -> np.ndarray:
        """s sorted distinct rows of n, from a seed that folds in a draw
        counter: every draw of a solve takes other rows."""
        self._sample_draws += 1
        rng = np.random.default_rng([salt ^ n, self._sample_draws])
        return np.sort(rng.choice(n, size=s, replace=False))

    def _sampled_f64_residual(self, W64, s: int = None):
        """Host float64 residual on ``s`` sampled rows.

        Returns ``(est_abs, rel_stderr)``: ``est_abs`` (numpy, per column)
        the unbiased estimate of ``‖B − (A+reg·I)W64‖`` from s uniform rows
        (E[(n/s)·Σ r_i²] = ‖r‖²), evaluated with the plain float64 version
        on the CPU, independent of every kernel. None if the operand has no
        host-evaluable rows.
        """
        n = self._B.shape[0]
        m = self._A.shape[1]
        if s is None:
            # value budget ~4e8 kernel evaluations on the host
            s = int(np.clip(4e8 // max(m, 1), 64, 4096))
        s = min(s, n)
        idx = torch.as_tensor(self._sample_rows(0xF64C, n, s))
        W = _moved(W64, "cpu", torch.float64)
        op = self._kernel_op()
        if op is not None:
            from ..ops.kernel_plain import gram_matmat_f64

            with annotate_sync("rlaopt.sync.refine", op.A1):
                X1, X2, ls = op.A1.cpu(), op.A2.cpu(), op.lengthscale64.cpu()
            K_rows_W = gram_matmat_f64(op.kind, X1[idx], X2, W, ls, op.const_scaling)
        elif not isinstance(self._A, LinOp):
            K_rows_W = _moved(self._A, "cpu", torch.float64)[idx] @ W
        else:
            return None
        B = _moved(self._B, "cpu", torch.float64)
        r = B[idx] - (K_rows_W + float(self._reg) * W[idx])
        est = torch.linalg.norm(r, dim=0).numpy() * (n / s) ** 0.5
        return est, (2.0 / s) ** 0.5

    def _sampled_value64_residual(self, W64, s: int = 8192, seed: int = 0x64):
        """Unbiased per-column residual-norm estimate from s sampled rows
        with float64 kernel values (K8 through
        :func:`~rlaopt_tpu_torch.ops.kernel_dispatch.kernel_matmat_f64`):
        the only uncertainty is the sampling noise, ~(2s)^-1/2 relative; a
        sharded operator's rows are column-distributed over its mesh
        (``row_matmat_f64``). Returns ``(est_abs, rel_stderr)`` or None for
        operands without a value64 route (d above ``VALUE64_MAX_D``, the JAX
        package's guard)."""
        from ..kernels.sharded import ShardedKernelLinOp
        from ..ops.kernel_dispatch import kernel_matmat_f64
        from ..ops.kernel_value64 import VALUE64_MAX_D

        op = self._kernel_op()
        if op is None or op.A1.shape[1] > VALUE64_MAX_D:
            return None
        n = self._B.shape[0]
        s = min(s, n)
        idx = _moved(torch.as_tensor(self._sample_rows(seed, n, s)), op.device, torch.int64)
        W = W64.to(op.device, torch.float64)
        if isinstance(op, ShardedKernelLinOp):
            rows = op.row_matmat_f64(idx, W)
        else:
            rows = kernel_matmat_f64(
                op.kind, op.A1[idx], op.A2, W, op.lengthscale64, op.const_scaling
            )
        r = self._B[idx].double() - (rows + float(self._reg) * W[idx])
        with annotate_sync("rlaopt.sync.refine", r):
            est = torch.linalg.norm(r, dim=0).cpu().numpy() * (n / s) ** 0.5
        return est, (2.0 * s) ** -0.5

    @traced("rlaopt.refine")
    def _refine_f64(
        self, W, solver_config, refine: _RefineConfig, atol, rtol,
        callback_freq, key, preconditioner=None,
    ):
        """Refinement loop (see ``solve``); returns (W64, per-round log).
        Spans: each float64 residual (``rlaopt.refine.residual``) and each
        correction solve (``rlaopt.refine.correction``), from where its
        ``phase_walls`` entry starts to where it is taken."""
        device, certify = refine.device, refine.certify
        mm64 = self._f64_matmat(device)
        if mm64 is None:
            raise ValueError(
                "f64 refinement needs a dense matrix or kernel operator"
            )
        hybrid = refine.residual == "hybrid"
        mm_update = (
            self._compensated_update_matmat(device)
            if refine.residual in ("update", "hybrid")
            else None
        )
        if hybrid and mm_update is None:
            raise ValueError(
                "f64_refine_residual='hybrid' needs a kernel operator with "
                "f64_refine_device='accel'"
            )
        if certify not in ("full", "sampled"):
            raise ValueError(f"unknown f64_refine_certify {certify!r}")
        if certify == "sampled" and mm_update is None:
            raise ValueError(
                "f64_refine_certify='sampled' requires "
                "f64_refine_residual='hybrid' or 'update' (a kernel "
                "operator with f64_refine_device='accel')"
            )
        op = self._kernel_op()
        home = (
            (op.device if op is not None else self._A.device)
            if device == "accel" else torch.device("cpu")
        )
        B64 = _moved(self._B, home, torch.float64)
        reg = float(self._reg)

        def col_norms(R):
            with annotate_sync("rlaopt.sync.refine", R):
                return torch.linalg.norm(R, dim=0).cpu().numpy()

        b_norms = col_norms(B64)
        tol_abs = np.maximum(rtol * b_norms, atol)
        W64 = _moved(W, home, torch.float64)

        def since(t0):
            """Seconds since t0, once the work queued on ``home`` is done
            (a residual on the card is launched, not finished, on return)."""
            _sync(B64)
            return round(time.perf_counter() - t0, 3)

        def certificate():
            """The sampled value64 claim, if it clears the tolerance with a
            5-sigma margin: ``(est, stderr)`` or None."""
            sv = self._sampled_value64_residual(W64)
            if sv is not None and np.all(sv[0] * (1.0 + 5.0 * sv[1]) <= tol_abs):
                return sv
            return None

        hist, sources = [], []
        walls = {"residual_f64": [], "correction_solve": []}
        R64 = None
        # need_eval: R64 does not hold a claim-grade residual for the
        # current W64; a full evaluation must come before any claim.
        need_eval = True
        src = None
        sampled_claim = None
        for rnd in range(refine.rounds):
            with annotate("rlaopt.refine.residual"):
                t0 = time.perf_counter()
                if rnd == 0 and hybrid:
                    # The first residual only steers: the compensated exact-f32
                    # residual resolves the f32 operator floor; the next round's
                    # full evaluation certifies.
                    R64 = B64 - (mm_update(W64.to(W.dtype)) + reg * W64)
                    src = "compensated_f32"
                elif need_eval or mm_update is None:
                    if certify == "sampled" and rnd > 0:
                        sampled_claim = certificate()
                        if sampled_claim is not None:
                            est = sampled_claim[0]
                            src = "value64_sampled"
                            sources.append(src)
                            walls["residual_f64"].append(since(t0))
                            hist.append((est / b_norms).tolist())
                            need_eval = False
                            break
                    R64 = B64 - (mm64(W64) + reg * W64)
                    src = "evaluate"
                else:
                    src = "update"  # R64 was residual-updated below
                need_eval = False
                sources.append(src)
                walls["residual_f64"].append(since(t0))
            res = col_norms(R64)
            rel = res / b_norms
            hist.append(rel.tolist())
            if np.all(res <= tol_abs):
                if src == "compensated_f32":
                    # a cheap estimate cannot certify: evaluate next round
                    need_eval = True
                    continue
                break
            # Same operator, reg and oracles as the base solve; the base
            # solve's factor is reused.
            corr = LinSys(
                self._A,
                _moved(R64, W.device, W.dtype),
                reg=reg,
                A_row_oracle=self._A_row_oracle,
                A_blk_oracle=self._A_blk_oracle,
            )
            # The outer error contracts by about the correction solve's own
            # relative residual, so it only needs rtol ≈ target / current.
            tol_rel = np.maximum(rtol, atol / np.maximum(b_norms, 1e-300))
            needed = float(np.min(tol_rel / np.maximum(rel, 1e-300))) * 0.3
            corr_cfg = dataclasses.replace(
                solver_config, rtol=float(np.clip(needed, 1e-7, 0.5)), atol=0.0
            )
            with annotate("rlaopt.refine.correction"):
                t0 = time.perf_counter()
                delta, _ = corr.solve(
                    corr_cfg,
                    torch.zeros_like(corr.B),
                    callback_freq=callback_freq,
                    key=fold_in(_as_generator(key), rnd + 1),
                    preconditioner=preconditioner,
                )
                _sync(delta)
                walls["correction_solve"].append(since(t0))
            delta64 = _moved(delta, home, torch.float64)
            W64 = W64 + delta64
            if mm_update is None or (hybrid and src == "compensated_f32") or (
                certify == "sampled"
            ):
                # The next residual must be a full evaluation (with
                # certify="sampled", the certificate is tried first).
                need_eval = True
            else:
                # R_new = b − A(W+δ) = R − (A δ + reg δ), A δ through K1c:
                # its f32 kernel-value error enters scaled by ‖A δ‖ ≈ ‖R‖.
                with annotate("rlaopt.refine.residual"):
                    t0 = time.perf_counter()
                    R64 = R64 - (mm_update(delta) + reg * delta64)
                    walls["residual_f64"].append(since(t0))
                src = "update"
        if need_eval and certify == "sampled" and sampled_claim is None:
            # out of rounds right after a correction: try the certificate
            # before paying for the full evaluation
            with annotate("rlaopt.refine.residual"):
                t0 = time.perf_counter()
                sampled_claim = certificate()
                if sampled_claim is not None:
                    src = "value64_sampled"
                    sources.append(src)
                    walls["residual_f64"].append(since(t0))
                    hist.append((sampled_claim[0] / b_norms).tolist())
                    need_eval = False
        out = {"rel_res_f64": hist, "residual_sources": sources, "phase_walls": walls}
        if sampled_claim is not None:
            # Independent host float64 second opinion (other rows, other
            # arithmetic); on disagreement beyond the combined noise, fall
            # back to the full evaluation.
            est, stderr = sampled_claim
            cert_log = {"claim_rel": (est / b_norms).tolist(), "rel_stderr": stderr}
            t0 = time.perf_counter()
            chk = self._sampled_f64_residual(W64)
            if chk is not None:
                h_est, h_stderr = chk
                cert_log["host_sampled_rel"] = (h_est / b_norms).tolist()
                cert_log["host_rel_stderr"] = h_stderr
                cert_log["host_wall_s"] = since(t0)
                margin = 1.0 + 5.0 * (stderr + h_stderr)
                if bool(np.any(h_est > margin * np.maximum(est, 1e-300))) or not bool(
                    np.all(h_est * (1.0 - 5.0 * h_stderr) <= tol_abs)
                ):
                    with annotate("rlaopt.refine.residual"):
                        t0 = time.perf_counter()
                        R64 = B64 - (mm64(W64) + reg * W64)
                        walls["residual_f64"].append(since(t0))
                    cert_log["refreshed"] = True
                    sources.append("evaluate")
                    hist.append((col_norms(R64) / b_norms).tolist())
                else:
                    cert_log["refreshed"] = False
            out["sampled_certificate"] = cert_log
            return W64, out
        if need_eval:
            with annotate("rlaopt.refine.residual"):
                t0 = time.perf_counter()
                R64 = B64 - (mm64(W64) + reg * W64)
                walls["residual_f64"].append(since(t0))
            src = "evaluate"
        if src == "update":
            # The update carries its own error (~1e-7·Σ|K||δ|); guard the
            # claim with an independent host float64 sampled check and fall
            # back to one full evaluation if the claim under-reports.
            t0 = time.perf_counter()
            chk = self._sampled_f64_residual(W64)
            if chk is not None:
                est_abs, stderr = chk
                claim = col_norms(R64)
                margin = 1.0 + max(4.0 * stderr, 0.5)
                check_log = {
                    "claim_rel": (claim / b_norms).tolist(),
                    "sampled_rel": (est_abs / b_norms).tolist(),
                    "rel_stderr": stderr,
                    "wall_s": since(t0),
                }
                if bool(np.any(est_abs > margin * np.maximum(claim, 1e-300))):
                    with annotate("rlaopt.refine.residual"):
                        t0 = time.perf_counter()
                        R64 = B64 - (mm64(W64) + reg * W64)
                        walls["residual_f64"].append(since(t0))
                    check_log["refreshed"] = True
                    src = "evaluate"
                else:
                    check_log["refreshed"] = False
                out["update_check"] = check_log
        sources.append(src)  # provenance of the final hist entry below
        hist.append((col_norms(R64) / b_norms).tolist())
        return W64, out


def _moved(t: torch.Tensor, device, dtype) -> torch.Tensor:
    """``t.to(device, dtype)``; a move between the host and a card waits for
    the card (a span of the refinement's host syncs)."""
    device = torch.device(device)
    if t.device.type == device.type:
        return t.to(device, dtype)
    with annotate_sync("rlaopt.sync.refine", t if t.is_cuda else device):
        return t.to(device, dtype)


def _sync(t: torch.Tensor):
    if t.is_cuda:
        with annotate_sync("rlaopt.sync.linsys", t):
            torch.cuda.synchronize(t.device)
