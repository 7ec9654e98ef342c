"""LstSq model: min ‖AW − B‖² (+ damp²‖W‖²).

Port of ``rlaopt_tpu/models/lstsq.py``, the front end of the
sketch-and-precondition LSQR path: per-column metrics, convergence mask,
chunked training loop. A is a dense tensor, a LinOp or a sparse tensor
(wrapped as an operator).

Termination metric: the normal-equation residual ‖Aᵀ(B − AW) − damp²W‖ per
column (→ 0 at the least-squares solution), relative to ‖AᵀB‖.
"""

import time
from typing import Any, Callable, Optional

import torch

from .model import Model, _wrap_sparse
from ..linops.base import LinOp
from ..linops.types import _is_linop_or_tensor
from ..solvers import _get_solver, _get_solver_name, _is_solver_config
from ..utils.checkers import _as_generator, _is_nonneg_float, _is_tensor
from ..utils.checkpoint import SolveCheckpointer
from ..utils.linalg import hmm
from ..utils.logger import Logger


__all__ = ["LstSq"]


class LstSq(Model):
    """Overdetermined least-squares problem min ‖AW − B‖² + damp²‖W‖²."""

    def __init__(self, A, B: torch.Tensor, damp: float = 0.0):
        self._check_inputs(A, B, damp)
        self._A = _wrap_sparse(A)
        self._B = B[:, None] if B.ndim == 1 else B
        self._damp = damp
        self._mask = torch.ones(
            (self._B.shape[1],), dtype=torch.bool, device=self._B.device
        )
        self._atb_norm = None
        self.phase_walls = {}

    @property
    def A(self):
        return self._A

    @property
    def B(self):
        return self._B

    @property
    def damp(self):
        return self._damp

    @property
    def mask(self):
        return self._mask

    def _check_inputs(self, A: Any, B: Any, damp: Any):
        _is_linop_or_tensor(A, "A")
        _is_tensor(B, "B")
        _is_nonneg_float(damp, "damp")

    def _apply_A(self, W):
        return self._A @ W if isinstance(self._A, LinOp) else hmm(self._A, W)

    def _apply_AT(self, R):
        if isinstance(self._A, LinOp):
            return self._A.__rmatmul__(R.T).T
        return hmm(self._A.T, R)

    def _normal_residual(self, W):
        R = self._B - self._apply_A(W)
        G = self._apply_AT(R) - (self._damp**2) * W
        return torch.linalg.norm(G, dim=0)

    def _atb_norms(self):
        if self._atb_norm is None:
            self._atb_norm = torch.linalg.norm(self._apply_AT(self._B), dim=0)
        return self._atb_norm

    def _compute_internal_metrics(self, W: torch.Tensor, force_true: bool = False):
        # force_true: the Model layer's signature; LstSq metrics always come
        # from a full operator apply.
        atb = self._atb_norms()
        abs_res = self._normal_residual(W)
        return {"abs_res": abs_res, "rel_res": abs_res / atb}

    def _check_termination_criteria(
        self, internal_metrics: dict, atol: float, rtol: float
    ) -> bool:
        abs_res = internal_metrics["abs_res"]
        comp_tol = torch.clamp(rtol * self._atb_norms(), min=atol)
        self._mask = abs_res > comp_tol
        return bool(torch.all(~self._mask))

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
        preconditioner=None,
    ):
        """Solve; returns ``(solution, log)``.

        ``preconditioner`` optionally supplies an already-built
        preconditioner (e.g. a factored SkPre) so the solver skips its own
        sketch and factorization. ``key`` (int seed, ``torch.Generator`` or
        None) seeds the sketch. ``model.phase_walls`` holds the wall-clock
        seconds of solver set-up (the sketch and the Cholesky included) and
        of the iterations. ``checkpoint_dir``, ``checkpoint_freq``,
        ``resume``, ``log_in_wandb`` and ``wandb_init_kwargs`` are
        :meth:`LinSys.solve`'s.
        """
        _is_solver_config(solver_config, "solver_config")
        _is_tensor(W_init, "W_init")
        if log_in_wandb and wandb_init_kwargs is None:
            raise ValueError(
                "wandb_init_kwargs must be specified if log_in_wandb is True"
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
        solver = _get_solver(
            model=self, W_init=W_init, solver_config=solver_config,
            key=_as_generator(key), preconditioner=preconditioner,
        )
        _sync(self._B)
        phase_walls = {"solver_init": round(time.perf_counter() - t_init, 3)}
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
        return solution, log


def _sync(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
