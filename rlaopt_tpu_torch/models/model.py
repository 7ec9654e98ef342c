"""Model ABC — solve-loop orchestration.

Port of ``rlaopt_tpu/models/model.py``: metrics, callback merging, the
wandb config, termination checked only at logging boundaries, and
checkpoint and resume. The solver runs in chunks of ``callback_freq``
iterations between boundaries.
"""

from abc import ABC, abstractmethod
from typing import Callable, Optional
from warnings import warn

from ..solvers import Solver, SolverConfig
from ..utils.logger import Logger


__all__ = ["Model"]


def _wrap_sparse(A):
    """A sparse tensor as a matrix-free operator
    (:func:`rlaopt_tpu_torch.sparse.linop.sparse_aslinop`), anything else
    as it is: models take sparse data matrices as they come."""
    from ..sparse.sparse_tensor import _SparseTensor

    if isinstance(A, _SparseTensor):
        from ..linops.base import aslinop

        return aslinop(A)
    return A


class Model(ABC):
    def __init__(self, *args, **kwargs):
        pass

    @abstractmethod
    def _check_inputs(self, *args, **kwargs):
        pass

    @abstractmethod
    def _compute_internal_metrics(self, *args, **kwargs):
        pass

    @abstractmethod
    def _check_termination_criteria(self, *args, **kwargs):
        pass

    def _get_log_fn(
        self,
        callback_fn: Optional[Callable],
        callback_args: list,
        callback_kwargs: dict,
    ):
        if callback_fn is not None:

            def log_fn(w):
                callback_log = callback_fn(w, self, *callback_args, **callback_kwargs)
                return {
                    "callback": callback_log,
                    "internal_metrics": self._compute_internal_metrics(w),
                }

        else:

            def log_fn(w):
                return {"internal_metrics": self._compute_internal_metrics(w)}

        return log_fn

    def _get_wandb_kwargs(
        self,
        log_in_wandb: bool,
        wandb_init_kwargs: Optional[dict],
        solver_name: str,
        solver_config: SolverConfig,
        callback_freq: int,
    ):
        """``wandb.init``'s keywords (None unless ``log_in_wandb``): a
        ``config`` of the solver's name, config and ``callback_freq``, with
        the user's ``wandb_init_kwargs`` on top (a ``config`` of theirs is
        merged into it, their values winning)."""
        if not log_in_wandb:
            return None
        wandb_kwargs = {
            "config": {
                "solver_name": solver_name,
                "solver_config": solver_config.to_dict(),
                "callback_freq": callback_freq,
            },
        }
        for key, value in (wandb_init_kwargs or {}).items():
            if key == "config":
                warn(
                    "wandb_init_kwargs carries its own 'config' dict; its "
                    "entries are folded into the auto-populated solver "
                    "config (user values win on key collisions)."
                )
                wandb_kwargs["config"].update(value)
            else:
                wandb_kwargs[key] = value
        return wandb_kwargs

    def _train(
        self,
        logger: Logger,
        termination_fn: Callable,
        solver: Solver,
        max_iters: int,
        checkpointer=None,
        checkpoint_freq: Optional[int] = None,
        resume: bool = False,
    ):
        """Run the solve loop in chunks of ``logger.log_freq`` iterations.

        With a ``checkpointer``, (solver state, mask) is saved every
        ``checkpoint_freq`` logging rounds and at convergence, the log and
        ``logger.cum_time`` beside it; ``resume=True`` restores the latest
        checkpoint and continues from its iteration, so the returned log
        covers the whole run (the restored entries as JSON values: lists
        where tensors were) and ``cum_time`` keeps accumulating.

        Returns ``(W, log)``; ``log`` maps iteration numbers to log dicts.
        """
        log = {}
        i = 0
        if checkpointer is not None and resume:
            payload, step = checkpointer.restore(
                like={"state": solver.state, "mask": self._mask}
            )
            solver.state = payload["state"]
            self._mask = payload["mask"]
            i = step
            aux = checkpointer.restore_aux(step)
            if aux is not None:
                log.update({int(k): v for k, v in aux.get("log", {}).items()})
                logger.cum_time = float(aux.get("cum_time", 0.0))

        log[i] = logger._compute_log(0, solver.W)
        if termination_fn(log[i]["metrics"]["internal_metrics"]):
            return solver.W, log

        rounds = 0
        while i < max_iters:
            n_steps = min(logger.log_freq, max_iters - i)
            solver._run_chunk(n_steps)
            i += n_steps
            rounds += 1
            # force: a partial last chunk is still logged and checked.
            log_i = logger._compute_log(i, solver.W, force=(i >= max_iters))
            if log_i is not None:
                log[i] = log_i
                converged = termination_fn(log_i["metrics"]["internal_metrics"])
                if checkpointer is not None and checkpoint_freq and (
                    rounds % checkpoint_freq == 0 or converged
                ):
                    checkpointer.save(
                        i,
                        {"state": solver.state, "mask": self._mask},
                        aux={"log": log, "cum_time": logger.cum_time},
                    )
                if converged:
                    break

        logger._terminate()
        # Estimator-sourced final metrics are replaced by a true residual:
        # the returned log's last numbers always rest on an operator apply.
        final = log.get(i)
        if (
            final is not None
            and final["metrics"]["internal_metrics"].get("source") is not None
        ):
            final["metrics"]["internal_metrics"] = self._compute_internal_metrics(
                solver.W, force_true=True
            )
        return solver.W, log

    @abstractmethod
    def solve(self, *args, **kwargs):
        pass
