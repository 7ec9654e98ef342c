"""Model ABC — solve-loop orchestration.

Port of ``rlaopt_tpu/models/model.py``: metrics, callback merging and
termination checked only at logging boundaries. The solver runs in chunks
of ``callback_freq`` iterations between boundaries. Checkpoint and resume
are not ported yet.
"""

from abc import ABC, abstractmethod
from typing import Callable, Optional

from ..solvers import Solver
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

    def _train(
        self,
        logger: Logger,
        termination_fn: Callable,
        solver: Solver,
        max_iters: int,
    ):
        """Run the solve loop in chunks of ``logger.log_freq`` iterations.

        Returns ``(W, log)``; ``log`` maps iteration numbers to log dicts.
        """
        log = {}
        i = 0
        log[i] = logger._compute_log(0, solver.W)
        if termination_fn(log[i]["metrics"]["internal_metrics"]):
            return solver.W, log

        while i < max_iters:
            n_steps = min(logger.log_freq, max_iters - i)
            solver._run_chunk(n_steps)
            i += n_steps
            # force: a partial last chunk is still logged and checked.
            log_i = logger._compute_log(i, solver.W, force=(i >= max_iters))
            if log_i is not None:
                log[i] = log_i
                if termination_fn(log_i["metrics"]["internal_metrics"]):
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
