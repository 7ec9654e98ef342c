"""Solver ABC (port of ``rlaopt_tpu/solvers/solver.py``).

Besides the per-iteration ``_step()``, every solver implements
``_run_chunk(n_steps)``: ``n_steps`` iterations between two logging
boundaries. The model drives chunks of ``callback_freq`` steps, and the
convergence mask changes only between chunks.
"""

from abc import ABC, abstractmethod


__all__ = ["Solver"]


class Solver(ABC):
    def __init__(self, *args, **kwargs):
        pass

    @abstractmethod
    def _get_precond(self, *args, **kwargs):
        """Build the preconditioner for this solver."""

    @abstractmethod
    def _step(self, *args, **kwargs):
        """Advance one iteration."""

    def _run_chunk(self, n_steps: int):
        """Advance ``n_steps`` iterations."""
        for _ in range(n_steps):
            self._step()

    def residual(self):
        """The solver's carried (recurrence) residual, or None."""
        return None
