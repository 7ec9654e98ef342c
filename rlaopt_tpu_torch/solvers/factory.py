"""Solver factory (port of ``rlaopt_tpu/solvers/factory.py``)."""

from typing import TYPE_CHECKING

import torch

from .configs import LSQRConfig, PCGConfig, SAPConfig, SolverConfig
from .pcg import PCG

if TYPE_CHECKING:
    from ..models import Model


__all__ = ["_get_solver"]


def _get_solver(
    model: "Model",
    W_init: torch.Tensor,
    solver_config: SolverConfig,
    key=None,
    preconditioner=None,
):
    """Instantiate the solver matching the config class.

    ``preconditioner`` (optional): an already-built preconditioner for the
    same operator and regularization; the solver skips its own sketch.
    """
    cls = solver_config.__class__
    if cls is PCGConfig:
        return PCG(
            system=model,
            W_init=W_init,
            precond_config=solver_config.precond_config,
            key=key,
            preconditioner=preconditioner,
        )
    if cls is SAPConfig:
        raise NotImplementedError(
            "SAP/ASkotch is not ported yet (ROADMAP Queue 1, item 10)"
        )
    if cls is LSQRConfig:
        raise NotImplementedError(
            "LSQR is not ported yet (ROADMAP Queue 1, item 11)"
        )
    raise ValueError(f"No solver registered for config {cls.__name__}")
