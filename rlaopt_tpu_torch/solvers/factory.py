"""Solver factory (port of ``rlaopt_tpu/solvers/factory.py``)."""

from typing import TYPE_CHECKING

import torch

from .configs import LSQRConfig, PCGConfig, SAPConfig, SolverConfig
from .lsqr import LSQR
from .pcg import PCG
from .sap import SAP

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
    same operator and regularization; PCG and LSQR skip their own sketch.
    SAP builds a preconditioner per block every iteration and cannot take
    one.
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
        if preconditioner is not None:
            raise ValueError(
                "SAP factors a fresh per-block preconditioner every "
                "iteration; a prebuilt preconditioner cannot be supplied"
            )
        return SAP(
            system=model,
            W_init=W_init,
            precond_config=solver_config.precond_config,
            blk_sz=solver_config.blk_sz,
            accel=solver_config.accel,
            accel_config=solver_config.accel_config,
            power_iters=solver_config.power_iters,
            key=key,
            blk_dense=solver_config.blk_dense,
            sampling=solver_config.sampling,
        )
    if cls is LSQRConfig:
        return LSQR(
            system=model,
            W_init=W_init,
            precond_config=solver_config.precond_config,
            damp=solver_config.damp,
            key=key,
            preconditioner=preconditioner,
        )
    raise ValueError(f"No solver registered for config {cls.__name__}")
