"""Iteration engines: PCG (SAP/ASkotch and LSQR are not ported yet)."""

from .configs import (  # noqa: F401
    LSQRConfig,
    PCGConfig,
    SAPConfig,
    SolverConfig,
    _is_solver_config,
)
from .solver import Solver  # noqa: F401
from .pcg import PCG, PCGState, pcg_init, pcg_step  # noqa: F401
from .factory import _get_solver  # noqa: F401

__all__ = [
    "Solver",
    "SolverConfig",
    "PCGConfig",
    "SAPConfig",
    "LSQRConfig",
    "PCG",
    "PCGState",
    "pcg_init",
    "pcg_step",
]
