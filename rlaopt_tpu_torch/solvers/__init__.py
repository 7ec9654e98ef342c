"""Iteration engines: PCG, SAP/ASkotch and LSQR."""

from .configs import (  # noqa: F401
    LSQRConfig,
    PCGConfig,
    SAPAccelConfig,
    SAPConfig,
    SolverConfig,
    _get_solver_name,
    _is_solver_config,
)
from .solver import Solver  # noqa: F401
from .pcg import PCG, PCGState, pcg_init, pcg_step  # noqa: F401
from .sap import SAP, SAPState, sap_accel_from_pilot  # noqa: F401
from .lsqr import LSQR, LSQRState  # noqa: F401
from .factory import _get_solver  # noqa: F401

__all__ = [
    "Solver",
    "SolverConfig",
    "PCGConfig",
    "SAPConfig",
    "SAPAccelConfig",
    "LSQRConfig",
    "_is_solver_config",
    "_get_solver_name",
    "_get_solver",
    "PCG",
    "PCGState",
    "pcg_init",
    "pcg_step",
    "SAP",
    "SAPState",
    "sap_accel_from_pilot",
    "LSQR",
    "LSQRState",
]
