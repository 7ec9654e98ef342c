"""Solver configuration dataclasses.

Port of ``rlaopt_tpu/solvers/configs.py``: the same fields and checks. Only
``PCGConfig`` has a solver in the port so far; ``SAPConfig`` and
``LSQRConfig`` are bare, so that the factory can name what is missing.
"""

from abc import ABC
from dataclasses import asdict, dataclass, field
from typing import Any

from ..preconditioners import (
    IdentityConfig,
    PreconditionerConfig,
    _is_precond_config,
)
from ..utils.checkers import _is_nonneg_float, _is_pos_int


__all__ = [
    "SolverConfig",
    "PCGConfig",
    "SAPConfig",
    "LSQRConfig",
    "_is_solver_config",
]


@dataclass(kw_only=True, frozen=False)
class SolverConfig(ABC):
    """Base solver configuration."""

    max_iters: int = 1000
    atol: float = 0.0
    rtol: float = 1e-5
    precond_config: PreconditionerConfig = field(default_factory=IdentityConfig)

    def __post_init__(self):
        _is_pos_int(self.max_iters, "max_iters")
        _is_nonneg_float(self.atol, "atol")
        _is_nonneg_float(self.rtol, "rtol")
        _is_precond_config(self.precond_config, "precond_config")

    def to_dict(self) -> dict:
        d = asdict(self)
        for key, value in list(d.items()):
            if isinstance(value, PreconditionerConfig):
                d[key] = value.to_dict()
            elif hasattr(value, "to_dict"):
                d[key] = value.to_dict()
            elif hasattr(value, "__dataclass_fields__"):
                d[key] = asdict(value)
        # asdict already recursed into nested dataclasses; normalize enums
        from ..preconditioners.enums import _DampingMode

        def _norm(v):
            if isinstance(v, _DampingMode):
                return v.name.lower()
            if isinstance(v, dict):
                return {k: _norm(x) for k, x in v.items()}
            return v

        return {k: _norm(v) for k, v in d.items()}


@dataclass(kw_only=True, frozen=False)
class PCGConfig(SolverConfig):
    """Block preconditioned conjugate gradient."""

    pass


@dataclass(kw_only=True, frozen=False)
class SAPConfig(SolverConfig):
    """SAP / ASkotch: not ported yet; its fields come with the solver."""


@dataclass(kw_only=True, frozen=False)
class LSQRConfig(SolverConfig):
    """Preconditioned LSQR: not ported yet; its fields come with the solver."""


def _is_solver_config(param: Any, param_name: str):
    if not isinstance(param, SolverConfig):
        raise TypeError(
            f"{param_name} is of type {type(param).__name__}, "
            "but expected type SolverConfig"
        )
