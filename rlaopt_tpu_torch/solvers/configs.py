"""Solver configuration dataclasses.

Port of ``rlaopt_tpu/solvers/configs.py``: the same fields and checks for
``PCGConfig``, ``SAPConfig`` and ``LSQRConfig``.
"""

from abc import ABC
from dataclasses import asdict, dataclass, field
from typing import Any, Optional

from ..preconditioners import (
    IdentityConfig,
    PreconditionerConfig,
    _is_precond_config,
)
from ..utils.checkers import _is_bool, _is_nonneg_float, _is_pos_float, _is_pos_int


__all__ = [
    "SAPAccelConfig",
    "SolverConfig",
    "PCGConfig",
    "SAPConfig",
    "LSQRConfig",
    "CONFIG_TO_NAME",
    "_is_solver_config",
    "_get_solver_name",
]


@dataclass(kw_only=True, frozen=False)
class SAPAccelConfig:
    """Nesterov-type acceleration parameters for SAP (mu ≤ nu, mu·nu ≤ 1)."""

    mu: float
    nu: float

    def __post_init__(self):
        _is_pos_float(self.mu, "mu")
        _is_pos_float(self.nu, "nu")
        if self.mu > self.nu:
            raise ValueError("mu must be less than or equal to nu")
        if self.mu * self.nu > 1:
            raise ValueError("mu * nu must be less than or equal to 1")
        if self.mu * self.nu == 1:
            import warnings

            # gamma = 1/sqrt(mu·nu) = 1 keeps V = Y = W from a common start,
            # so the method is plain SAP.
            warnings.warn(
                "mu * nu == 1 makes the SAP acceleration recurrence exactly "
                "inert (gamma=1 keeps V=Y=W): the method reduces to plain "
                "SAP. Pick mu * nu < 1 for genuine acceleration.",
                UserWarning,
                stacklevel=2,
            )


def _is_sap_accel_config(param: Any, param_name: str):
    if not isinstance(param, SAPAccelConfig):
        raise TypeError(
            f"{param_name} is of type {type(param).__name__}, "
            "but expected type SAPAccelConfig"
        )


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
    """SAP / ASkotch randomized block-coordinate solver.

    Attributes:
        blk_sz: coordinate block size per iteration.
        accel: use Nesterov-type acceleration.
        accel_config: (mu, nu) parameters; required when accel=True.
        power_iters: power-iteration count for the stepsize estimate.
        blk_dense: materialize the block kernel tile once per iteration
            and reuse it for the preconditioner sketch and every power
            iteration (kernel operators only). None = auto: on when the
            block oracle exposes a dense materialization and the tile fits
            512 MiB; False = never; True = require (raises if the oracle
            cannot materialize).
        sampling: where the uniform without-replacement block indices are
            drawn: "device" (a permutation on the iterate's device),
            "host" (numpy, one upload per logging chunk) or "auto" (host
            when n >= 2**17).
    """

    blk_sz: int
    accel: bool = True
    accel_config: Optional[SAPAccelConfig] = None
    power_iters: int = 10
    blk_dense: Optional[bool] = None
    sampling: str = "auto"

    def __post_init__(self):
        super().__post_init__()
        _is_pos_int(self.blk_sz, "blk_sz")
        _is_bool(self.accel, "accel")
        if self.accel:
            if self.accel_config is None:
                raise ValueError("accel_config must be specified if accel is True")
            _is_sap_accel_config(self.accel_config, "accel_config")
        _is_pos_int(self.power_iters, "power_iters")
        if self.blk_dense is not None:
            _is_bool(self.blk_dense, "blk_dense")
        if self.sampling not in ("auto", "device", "host"):
            raise ValueError(
                "sampling must be one of 'auto', 'device', 'host', "
                f"but received {self.sampling!r}"
            )


@dataclass(kw_only=True, frozen=False)
class LSQRConfig(SolverConfig):
    """Preconditioned LSQR for min ‖Ax − b‖² (+ damping).

    Pair with ``SkPreConfig`` for sketch-and-precondition least squares.
    """

    damp: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        _is_nonneg_float(self.damp, "damp")


def _is_solver_config(param: Any, param_name: str):
    if not isinstance(param, SolverConfig):
        raise TypeError(
            f"{param_name} is of type {type(param).__name__}, "
            "but expected type SolverConfig"
        )


CONFIG_TO_NAME = {
    PCGConfig: "pcg",
    SAPConfig: "sap",
    LSQRConfig: "lsqr",
}


def _get_solver_name(solver_config: SolverConfig) -> str:
    """The solver's name for its config class (None for any other class,
    subclasses included, as in the JAX package)."""
    return CONFIG_TO_NAME.get(solver_config.__class__)
