"""Preconditioner configuration dataclasses.

Port of ``rlaopt_tpu/preconditioners/configs.py``: Identity, Newton,
Nyström and SkPre, with the same fields and checks.
"""

from abc import ABC
from dataclasses import asdict, dataclass
from typing import Any

from .enums import _DampingMode
from ..utils.checkers import _is_nonneg_float, _is_pos_int, _is_str


__all__ = [
    "PreconditionerConfig",
    "IdentityConfig",
    "NewtonConfig",
    "NystromConfig",
    "SkPreConfig",
    "_is_precond_config",
]


@dataclass(kw_only=True, frozen=False)
class PreconditionerConfig(ABC):
    """Abstract base class for preconditioner configurations."""

    def to_dict(self) -> dict:
        d = asdict(self)
        for k, v in d.items():
            if isinstance(v, _DampingMode):
                d[k] = v.name.lower()
        return d


@dataclass(kw_only=True, frozen=False)
class IdentityConfig(PreconditionerConfig):
    """Configuration for the Identity preconditioner (no parameters)."""


@dataclass(kw_only=True, frozen=False)
class NewtonConfig(PreconditionerConfig):
    """Configuration for the Newton preconditioner.

    Attributes:
        rho: damping added to the diagonal before Cholesky.
    """

    rho: float

    def __post_init__(self):
        _is_nonneg_float(self.rho, "rho")


@dataclass(kw_only=True, frozen=False)
class NystromConfig(PreconditionerConfig):
    """Configuration for the Nyström preconditioner.

    Attributes:
        rank: rank of the Nyström approximation.
        rho: damping parameter.
        sketch: sketch family for the range finder ("ortho" default).
        damping_mode: "adaptive" (rho ← baseline + S[-1]) or "non_adaptive".
    """

    rank: int
    rho: float
    sketch: str = "ortho"
    damping_mode: str = "adaptive"

    def __post_init__(self):
        _is_pos_int(self.rank, "rank")
        _is_nonneg_float(self.rho, "rho")
        _is_str(self.sketch, "sketch")
        self.damping_mode = _DampingMode._from_str(self.damping_mode, "damping_mode")


@dataclass(kw_only=True, frozen=False)
class SkPreConfig(PreconditionerConfig):
    """Configuration for the sketch-and-precondition preconditioner.

    Attributes:
        sketch_size: number of sketch rows s.
        rho: damping added to the sketched Gram diagonal.
        sketch: sketch family ("sparse" default, as in the reference).
    """

    sketch_size: int
    rho: float
    sketch: str = "sparse"

    def __post_init__(self):
        _is_pos_int(self.sketch_size, "sketch_size")
        _is_nonneg_float(self.rho, "rho")


def _is_precond_config(param: Any, param_name: str):
    if not isinstance(param, PreconditionerConfig):
        raise TypeError(
            f"{param_name} is of type {type(param).__name__}, "
            "but expected type PreconditionerConfig"
        )
