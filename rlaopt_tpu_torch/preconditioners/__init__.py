"""Randomized preconditioners: Identity, Newton, Nyström and SkPre."""

from .base import Preconditioner  # noqa: F401
from .configs import (  # noqa: F401
    IdentityConfig,
    NewtonConfig,
    NystromConfig,
    PreconditionerConfig,
    SkPreConfig,
    _is_precond_config,
)
from .enums import _DampingMode  # noqa: F401
from .factory import CONFIG_TO_PRECONDITIONER, _get_precond  # noqa: F401
from .identity import Identity  # noqa: F401
from .newton import Newton, newton_apply, newton_apply_inv, newton_update  # noqa: F401
from .nystrom import (  # noqa: F401
    Nystrom,
    NystromFactors,
    nystrom_apply,
    nystrom_apply_inv,
    nystrom_damping,
    nystrom_inv_chol,
    nystrom_update,
)
from .skpre import SkPre, skpre_apply, skpre_apply_inv, skpre_update  # noqa: F401

__all__ = [
    "Preconditioner",
    "PreconditionerConfig",
    "IdentityConfig",
    "NewtonConfig",
    "NystromConfig",
    "SkPreConfig",
    "CONFIG_TO_PRECONDITIONER",
    "Identity",
    "Newton",
    "Nystrom",
    "SkPre",
    "NystromFactors",
    "newton_update",
    "newton_apply",
    "newton_apply_inv",
    "nystrom_update",
    "nystrom_apply",
    "nystrom_apply_inv",
    "nystrom_damping",
    "nystrom_inv_chol",
    "skpre_update",
    "skpre_apply",
    "skpre_apply_inv",
]
