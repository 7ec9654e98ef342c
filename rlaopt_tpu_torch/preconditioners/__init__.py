"""Randomized preconditioners: Identity and Nyström."""

from .base import Preconditioner  # noqa: F401
from .configs import (  # noqa: F401
    IdentityConfig,
    NystromConfig,
    PreconditionerConfig,
    _is_precond_config,
)
from .enums import _DampingMode  # noqa: F401
from .factory import CONFIG_TO_PRECONDITIONER, _get_precond  # noqa: F401
from .identity import Identity  # noqa: F401
from .nystrom import (  # noqa: F401
    Nystrom,
    NystromFactors,
    nystrom_apply,
    nystrom_apply_inv,
    nystrom_damping,
    nystrom_inv_chol,
    nystrom_update,
)

__all__ = [
    "Preconditioner",
    "PreconditionerConfig",
    "IdentityConfig",
    "NystromConfig",
    "CONFIG_TO_PRECONDITIONER",
    "Identity",
    "Nystrom",
    "NystromFactors",
    "nystrom_update",
    "nystrom_apply",
    "nystrom_apply_inv",
    "nystrom_damping",
    "nystrom_inv_chol",
]
