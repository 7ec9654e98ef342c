"""Preconditioner factory (port of ``rlaopt_tpu/preconditioners/factory.py``)."""

from .base import Preconditioner
from .configs import (
    IdentityConfig,
    NystromConfig,
    PreconditionerConfig,
    _is_precond_config,
)
from .identity import Identity
from .nystrom import Nystrom


__all__ = ["_get_precond", "CONFIG_TO_PRECONDITIONER"]


CONFIG_TO_PRECONDITIONER = {
    IdentityConfig: Identity,
    NystromConfig: Nystrom,
}


def _get_precond(config: PreconditionerConfig) -> Preconditioner:
    """Instantiate the preconditioner matching a config instance."""
    _is_precond_config(config, "config")
    cls = CONFIG_TO_PRECONDITIONER.get(type(config))
    if cls is None:
        raise ValueError(f"No preconditioner registered for {type(config).__name__}")
    return cls(config)
