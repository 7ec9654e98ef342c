"""Preconditioner factory (port of ``rlaopt_tpu/preconditioners/factory.py``)."""

from .base import Preconditioner
from .configs import (
    IdentityConfig,
    NewtonConfig,
    NystromConfig,
    PreconditionerConfig,
    SkPreConfig,
    _is_precond_config,
)
from .identity import Identity
from .newton import Newton
from .nystrom import Nystrom
from .skpre import SkPre


__all__ = ["_get_precond", "CONFIG_TO_PRECONDITIONER"]


CONFIG_TO_PRECONDITIONER = {
    IdentityConfig: Identity,
    NewtonConfig: Newton,
    NystromConfig: Nystrom,
    SkPreConfig: SkPre,
}


def _get_precond(config: PreconditionerConfig) -> Preconditioner:
    """Instantiate the preconditioner matching a config instance."""
    _is_precond_config(config, "config")
    cls = CONFIG_TO_PRECONDITIONER.get(type(config))
    if cls is None:
        raise ValueError(f"No preconditioner registered for {type(config).__name__}")
    return cls(config)
