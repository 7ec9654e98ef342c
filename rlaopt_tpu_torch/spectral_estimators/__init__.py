"""Spectral estimators: power iteration, Hutchinson/Hutch++, Lanczos, the
Frobenius norm."""

from .frobenius_norm import fro_norm_est  # noqa: F401
from .lanczos import lanczos, lanczos_eigsh  # noqa: F401
from .spectral_norm import randomized_powering  # noqa: F401
from .trace import hutch_plus_plus, hutchinson  # noqa: F401

__all__ = [
    "fro_norm_est",
    "lanczos",
    "lanczos_eigsh",
    "randomized_powering",
    "hutch_plus_plus",
    "hutchinson",
]
