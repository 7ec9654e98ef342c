"""Validation, RNG, small linear algebra and logging helpers."""

from .rng import seed, next_generator  # noqa: F401
from .linalg import hmm, as_matmat, solve_tri_lower, solve_tri_upper  # noqa: F401
from .logger import Logger  # noqa: F401

__all__ = [
    "seed",
    "next_generator",
    "hmm",
    "as_matmat",
    "solve_tri_lower",
    "solve_tri_upper",
    "Logger",
]
