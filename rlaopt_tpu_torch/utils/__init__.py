"""Validation, RNG, small linear algebra and logging helpers."""

from .rng import seed, next_generator  # noqa: F401
from .linalg import (  # noqa: F401
    hmm,
    as_matmat,
    densify,
    cholesky_or_nan,
    solve_tri_lower,
    solve_tri_upper,
)
from .logger import Logger  # noqa: F401

__all__ = [
    "seed",
    "next_generator",
    "hmm",
    "as_matmat",
    "densify",
    "cholesky_or_nan",
    "solve_tri_lower",
    "solve_tri_upper",
    "Logger",
]
