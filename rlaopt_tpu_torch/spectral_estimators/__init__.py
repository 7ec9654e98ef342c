"""Spectral estimators: power iteration (Hutchinson/Hutch++ and Lanczos are
not ported yet)."""

from .spectral_norm import randomized_powering  # noqa: F401

__all__ = ["randomized_powering"]
