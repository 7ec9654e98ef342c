"""User-facing models: LinSys (LstSq is not ported yet)."""

from .model import Model  # noqa: F401
from .linsys import LinSys  # noqa: F401

__all__ = ["Model", "LinSys"]
