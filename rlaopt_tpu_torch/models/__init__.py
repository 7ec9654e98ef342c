"""User-facing models: LinSys and LstSq."""

from .model import Model  # noqa: F401
from .linsys import LinSys  # noqa: F401
from .lstsq import LstSq  # noqa: F401

__all__ = ["Model", "LinSys", "LstSq"]
