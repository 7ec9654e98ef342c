"""Orthonormal sketch (port of ``rlaopt_tpu/sketches/ortho.py``)."""

from .base import Sketch
from .enums import _SketchSide
from .embeddings import ortho_embedding


__all__ = ["Ortho"]


class Ortho(Sketch):
    """Orthonormal sketch: reduced-QR Q of randn(d, s); transposed in left mode."""

    def _generate_embedding(self, key):
        Omega = ortho_embedding(key, self.s, self.d, self.dtype, self.device)  # (d, s)
        if self.mode == _SketchSide.LEFT:
            Omega = Omega.T
        return Omega
