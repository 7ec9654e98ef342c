"""Gaussian sketch (port of ``rlaopt_tpu/sketches/gauss.py``)."""

from .base import Sketch
from .enums import _SketchSide
from .embeddings import gauss_embedding


__all__ = ["Gauss"]


class Gauss(Sketch):
    """Gaussian sketch: randn(s, d)/sqrt(s), transposed in right mode."""

    def _generate_embedding(self, key):
        Omega = gauss_embedding(key, self.s, self.d, self.dtype, self.device)
        if self.mode == _SketchSide.RIGHT:
            Omega = Omega.T
        return Omega
