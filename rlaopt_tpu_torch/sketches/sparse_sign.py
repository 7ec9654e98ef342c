"""Sparse-sign sketch (port of ``rlaopt_tpu/sketches/sparse_sign.py``)."""

from .base import Sketch
from .enums import _SketchSide
from .embeddings import sparse_sign_embedding


__all__ = ["Sparse"]


class Sparse(Sketch):
    """Sparse-sign sketch: ζ=min(8,s) ±1 entries per column, scaled ζ^(-1/2),
    stored dense (the apply is a dense product)."""

    def _generate_embedding(self, key):
        Omega = sparse_sign_embedding(key, self.s, self.d, self.dtype, self.device)
        if self.mode == _SketchSide.RIGHT:
            Omega = Omega.T
        return Omega
