"""Subsampled randomized Hadamard transform (SRHT) sketch.

Port of ``rlaopt_tpu/sketches/srht.py``: Θ = sqrt(p/s)·R·H̃·D, applied to a
dense operand by the fast Walsh-Hadamard transform
(:func:`~rlaopt_tpu_torch.sketches.embeddings.srht_apply`) without the
(s, d) matrix; an operator operand, and the transposed applies that the
transform does not give, go through the matrix, built on first use.
"""

from .base import Sketch, _dense, _lmul, _rmul
from .enums import _SketchSide
from .embeddings import srht_apply, srht_matrix, srht_params
from ..linops.base import LinOp


__all__ = ["SRHT"]


class SRHT(Sketch):
    """SRHT sketch. Conceptual shape: (s, d) in left mode, (d, s) in right."""

    def __init__(self, mode, sketch_size, matrix_dim, dtype, key=None, device=None):
        self._materialized = None
        super().__init__(mode, sketch_size, matrix_dim, dtype, key, device)

    def _generate_embedding(self, key):
        self.signs, self.rows = srht_params(key, self.s, self.d, self.dtype, self.device)
        return None  # materialized lazily via the Omega_mat property

    @property
    def Omega_mat(self):
        if self._materialized is None:
            Theta = srht_matrix(self.signs, self.rows, self.d)  # (s, d)
            if self.mode == _SketchSide.RIGHT:
                Theta = Theta.T
            self._materialized = Theta
        return self._materialized

    @Omega_mat.setter
    def Omega_mat(self, value):
        self._materialized = value

    # Θ applied along axis 0; Θᵀ y through the materialized matrix only
    # where unavoidable (operator operands).
    def _theta(self, x):
        return srht_apply(self.signs, self.rows, _dense(x, self.signs))

    def _theta_rows(self, x):
        """x @ Θᵀ = (Θ xᵀ)ᵀ."""
        x = _dense(x, self.signs)
        return self._theta(x.T).T if x.ndim == 2 else self._theta(x)

    def _apply_left(self, x):
        """Omega @ x."""
        if self.mode == _SketchSide.LEFT and not isinstance(x, LinOp):
            return self._theta(x)
        return _lmul(self.Omega_mat, x)

    def _apply_right(self, x):
        """x @ Omega."""
        if self.mode == _SketchSide.RIGHT and not isinstance(x, LinOp):
            return self._theta_rows(x)
        return _rmul(x, self.Omega_mat)

    def _apply_left_trans(self, x):
        """Omega.T @ x."""
        if self.mode == _SketchSide.RIGHT and not isinstance(x, LinOp):
            return self._theta(x)
        return _lmul(self.Omega_mat.T, x)

    def _apply_right_trans(self, x):
        """x @ Omega.T."""
        if self.mode == _SketchSide.LEFT and not isinstance(x, LinOp):
            return self._theta_rows(x)
        return _rmul(x, self.Omega_mat.T)
