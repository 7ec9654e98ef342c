"""Sketch object shell (port of ``rlaopt_tpu/sketches/base.py``).

The classes here wrap the embeddings of
:mod:`rlaopt_tpu_torch.sketches.embeddings` in the JAX package's stateful
API: construct once (drawing the embedding), then apply on either side,
optionally transposed. Randomness comes from ``key`` (a
``torch.Generator`` or an int seed); without one, a generator is split off
the package chain (:mod:`rlaopt_tpu_torch.utils.rng`). The embedding is
drawn on ``device``, the port's own parameter after JAX's: the CUDA card
unless it names another (None raises where there is no card).
"""

from abc import ABC, abstractmethod

import torch

from .enums import _SketchSide
from ..linops.base import LinOp
from ..utils.checkers import _as_device, _as_generator, _is_pos_int
from ..utils.linalg import hmm


__all__ = ["Sketch"]


def _dense(x, M: torch.Tensor) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=M.device)


def _lmul(M: torch.Tensor, x):
    """M @ x where x may be a LinOp (a dense product in full precision)."""
    if isinstance(x, LinOp):
        return x.__rmatmul__(M)
    return hmm(M, _dense(x, M))


def _rmul(x, M: torch.Tensor):
    """x @ M where x may be a LinOp (a dense product in full precision)."""
    if isinstance(x, LinOp):
        return x @ M
    return hmm(_dense(x, M), M)


class Sketch(ABC):
    """Abstract base class for sketching operators.

    Attributes:
        mode: _SketchSide.LEFT or .RIGHT.
        s: sketch size.
        d: original dimension.
        dtype: element dtype of the embedding.
        key: the ``torch.Generator`` the embedding was drawn from.
        device: where the embedding lies.
        Omega_mat: the materialized embedding matrix — shape (s, d) in left
            mode, (d, s) in right mode.
    """

    def __init__(self, mode, sketch_size: int, matrix_dim: int, dtype, key=None, device=None):
        self.mode = _SketchSide._from_str(mode, "mode")
        self.s = sketch_size
        self.d = matrix_dim
        self.dtype = dtype
        _is_pos_int(sketch_size, "sketch_size")
        self.device = _as_device(device)
        self.key = _as_generator(key)
        self.Omega_mat = self._generate_embedding(self.key)

    @abstractmethod
    def _generate_embedding(self, key: torch.Generator) -> torch.Tensor:
        """Generate the embedding matrix (oriented per ``self.mode``)."""

    def _apply_left(self, x):
        """Omega @ x."""
        return _lmul(self.Omega_mat, x)

    def _apply_right(self, x):
        """x @ Omega."""
        return _rmul(x, self.Omega_mat)

    def _apply_left_trans(self, x):
        """Omega.T @ x."""
        return _lmul(self.Omega_mat.T, x)

    def _apply_right_trans(self, x):
        """x @ Omega.T."""
        return _rmul(x, self.Omega_mat.T)
