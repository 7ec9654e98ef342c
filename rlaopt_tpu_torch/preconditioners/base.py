"""Preconditioner ABC and inverse wrapper.

Port of ``rlaopt_tpu/preconditioners/base.py``. Without ``jit`` there is no
functional state to thread through a compiled loop; the JAX package's
calling convention stays all the same: :meth:`Preconditioner.
_functional_inverse` gives ``(inv_fn, pstate)`` with ``inv_fn(pstate, x) =
P⁻¹x``, the state being the preconditioner itself, and PCG takes that pair
as the JAX PCG does. Each concrete preconditioner keeps its functional core
(``*_update`` / ``*_apply`` / ``*_apply_inv``) in its module.
"""

from abc import ABC, abstractmethod

import torch

from .configs import PreconditionerConfig
from ..utils.checkers import _is_tensor_1d_2d


__all__ = ["Preconditioner"]


def _apply_inverse(P: "Preconditioner", x: torch.Tensor) -> torch.Tensor:
    """``P⁻¹ x``: the ``inv_fn`` of :meth:`Preconditioner._functional_inverse`."""
    return P._inverse_matmul(x)


class Preconditioner(ABC):
    """Abstract base class for preconditioners.

    Attributes:
        config: the preconditioner configuration.
    """

    def __init__(self, config: PreconditionerConfig):
        self.config = config

    @abstractmethod
    def _update(self, A, *args, key=None, **kwargs):
        """(Re)build the preconditioner from a matrix or LinOp ``A``.

        ``key``: int seed, ``torch.Generator`` or None.
        """

    @abstractmethod
    def _matmul(self, x: torch.Tensor) -> torch.Tensor:
        """P @ x."""

    @abstractmethod
    def _inverse_matmul_1d(self, x: torch.Tensor) -> torch.Tensor:
        """P⁻¹ x for 1D x."""

    @abstractmethod
    def _inverse_matmul_2d(self, x: torch.Tensor) -> torch.Tensor:
        """P⁻¹ X for 2D X."""

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        _is_tensor_1d_2d(x, "x")
        return self._matmul(x)

    def _inverse_matmul(self, x: torch.Tensor) -> torch.Tensor:
        _is_tensor_1d_2d(x, "x")
        if x.ndim == 1:
            return self._inverse_matmul_1d(x)
        return self._inverse_matmul_2d(x)

    def _update_damping(self, baseline_rho: float):
        """Adjust damping after build; no-op except for Nyström."""

    def _functional_inverse(self):
        """``(inv_fn, pstate)`` with ``inv_fn(pstate, x) = P⁻¹x``, the JAX
        package's pair for ``pcg_init`` and ``pcg_step``; ``pstate`` is the
        preconditioner itself."""
        return _apply_inverse, self
