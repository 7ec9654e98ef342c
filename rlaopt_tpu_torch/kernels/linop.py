"""Kernel Gram linear operators (single device).

Port of ``rlaopt_tpu/kernels/linop.py``. The operator holds the data (X1,
X2), the lengthscale and the scale; its applies stream kernel tiles through
:func:`rlaopt_tpu_torch.ops.kernel_dispatch.kernel_matmat` (the CUDA kernels
for CUDA tensors, the plain versions for CPU tensors). K is never
materialized, except by :meth:`KernelLinOp.blk_dense` for a block. A bf16
``compute_dtype`` keeps the tier parts of the points (bf16 hi/lo and norm
vectors, :mod:`rlaopt_tpu_torch.ops.kernel_tiers`) on the operator, made
once when it is built; the row and block oracles gather theirs from it.
An operator on float32 points on the exact tier (every family) keeps the
register tile's operand of each point set
(:func:`rlaopt_tpu_torch.ops.kernel_cuda.tile_operand`: K1, K2, K3, K5),
built the first time a kernel takes it; a row oracle shares its parent's
for the columns.
"""

from typing import Optional

import torch

from .configs import KernelConfig, _is_kernel_config
from .functions import kernel_tile, scale_inputs
from ..linops.base import TwoSidedLinOp
from ..ops.kernel_dispatch import (
    check_impl,
    kernel_matmat,
    kernel_matmat_compensated,
    kernel_matmat_tier,
)
from ..ops.kernel_cuda import tile_operand
from ..ops.kernel_tiers import normalize_compute_dtype, tier_operand
from ..utils.checkers import _is_tensor


__all__ = ["KernelLinOp"]


class KernelLinOp(TwoSidedLinOp):
    """Matrix-free Gram operator K[i,j] = c·k(A1[i], A2[j]).

    ``impl``: ``"auto"`` (the CUDA kernels for CUDA tensors, the plain
    versions for CPU tensors), ``"xla"`` (the plain PyTorch versions on any
    device) or ``"pallas"`` (the CUDA kernels; raises on CPU tensors), the
    JAX package's names (:func:`~rlaopt_tpu_torch.ops.kernel_dispatch.check_impl`).
    ``compute_dtype``: None (exact f32 tier), ``"bf16x3"`` or
    ``"bfloat16"`` (any spelling :func:`normalize_compute_dtype` takes). The
    tiers apply to float32 points of the squared-distance families; float64
    points and Laplace take the exact tier, as in the JAX package off the
    TPU.
    """

    def __init__(
        self,
        A1: torch.Tensor,
        A2: torch.Tensor,
        kernel_config: KernelConfig,
        kind: str,
        impl: str = "auto",
        compute_dtype=None,
        _tier=None,
        _tile=None,
    ):
        """``_tier``: the tier parts of (A1, A2), gathered by the oracles
        from their parent's; None makes them here. ``_tile``: the register
        tile's operands of (A1, A2) as :class:`_TileOperand`, passed on by
        the oracles; None makes them here."""
        self._check_inputs(A1, A2, kernel_config)
        compute_dtype = normalize_compute_dtype(compute_dtype)
        self.kind = kind
        self.impl = check_impl(impl)
        self.compute_dtype = compute_dtype
        self._kernel_config = kernel_config
        self._X1, self._X2 = A1, A2
        self._ls = kernel_config.lengthscale_tensor(A1.dtype, A1.device)
        # The compensated apply divides by the lengthscale in float64.
        self._ls64 = kernel_config.lengthscale_tensor(torch.float64, A1.device)
        self._c = float(kernel_config.const_scaling)
        # One data set on both sides: the apply may take the triangle kernel.
        symmetric = self._symmetric = A1 is A2
        self._tier = _tier  # (parts of X1, parts of X2) on a bf16 tier
        if (_tier is None and compute_dtype is not None and kind != "laplace"
                and A1.dtype == torch.float32):
            P1 = tier_operand(scale_inputs(A1, self._ls), compute_dtype)
            P2 = P1 if symmetric else tier_operand(scale_inputs(A2, self._ls), compute_dtype)
            self._tier = (P1, P2)
        # the tile's operands of (A1, A2), each built on first use
        self._tile_ops = _tile
        if _tile is None and self._tier is None and A1.dtype == torch.float32:
            L1 = _TileOperand(A1, self._ls)
            self._tile_ops = (L1, L1 if symmetric else _TileOperand(A2, self._ls))
        ops = self._tile_ops
        fwd = None if ops is None else (lambda: (ops[0].get(), ops[1].get()))
        adj = None if ops is None else (lambda: (ops[1].get(), ops[0].get()))

        def mv(v):
            if self._tier is not None:
                P1, P2 = self._tier
                return kernel_matmat_tier(kind, P1, P2, v, self._c, symmetric, impl)
            return kernel_matmat(
                kind, A1, A2, v, self._ls, self._c, symmetric=symmetric, impl=impl,
                tile_operands=fwd,
            )

        def rmv(v):
            # k is symmetric in its arguments: Kᵀ = k(X2, X1)
            if self._tier is not None:
                P1, P2 = self._tier
                return kernel_matmat_tier(kind, P2, P1, v, self._c, symmetric, impl)
            return kernel_matmat(
                kind, A2, A1, v, self._ls, self._c, symmetric=symmetric, impl=impl,
                tile_operands=adj,
            )

        super().__init__(
            shape=(A1.shape[0], A2.shape[0]),
            matvec=mv,
            rmatvec=rmv,
            matmat=mv,
            rmatmat=rmv,
            dtype=A1.dtype,
            device=A1.device,
        )

    @property
    def A1(self) -> torch.Tensor:
        return self._X1

    @property
    def A2(self) -> torch.Tensor:
        return self._X2

    @property
    def kernel_config(self) -> KernelConfig:
        return self._kernel_config

    @property
    def lengthscale(self) -> torch.Tensor:
        return self._ls

    @property
    def lengthscale64(self) -> torch.Tensor:
        """The lengthscale in float64, as the float64 route takes it."""
        return self._ls64

    @property
    def const_scaling(self) -> float:
        """c of ``c·k``: the config's scale times the operator's (``op * c``)."""
        return self._c * float(self._scale)

    def _check_inputs(self, A1, A2, kernel_config):
        _is_tensor(A1, "A1")
        _is_tensor(A2, "A2")
        if A1.ndim != 2:
            raise ValueError(f"A1 must be a 2D tensor, got {A1.ndim}D tensor.")
        if A2.ndim != 2:
            raise ValueError(f"A2 must be a 2D tensor, got {A2.ndim}D tensor.")
        if A1.dtype != A2.dtype:
            raise ValueError("A1 and A2 must have the same dtype.")
        if A1.device != A2.device:
            raise ValueError("A1 and A2 must be on the same device.")
        _is_kernel_config(kernel_config, "kernel_config")

    def matmat_compensated(self, V: torch.Tensor):
        """``K @ V`` as a compensated ``(hi, lo)`` pair (add ``lo`` last).

        The ground truth of residual checks: the lengthscale division, the
        kernel values and each column tile's partial are taken in float64.
        One data set on both sides takes the triangle form on a card.
        """
        hi, lo = kernel_matmat_compensated(
            self.kind, self._X1, self._X2, V, self._ls64, self._c,
            symmetric=self._symmetric, impl=self.impl,
        )
        return self._apply_scale(hi), self._apply_scale(lo)

    def _submatrix(
        self,
        idx1: Optional[torch.Tensor] = None,
        idx2: Optional[torch.Tensor] = None,
    ) -> "KernelLinOp":
        """Operator over gathered subsets of the data points; on a bf16 tier
        its parts are the rows of the parent's, not a new split."""
        A1 = self._X1 if idx1 is None else self._X1[idx1]
        A2 = self._X2 if idx2 is None else self._X2[idx2]
        tier = None
        if self._tier is not None:
            P1, P2 = self._tier
            tier = (
                P1 if idx1 is None else P1.rows(idx1),
                P2 if idx2 is None else P2.rows(idx2),
            )
        ops = None
        if self._tile_ops is not None:
            L1, L2 = self._tile_ops
            ops = (
                L1 if idx1 is None else _TileOperand(A1, self._ls),
                L2 if idx2 is None else _TileOperand(A2, self._ls),
            )
        return KernelLinOp(
            A1, A2, self._kernel_config, self.kind, self.impl, self.compute_dtype,
            _tier=tier, _tile=ops,
        )

    def row_oracle(self, blk: torch.Tensor) -> "KernelLinOp":
        """K[blk, :] as an operator."""
        return self._submatrix(idx1=blk)

    def blk_oracle(self, blk: torch.Tensor) -> "KernelLinOp":
        """K[blk, blk] as an operator."""
        return self._submatrix(idx1=blk, idx2=blk)

    def blk_dense(self, blk: torch.Tensor) -> torch.Tensor:
        """K[blk, blk] materialized as a dense (|blk|, |blk|) tensor, in the
        payload dtype (a small dense tile, outside the Gram kernels)."""
        Xs = scale_inputs(self._X1[blk], self._ls)
        Ys = scale_inputs(self._X2[blk], self._ls)
        return self._apply_scale(kernel_tile(self.kind, Xs, Ys) * self._c)


class _TileOperand:
    """The register tile's operand of one point set (``tile_operand(X, ℓ)``:
    the scaled points transposed and padded), built on first use and kept."""

    def __init__(self, X: torch.Tensor, lengthscale: torch.Tensor):
        self._X, self._ls, self._XT = X, lengthscale, None

    def get(self) -> torch.Tensor:
        if self._XT is None:
            self._XT = tile_operand(self._X, self._ls)
        return self._XT
