"""Kernel Gram linear operators (single device).

Port of ``rlaopt_tpu/kernels/linop.py``. The operator holds the data (X1,
X2), the lengthscale and the scale; its applies stream kernel tiles through
:func:`rlaopt_tpu_torch.ops.kernel_dispatch.kernel_matmat_points` (the CUDA
kernels for CUDA tensors, the plain versions for CPU tensors). K is never
materialized, except by :meth:`KernelLinOp.blk_dense` for a block. The
operator keeps each data set as a
:class:`~rlaopt_tpu_torch.ops.kernel_dispatch.PointSet`: on a bf16
``compute_dtype`` with its tier parts, made once when it is built, and on
the exact tier with the register tile's operand, built the first time a
kernel takes it. The row and block oracles gather their tier parts from
the parent's, and a row oracle shares its parent's point set for the
columns.
"""

from typing import Optional

import torch

from .configs import KernelConfig, _is_kernel_config
from .functions import kernel_tile, scale_inputs
from ..linops.base import TwoSidedLinOp
from ..ops.kernel_dispatch import (
    check_impl,
    kernel_matmat_compensated,
    kernel_matmat_points,
    point_set,
)
from ..ops.kernel_tiers import normalize_compute_dtype
from ..utils.checkers import _is_tensor
from ..utils.profiling import annotate, traced


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
        _points=None,
        _ls=None,
    ):
        """``_points``: the point sets of (A1, A2), passed on by the oracles
        (their tier parts gathered from their parent's); None makes them
        here. ``_ls``: the lengthscale on the device in the points' dtype
        and in float64, passed on by the oracles (making it copies a host
        value to the card, which waits for the card); None makes it here."""
        self._check_inputs(A1, A2, kernel_config)
        compute_dtype = normalize_compute_dtype(compute_dtype)
        self.kind = kind
        self.impl = check_impl(impl)
        self.compute_dtype = compute_dtype
        self._kernel_config = kernel_config
        self._X1, self._X2 = A1, A2
        # The compensated apply divides by the lengthscale in float64.
        self._ls, self._ls64 = _ls if _ls is not None else (
            kernel_config.lengthscale_tensor(A1.dtype, A1.device),
            kernel_config.lengthscale_tensor(torch.float64, A1.device))
        self._c = float(kernel_config.const_scaling)
        # One data set on both sides: the apply may take the triangle kernel.
        symmetric = self._symmetric = A1 is A2
        if _points is None:
            P = point_set(A1, self._ls, kind, compute_dtype)
            _points = (P, P if symmetric else point_set(A2, self._ls, kind, compute_dtype))
        self._points = P1, P2 = _points

        @traced("rlaopt.linop.matmat")
        def mv(v):
            return kernel_matmat_points(kind, P1, P2, v, self._ls, self._c, symmetric, impl)

        def rmv(v):
            # k is symmetric in its arguments: Kᵀ = k(X2, X1)
            return kernel_matmat_points(kind, P2, P1, v, self._ls, self._c, symmetric, impl)

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

    @traced("rlaopt.linop.matmat_compensated")
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
        P1, P2 = self._points
        if idx1 is not None:
            P1 = P1.rows(idx1)
        if idx2 is not None:
            P2 = P2.rows(idx2)
        return KernelLinOp(
            P1.X, P2.X, self._kernel_config, self.kind, self.impl, self.compute_dtype,
            _points=(P1, P2), _ls=(self._ls, self._ls64),
        )

    def row_oracle(self, blk: torch.Tensor) -> "KernelLinOp":
        """K[blk, :] as an operator."""
        return self._submatrix(idx1=blk)

    def blk_oracle(self, blk: torch.Tensor) -> "KernelLinOp":
        """K[blk, blk] as an operator."""
        return self._submatrix(idx1=blk, idx2=blk)

    def blk_dense(self, blk: torch.Tensor) -> torch.Tensor:
        """K[blk, blk] materialized as a dense (|blk|, |blk|) tensor, in the
        payload dtype (a small dense tile, outside the Gram kernels). Its
        span, ``rlaopt.linop.blk_dense``, carries the card's time on a card."""
        with annotate("rlaopt.linop.blk_dense", self._X1):
            Xs = scale_inputs(self._X1[blk], self._ls)
            Ys = scale_inputs(self._X2[blk], self._ls)
            return self._apply_scale(kernel_tile(self.kind, Xs, Ys) * self._c)

