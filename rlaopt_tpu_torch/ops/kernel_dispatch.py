"""Routing of the streaming kernel products to a kernel or its plain version.

Port of ``rlaopt_tpu/ops/kernel_dispatch.py``. The rule (``impl="auto"``)
is the tensor's device and nothing else: CPU tensors go to the plain
PyTorch versions (:mod:`rlaopt_tpu_torch.ops.kernel_plain`); CUDA tensors go
to the CUDA kernels (:mod:`rlaopt_tpu_torch.ops.kernel_cuda`), which raise
on what they cannot take. A CUDA tensor never falls back to the plain
version. The caller may ask otherwise, as in the JAX package: ``impl="xla"``
takes the plain version on any device, ``impl="pallas"`` the CUDA kernel
(and raises on a CPU tensor); any other value raises ``ValueError``.

The operators hand their points to the kernels as :class:`PointSet`: the
points, their bf16 tier parts (made with the set, by :func:`point_set`) and
the register tile's operand (built by the first exact-tier product on a
card that takes it, then kept). Which kernel, on a card:

* products (:func:`kernel_matmat_points`): on a bf16 tier K2b when the
  operator was built on one data set (``symmetric``) and ``k ≤ 16``, K1b
  otherwise; on the exact tier, every family, the triangle K2 by the same
  rule (the JAX package's gate without its VMEM window), the general K1
  otherwise: the Hopper register tile up to 16 columns, past that the
  3xTF32 tensor-core kernel. Laplace is the family code of the same
  kernels (K5, K3);
* pairs (:func:`kernel_pair_points`): ``(c·K @ V2, c·Kᵀ @ V1)`` with K
  evaluated once, through K4b on a tier and the tile's pair form K4 (K6 for
  Laplace) on the exact tier when k ≤ 16, and through two general products
  past that, as the JAX package's ``kernel_pair`` does;
* compensated (:func:`kernel_matmat_compensated`): the float64 tile's
  triangle form of K1c and K3c when symmetric (any k, every family), its
  forward form (K1c, K3c for Laplace) otherwise;
* float64 (:func:`kernel_matmat_f64`): K7 when symmetric, K8 otherwise;
* certified pairs (:func:`kernel_pair_compensated`, :func:`kernel_pair_f64`):
  ``(c·K @ V2, c·Kᵀ @ V1)`` in float64 sums, K evaluated once in float64
  (the float64 tile's pair form, any k, every family), for the sharded
  half-ring's certified routes.

:func:`kernel_matmat` and :func:`kernel_pair` take the JAX package's
parameters in its order and route through the same two functions on point
sets made for the call. On the CPU, float64 points take the float64 plain
product, as the JAX package's XLA route takes the exact path for them.
"""

from dataclasses import dataclass
from typing import Optional

import torch

from . import kernel_cuda, kernel_plain
from .kernel_tiers import TierOperand, normalize_compute_dtype, tier_operand
from ..kernels.functions import scale_inputs


__all__ = [
    "check_impl",
    "PointSet",
    "point_set",
    "kernel_matmat_points",
    "kernel_pair_points",
    "kernel_matmat",
    "kernel_matmat_compensated",
    "kernel_matmat_f64",
    "kernel_pair",
    "kernel_pair_compensated",
    "kernel_pair_f64",
]


IMPLS = ("auto", "pallas", "xla")


def check_impl(impl: str) -> str:
    """``impl`` if it is one of :data:`IMPLS`; ``ValueError`` otherwise."""
    if impl not in IMPLS:
        raise ValueError(f"Unknown kernel impl {impl!r}")
    return impl


def _on_card(impl: str, t: torch.Tensor) -> bool:
    """Whether ``impl`` sends operands like ``t`` to the CUDA kernels."""
    if check_impl(impl) == "auto":
        return t.is_cuda
    if impl == "pallas" and not t.is_cuda:
        raise ValueError(
            f"impl='pallas' asks for the CUDA kernels; the operands lie on {t.device}"
        )
    return impl == "pallas"


@dataclass
class PointSet:
    """One set of points in the formats the kernels take.

    X: (n, d) the points. tier: their bf16 tier parts
    (:class:`~rlaopt_tpu_torch.ops.kernel_tiers.TierOperand`) on a bf16
    tier, else None. tile: the register tile's operand
    (:func:`kernel_cuda.tile_operand`), None until the first exact-tier
    product on a card that takes it builds it; kept from then on. Every
    field is a tensor, a dataclass of tensors or None, so that
    :mod:`rlaopt_tpu_torch.parallel.mesh` moves a set and carries it across
    processes as it is.
    """

    X: torch.Tensor
    tier: Optional[TierOperand] = None
    tile: Optional[torch.Tensor] = None

    def rows(self, idx) -> "PointSet":
        """The points ``idx``: their tier parts gathered from these, not a
        new split; their tile operand built when a kernel takes it."""
        return PointSet(self.X[idx], None if self.tier is None else self.tier.rows(idx))


def point_set(X: torch.Tensor, lengthscale, kind: str, compute_dtype=None) -> PointSet:
    """The point set of ``X`` for ``kind`` at ``compute_dtype`` (None,
    ``"bf16x3"``, ``"bfloat16"``): with tier parts of ``X / ℓ`` made here on
    a bf16 tier, except for the Laplace family (no tier, as in the JAX
    package, whose Laplace kernel takes no ``compute_dtype``) and float64
    points (the exact path, as the JAX package's XLA route takes them)."""
    cd = normalize_compute_dtype(compute_dtype)
    if cd is None or kind == "laplace" or X.dtype != torch.float32:
        return PointSet(X)
    return PointSet(X, tier_operand(scale_inputs(X, lengthscale), cd))


def _tile(P: PointSet, lengthscale) -> Optional[torch.Tensor]:
    """The register tile's operand of float32 points, built on first use
    and kept on ``P``; None for other points (which the kernels refuse)."""
    if P.tile is None and P.X.dtype == torch.float32:
        P.tile = kernel_cuda.tile_operand(P.X, lengthscale)
    return P.tile


def kernel_matmat_points(
    kind: str,
    L: PointSet,
    R: PointSet,
    V: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    symmetric: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """``c·k(L, R) @ V`` on the device of the points, on L's tier.
    ``symmetric=True`` asserts that L and R are one data set: K2b or K2
    (K5) for k ≤ 16, on the plain version of the tier or the general plain
    product on the CPU; K1b or K1 (K3) otherwise."""
    k = 1 if V.ndim == 1 else V.shape[1]
    triangle = (symmetric and L.X.shape[0] == R.X.shape[0]
                and k <= kernel_cuda.SYMMETRIC_MAX_K)
    card = _on_card(impl, L.X)
    if L.tier is not None:
        ops = kernel_cuda if card else kernel_plain
        if triangle:
            return ops.gram_matvec_symmetric_tier(kind, L.tier, V, const_scaling)
        return ops.gram_matmat_tier(kind, L.tier, R.tier, V, const_scaling)
    if not card:
        if L.X.dtype == torch.float64:
            return kernel_plain.gram_matmat_f64(kind, L.X, R.X, V, lengthscale, const_scaling)
        return kernel_plain.gram_matmat(kind, L.X, R.X, V, lengthscale, const_scaling)
    if triangle:
        return kernel_cuda.gram_matvec_symmetric(kind, L.X, V, lengthscale, const_scaling,
                                                 _tile(L, lengthscale))
    return kernel_cuda.gram_matmat(kind, L.X, R.X, V, lengthscale, const_scaling,
                                   _tile(L, lengthscale), _tile(R, lengthscale))


def kernel_pair_points(
    kind: str,
    L: PointSet,
    R: PointSet,
    V2: torch.Tensor,
    V1: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    impl: str = "auto",
):
    """``(c·K @ V2, c·Kᵀ @ V1)`` with ``K = k(L, R)``, on the device of the
    points, on L's tier: K evaluated once for k ≤ 16 (K4b, or K4 and K6 on
    the tile's operands of both sets, on a card; the plain pairs on the
    CPU), two general products past that. 1-D operands give 1-D outputs.
    The building block of the symmetric half-ring of
    :class:`rlaopt_tpu_torch.kernels.sharded.ShardedKernelLinOp`."""
    k = 1 if V2.ndim == 1 else V2.shape[1]
    if k > kernel_cuda.SYMMETRIC_MAX_K:
        return (
            kernel_matmat_points(kind, L, R, V2, lengthscale, const_scaling, impl=impl),
            kernel_matmat_points(kind, R, L, V1, lengthscale, const_scaling, impl=impl),
        )
    card = _on_card(impl, L.X)
    if L.tier is not None:
        ops = kernel_cuda if card else kernel_plain
        return ops.gram_pair_tier(kind, L.tier, R.tier, V2, V1, const_scaling)
    if not card:
        return kernel_plain.gram_pair(kind, L.X, R.X, V2, V1, lengthscale, const_scaling)
    return kernel_cuda.gram_pair(kind, L.X, R.X, V2, V1, lengthscale, const_scaling,
                                 _tile(L, lengthscale), _tile(R, lengthscale))


def _point_sets(kind, X1, X2, lengthscale, compute_dtype, symmetric):
    """Point sets of (X1, X2) made for one call; one set when they are one
    data set."""
    L = point_set(X1, lengthscale, kind, compute_dtype)
    return L, L if symmetric or X2 is X1 else point_set(X2, lengthscale, kind, compute_dtype)


def kernel_matmat(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    impl: str = "auto",
    compute_dtype=None,
    symmetric: bool = False,
) -> torch.Tensor:
    """``c·k(X1, X2) @ V`` on the device of the operands, with the JAX
    package's parameters in its order: :func:`kernel_matmat_points` on
    point sets made for this call (an operator keeps its own).
    ``compute_dtype``: None (the exact tier), ``"bf16x3"`` or
    ``"bfloat16"``. ``symmetric=True`` asserts that X1 and X2 are the same
    data set (the operator checks object identity when it is built)."""
    L, R = _point_sets(kind, X1, X2, lengthscale, compute_dtype, symmetric)
    return kernel_matmat_points(kind, L, R, V, lengthscale, const_scaling, symmetric, impl)


def kernel_matmat_compensated(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    symmetric: bool = False,
    impl: str = "auto",
):
    """``c·k(X1, X2) @ V`` as a compensated ``(hi, lo)`` pair (add ``lo``
    last), on the device of the operands. ``symmetric=True`` asserts that
    X1 and X2 are one data set: on a card the triangle form of K1c and K3c
    evaluates each tile pair once, in every family (the same function; its
    plain version is the general one). Two data sets take the forward form
    (K1c, K3c for Laplace)."""
    if not _on_card(impl, X1):
        return kernel_plain.gram_matmat_comp(
            kind, X1, X2, V, lengthscale, const_scaling
        )
    if symmetric and X1.shape[0] == X2.shape[0]:
        return kernel_cuda.gram_matvec_symmetric_comp(kind, X1, V, lengthscale, const_scaling)
    return kernel_cuda.gram_matmat_comp(kind, X1, X2, V, lengthscale, const_scaling)


def kernel_matmat_f64(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    symmetric: bool = False,
) -> torch.Tensor:
    """``c·k(X1, X2) @ V`` in float64 (float64 out), on the device of the
    operands: K7 when ``symmetric`` (X1 and X2 one data set), K8 otherwise,
    the plain float64 version on the CPU. On a card the points are float32
    (the kernels cast them exactly); the lengthscale is taken in float64."""
    if not _on_card("auto", X1):
        return kernel_plain.gram_matmat_f64(kind, X1, X2, V, lengthscale, const_scaling)
    V = V.double()
    if symmetric and X1.shape[0] == X2.shape[0]:
        return kernel_cuda.gram_matvec_symmetric_f64(
            kind, X1, V, lengthscale, const_scaling
        )
    return kernel_cuda.gram_matmat_f64(kind, X1, X2, V, lengthscale, const_scaling)


def kernel_pair(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V2: torch.Tensor,
    V1: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    impl: str = "auto",
    compute_dtype=None,
):
    """``(c·K @ V2, c·Kᵀ @ V1)`` with ``K = k(X1, X2)``, on the device of the
    operands, with the JAX package's parameters in its order:
    :func:`kernel_pair_points` on point sets made for this call."""
    L, R = _point_sets(kind, X1, X2, lengthscale, compute_dtype, False)
    return kernel_pair_points(kind, L, R, V2, V1, lengthscale, const_scaling, impl)


def kernel_pair_compensated(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V2: torch.Tensor,
    V1: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    impl: str = "auto",
):
    """``(c·K @ V2, c·Kᵀ @ V1)`` with ``K = k(X1, X2)`` as float64 sums from
    float32 V, on the device of the operands: K1c's pair form on a card
    (:func:`kernel_cuda.gram_pair_comp`, every family), the plain float64
    pair on the CPU. The caller splits the sums into ``(hi, lo)``."""
    if not _on_card(impl, X1):
        return kernel_plain.gram_pair_comp(kind, X1, X2, V2, V1, lengthscale, const_scaling)
    return kernel_cuda.gram_pair_comp(kind, X1, X2, V2, V1, lengthscale, const_scaling)


def kernel_pair_f64(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V2: torch.Tensor,
    V1: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
):
    """:func:`kernel_pair_compensated` with float64 V (K8's pair form on a
    card); float64 out."""
    if not _on_card("auto", X1):
        return kernel_plain.gram_pair_f64(kind, X1, X2, V2, V1, lengthscale, const_scaling)
    return kernel_cuda.gram_pair_f64(kind, X1, X2, V2.double(), V1.double(), lengthscale,
                                     const_scaling)
