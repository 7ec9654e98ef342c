"""Routing of the streaming kernel matmat to a kernel or its plain version.

Port of ``rlaopt_tpu/ops/kernel_dispatch.py``. The rule (``impl="auto"``)
is the tensor's device and nothing else: CPU tensors go to the plain
PyTorch versions (:mod:`rlaopt_tpu_torch.ops.kernel_plain`); CUDA tensors go
to the CUDA kernels (:mod:`rlaopt_tpu_torch.ops.kernel_cuda`), which raise
on what they cannot take. A CUDA tensor never falls back to the plain
version. The caller may ask otherwise, as in the JAX package: ``impl="xla"``
takes the plain version on any device, ``impl="pallas"`` the CUDA kernel
(and raises on a CPU tensor); any other value raises ``ValueError``.

Which kernel, on a card:

* exact tier (:func:`kernel_matmat`): the triangle kernel K2 when the
  operator was built on one data set (``symmetric``) and ``k ≤ 16``, the
  general kernel K1 otherwise; for the Laplace family K5 and K3 by the same
  rule (the JAX package's gate without its VMEM window). K1 and K3 take the
  Hopper register tile up to 16 columns, past that the 3xTF32 tensor-core
  kernel; K2 and K5 are the tile's triangle form; all on the operand of the
  points an operator keeps;
* compensated (:func:`kernel_matmat_compensated`): the float64 tile's
  triangle form of K1c and K3c when symmetric (any k, every family), its
  forward form (K1c, K3c for Laplace) otherwise;
* bf16 tiers (:func:`kernel_matmat_tier`): the same rule between K2b and
  K1b, on the tier parts of :mod:`rlaopt_tpu_torch.ops.kernel_tiers` that
  the operator keeps;
* float64 (:func:`kernel_matmat_f64`): K7 when symmetric, K8 otherwise;
* certified pairs (:func:`kernel_pair_compensated`, :func:`kernel_pair_f64`):
  ``(c·K @ V2, c·Kᵀ @ V1)`` in float64 sums, K evaluated once in float64
  (the float64 tile's pair form, any k, every family), for the sharded
  half-ring's certified routes;
* pairs (:func:`kernel_pair`, :func:`kernel_pair_tier`): ``(c·K @ V2,
  c·Kᵀ @ V1)`` with K evaluated once, through K4 (K6 for Laplace: the
  tile's pair form; K4b on the tiers) when k ≤ 16, and through two general
  calls past that, as the JAX package's ``kernel_pair`` does; both on the
  operands of the two point sets the half-ring keeps.

On the CPU, float64 points take the float64 plain product, as the JAX
package's XLA route takes the exact path for them.
"""

import torch

from . import kernel_cuda, kernel_plain
from .kernel_tiers import TierOperand


__all__ = [
    "check_impl",
    "kernel_matmat",
    "kernel_matmat_tier",
    "kernel_matmat_compensated",
    "kernel_matmat_f64",
    "kernel_pair",
    "kernel_pair_tier",
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


def kernel_matmat(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    symmetric: bool = False,
    impl: str = "auto",
    tile_operands=None,
) -> torch.Tensor:
    """``c·k(X1, X2) @ V`` on the exact tier, on the device of the operands.

    ``symmetric=True`` asserts that X1 and X2 are the same data set (the
    operator checks object identity when it is built). The bf16 tiers go
    through :func:`kernel_matmat_tier`. ``tile_operands``: None, or a
    callable giving the register tile its operands of (X1, X2)
    (:func:`kernel_cuda.tile_operand`), called only when a kernel on them
    runs (the triangle form takes the first).
    """
    if not _on_card(impl, X1):
        if X1.dtype == torch.float64:
            return kernel_plain.gram_matmat_f64(
                kind, X1, X2, V, lengthscale, const_scaling
            )
        return kernel_plain.gram_matmat(kind, X1, X2, V, lengthscale, const_scaling)
    k = 1 if V.ndim == 1 else V.shape[1]
    laplace = kind == "laplace"
    if symmetric and X1.shape[0] == X2.shape[0] and k <= kernel_cuda.SYMMETRIC_MAX_K:
        operand = None if tile_operands is None else tile_operands()[0]
        if laplace:
            return kernel_cuda.laplace_matvec_symmetric(X1, V, lengthscale, const_scaling,
                                                        operand)
        return kernel_cuda.gram_matvec_symmetric(kind, X1, V, lengthscale, const_scaling,
                                                 operand)
    if laplace:
        return kernel_cuda.laplace_matmat(X1, X2, V, lengthscale, const_scaling,
                                          tile_operands)
    return kernel_cuda.gram_matmat(kind, X1, X2, V, lengthscale, const_scaling, tile_operands)


def kernel_matmat_tier(
    kind: str,
    A: TierOperand,
    B: TierOperand,
    V: torch.Tensor,
    const_scaling=1.0,
    symmetric: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """``c·k(X1, X2) @ V`` on a bf16 tier from the parts of X1 (A) and X2
    (B), on their device: K2b when ``symmetric`` and k ≤ 16, K1b otherwise,
    the plain versions of the tier on the CPU."""
    k = 1 if V.ndim == 1 else V.shape[1]
    triangle = symmetric and k <= kernel_cuda.SYMMETRIC_MAX_K
    if not _on_card(impl, A.hi):
        if triangle:
            return kernel_plain.gram_matvec_symmetric_tier(kind, A, V, const_scaling)
        return kernel_plain.gram_matmat_tier(kind, A, B, V, const_scaling)
    if triangle:
        return kernel_cuda.gram_matvec_symmetric_tier(kind, A, V, const_scaling)
    return kernel_cuda.gram_matmat_tier(kind, A, B, V, const_scaling)


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
    plain version is the general one). Two data sets take the general K1c,
    or K3c for Laplace."""
    if not _on_card(impl, X1):
        return kernel_plain.gram_matmat_comp(
            kind, X1, X2, V, lengthscale, const_scaling
        )
    if symmetric and X1.shape[0] == X2.shape[0]:
        return kernel_cuda.gram_matvec_symmetric_comp(kind, X1, V, lengthscale, const_scaling)
    if kind == "laplace":
        return kernel_cuda.laplace_matmat_comp(X1, X2, V, lengthscale, const_scaling)
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
    tile_operands=None,
):
    """``(c·K @ V2, c·Kᵀ @ V1)`` with ``K = k(X1, X2)``, on the exact tier, on
    the device of the operands: K evaluated once for k ≤ 16 (K4, or K6 for
    Laplace, on a card; the plain pair on the CPU), two general calls past
    that. 1-D operands give 1-D outputs. The building block of the
    symmetric half-ring of
    :class:`rlaopt_tpu_torch.kernels.sharded.ShardedKernelLinOp`.
    ``tile_operands``: None, or a callable giving the register tile's
    operands of (X1, X2), as for :func:`kernel_matmat`; the pair kernel and
    both general calls (the second with the two swapped) take them."""
    k = 1 if V2.ndim == 1 else V2.shape[1]
    if k > kernel_cuda.SYMMETRIC_MAX_K:
        swapped = None if tile_operands is None else (lambda: tile_operands()[::-1])
        return (
            kernel_matmat(kind, X1, X2, V2, lengthscale, const_scaling, impl=impl,
                          tile_operands=tile_operands),
            kernel_matmat(kind, X2, X1, V1, lengthscale, const_scaling, impl=impl,
                          tile_operands=swapped),
        )
    if not _on_card(impl, X1):
        return kernel_plain.gram_pair(kind, X1, X2, V2, V1, lengthscale, const_scaling)
    if kind == "laplace":
        return kernel_cuda.laplace_pair(X1, X2, V2, V1, lengthscale, const_scaling,
                                        tile_operands)
    return kernel_cuda.gram_pair(kind, X1, X2, V2, V1, lengthscale, const_scaling,
                                 tile_operands)


def kernel_pair_tier(
    kind: str,
    A: TierOperand,
    B: TierOperand,
    V2: torch.Tensor,
    V1: torch.Tensor,
    const_scaling=1.0,
    impl: str = "auto",
):
    """:func:`kernel_pair` on a bf16 tier from the parts of X1 (A) and X2 (B):
    K4b for k ≤ 16 on a card (the plain tier pair on the CPU), two K1b calls
    past that."""
    k = 1 if V2.ndim == 1 else V2.shape[1]
    if k > kernel_cuda.SYMMETRIC_MAX_K:
        return (
            kernel_matmat_tier(kind, A, B, V2, const_scaling, impl=impl),
            kernel_matmat_tier(kind, B, A, V1, const_scaling, impl=impl),
        )
    if not _on_card(impl, A.hi):
        return kernel_plain.gram_pair_tier(kind, A, B, V2, V1, const_scaling)
    return kernel_cuda.gram_pair_tier(kind, A, B, V2, V1, const_scaling)


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
