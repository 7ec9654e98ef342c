"""Routing of the streaming kernel matmat to a kernel or its plain version.

Port of ``rlaopt_tpu/ops/kernel_dispatch.py``. The rule is the tensor's
device and nothing else: CPU tensors go to the plain PyTorch versions
(:mod:`rlaopt_tpu_torch.ops.kernel_plain`); CUDA tensors go to the CUDA
kernels (:mod:`rlaopt_tpu_torch.ops.kernel_cuda`), which raise on what they
cannot take. A CUDA tensor never falls back to the plain version.

Which kernel, on a card:

* exact tier (:func:`kernel_matmat`): the triangle kernel K2 when the
  operator was built on one data set (``symmetric``) and ``k ≤ 16``, the
  general kernel K1 otherwise;
* bf16 tiers (:func:`kernel_matmat_tier`): the same rule between K2b and
  K1b, on the tier parts of :mod:`rlaopt_tpu_torch.ops.kernel_tiers` that
  the operator keeps;
* float64 (:func:`kernel_matmat_f64`): K7 when symmetric, K8 otherwise.

On the CPU, float64 points take the float64 plain product, as the JAX
package's XLA route takes the exact path for them.
"""

import torch

from . import kernel_cuda, kernel_plain
from .kernel_tiers import TierOperand


__all__ = [
    "kernel_matmat",
    "kernel_matmat_tier",
    "kernel_matmat_compensated",
    "kernel_matmat_f64",
]


def kernel_matmat(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    symmetric: bool = False,
) -> torch.Tensor:
    """``c·k(X1, X2) @ V`` on the exact tier, on the device of the operands.

    ``symmetric=True`` asserts that X1 and X2 are the same data set (the
    operator checks object identity when it is built). The bf16 tiers go
    through :func:`kernel_matmat_tier`.
    """
    if not X1.is_cuda:
        if X1.dtype == torch.float64:
            return kernel_plain.gram_matmat_f64(
                kind, X1, X2, V, lengthscale, const_scaling
            )
        return kernel_plain.gram_matmat(kind, X1, X2, V, lengthscale, const_scaling)
    k = 1 if V.ndim == 1 else V.shape[1]
    if symmetric and X1.shape[0] == X2.shape[0] and k <= kernel_cuda.SYMMETRIC_MAX_K:
        return kernel_cuda.gram_matvec_symmetric(
            kind, X1, V, lengthscale, const_scaling
        )
    return kernel_cuda.gram_matmat(kind, X1, X2, V, lengthscale, const_scaling)


def kernel_matmat_tier(
    kind: str,
    A: TierOperand,
    B: TierOperand,
    V: torch.Tensor,
    const_scaling=1.0,
    symmetric: bool = False,
) -> torch.Tensor:
    """``c·k(X1, X2) @ V`` on a bf16 tier from the parts of X1 (A) and X2
    (B), on their device: K2b when ``symmetric`` and k ≤ 16, K1b otherwise,
    the plain versions of the tier on the CPU."""
    k = 1 if V.ndim == 1 else V.shape[1]
    triangle = symmetric and k <= kernel_cuda.SYMMETRIC_MAX_K
    if not A.hi.is_cuda:
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
):
    """``c·k(X1, X2) @ V`` as a compensated ``(hi, lo)`` pair (add ``lo``
    last), on the device of the operands."""
    if not X1.is_cuda:
        return kernel_plain.gram_matmat_comp(
            kind, X1, X2, V, lengthscale, const_scaling
        )
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
    if not X1.is_cuda:
        return kernel_plain.gram_matmat_f64(kind, X1, X2, V, lengthscale, const_scaling)
    V = V.double()
    if symmetric and X1.shape[0] == X2.shape[0]:
        return kernel_cuda.gram_matvec_symmetric_f64(
            kind, X1, V, lengthscale, const_scaling
        )
    return kernel_cuda.gram_matmat_f64(kind, X1, X2, V, lengthscale, const_scaling)
