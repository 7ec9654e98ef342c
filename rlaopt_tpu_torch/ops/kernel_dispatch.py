"""Routing of the streaming kernel matmat to a kernel or its plain version.

Port of ``rlaopt_tpu/ops/kernel_dispatch.py``. The rule is the tensor's
device and nothing else: CPU tensors go to the plain PyTorch versions
(:mod:`rlaopt_tpu_torch.ops.kernel_plain`); CUDA tensors go to the CUDA
kernels (:mod:`rlaopt_tpu_torch.ops.kernel_cuda`), which raise on what they
cannot take. A CUDA tensor never falls back to the plain version.

On a card, the triangle kernel K2 takes the apply when the operator was
built on one data set (``symmetric``), ``k ≤ 16`` and the tier is exact;
every other apply takes the general kernel K1.
"""

import torch

from . import kernel_cuda, kernel_plain


__all__ = ["kernel_matmat", "kernel_matmat_compensated", "check_compute_dtype"]


def check_compute_dtype(compute_dtype):
    """The port has the exact f32 tier only (``compute_dtype=None``)."""
    if compute_dtype is not None:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: the bf16x3 and bfloat16 tiers "
            "are not ported yet (ROADMAP Queue 2, kernel #1b)"
        )


def kernel_matmat(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    compute_dtype=None,
    symmetric: bool = False,
) -> torch.Tensor:
    """``c·k(X1, X2) @ V`` on the device of the operands.

    ``symmetric=True`` asserts that X1 and X2 are the same data set (the
    operator checks object identity when it is built).
    """
    check_compute_dtype(compute_dtype)
    if not X1.is_cuda:
        return kernel_plain.gram_matmat(kind, X1, X2, V, lengthscale, const_scaling)
    k = 1 if V.ndim == 1 else V.shape[1]
    if symmetric and X1.shape[0] == X2.shape[0] and k <= kernel_cuda.SYMMETRIC_MAX_K:
        return kernel_cuda.gram_matvec_symmetric(
            kind, X1, V, lengthscale, const_scaling
        )
    return kernel_cuda.gram_matmat(kind, X1, X2, V, lengthscale, const_scaling)


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
