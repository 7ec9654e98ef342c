"""Plain PyTorch versions of the Gram kernels in ``csrc/gram.cu``.

Counterpart of ``rlaopt_tpu/ops/kernel_xla.py``. One function per CUDA
kernel, with the same signature as its wrapper in
:mod:`rlaopt_tpu_torch.ops.kernel_cuda`:

* :func:`gram_matmat` (K1) streams row blocks of K = k(X1, X2) and
  contracts each with V at once, as ``kernel_matmat_xla`` does; peak memory
  is one (row_block, m) tile. Any dtype, all five kernel families.
* :func:`gram_matmat_comp` (K1c) loops over column tiles of X2 and
  TwoSum-adds each tile's partial into a ``(hi, lo)`` pair. As in the CUDA
  kernel, the inputs are divided by the lengthscale, and a tile's kernel
  values and its partial (times the constant) are taken, in float64; the
  partial is split into a pair of the input dtype before the TwoSum.
* :func:`gram_matvec_symmetric` (K2) is K1 on ``(X, X)``.

The dispatcher sends CPU tensors here; ``chip_smoke.py`` runs them on the
card only to check and time the kernels.
"""

from typing import Optional

import torch

from ..kernels.functions import kernel_tile, scale_inputs


__all__ = ["gram_matmat", "gram_matmat_comp", "gram_matvec_symmetric"]

# Elements in one streamed tile, the JAX package's budget (kernel_xla.py).
_TILE_ELEMENTS = 1 << 23


def _block(requested: Optional[int], other: int) -> int:
    if requested is not None:
        return max(1, requested)
    return max(8, min(4096, _TILE_ELEMENTS // max(other, 1)))


def _as_2d(V):
    return (V[:, None], True) if V.ndim == 1 else (V, False)


def gram_matmat(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    row_block: Optional[int] = None,
) -> torch.Tensor:
    """``c·k(X1, X2) @ V`` without materializing the Gram matrix.

    Args:
        kind: kernel family ("rbf", "laplace", "matern12/32/52").
        X1: (n, d) left points.
        X2: (m, d) right points.
        V: (m,) or (m, k) right-hand side.
        lengthscale: float or (d,) ARD lengthscale.
        const_scaling: scalar multiplier on the kernel.
        row_block: streamed tile height (from a memory budget if None).
    """
    V, squeeze = _as_2d(V)
    Xs = scale_inputs(X1, lengthscale)
    Ys = scale_inputs(X2, lengthscale)
    bm = _block(row_block, X2.shape[0])
    out = torch.empty((X1.shape[0], V.shape[1]), dtype=V.dtype, device=V.device)
    for s in range(0, X1.shape[0], bm):
        out[s : s + bm] = kernel_tile(kind, Xs[s : s + bm], Ys) @ V
    out = out * const_scaling
    return out[:, 0] if squeeze else out


def gram_matmat_comp(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    col_block: Optional[int] = None,
):
    """``c·k(X1, X2) @ V`` as a compensated ``(hi, lo)`` pair.

    Column-tile partials are added by Knuth's TwoSum, so ``hi + lo``
    carries their rounding errors. Consumers subtract ``lo`` last:
    ``(B − reg·W − hi) − lo``.
    """
    V, squeeze = _as_2d(V)
    Xs64 = scale_inputs(X1.double(), lengthscale)
    Ys64 = scale_inputs(X2.double(), lengthscale)
    n, k = X1.shape[0], V.shape[1]
    bn = _block(col_block, n)
    hi = torch.zeros((n, k), dtype=V.dtype, device=V.device)
    lo = torch.zeros_like(hi)
    for s in range(0, X2.shape[0], bn):
        K = kernel_tile(kind, Xs64, Ys64[s : s + bn])
        p = (K @ V[s : s + bn].double()) * const_scaling
        p_hi = p.to(V.dtype)
        hi, e = _two_sum(hi, p_hi)
        lo += e + (p - p_hi.double()).to(V.dtype)
    return (hi[:, 0], lo[:, 0]) if squeeze else (hi, lo)


def _two_sum(a, b):
    """Knuth TwoSum: ``a + b = s + e`` exactly."""
    s = a + b
    z = s - a
    return s, (a - (s - z)) + (b - z)


def gram_matvec_symmetric(
    kind: str,
    X: torch.Tensor,
    V: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    row_block: Optional[int] = None,
) -> torch.Tensor:
    """``c·k(X, X) @ V``: the plain version is K1 on ``(X, X)``."""
    return gram_matmat(kind, X, X, V, lengthscale, const_scaling, row_block)
