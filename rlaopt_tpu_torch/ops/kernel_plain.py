"""Plain PyTorch versions of the Gram kernels in ``csrc/gram.cu``.

Counterpart of ``rlaopt_tpu/ops/kernel_xla.py``. One function per CUDA
kernel, with the same signature as its wrapper in
:mod:`rlaopt_tpu_torch.ops.kernel_cuda`:

* :func:`gram_matmat` (K1) streams row blocks of K = k(X1, X2) and
  contracts each with V at once, as ``kernel_matmat_xla`` does; peak memory
  is one (row_block, m) tile. All five kernel families, in the dtype of
  the points (the dispatcher sends float64 points to
  :func:`gram_matmat_f64`).
* :func:`gram_matmat_comp` (K1c) loops over column tiles of X2 and
  TwoSum-adds each tile's partial into a ``(hi, lo)`` pair. As in the CUDA
  kernel, the inputs are divided by the lengthscale, and a tile's kernel
  values and its partial (times the constant) are taken, in float64; the
  partial is split into a pair of the input dtype before the TwoSum (the
  kernel sums all of its partials in float64 and splits once: both are
  the float64 product to ~1e-15 relative).
* :func:`gram_matvec_symmetric` (K2) is K1 on ``(X, X)``. Past 16
  columns the card's K1 contracts on the tensor cores in 3xTF32, each
  value and each V entry split by :func:`tf32_split` (hi + lo, ~2⁻²² of
  the value); its plain version is this full float32 product.
* :func:`gram_matmat_tier` (K1b) and :func:`gram_matvec_symmetric_tier`
  (K2b): the bf16 tiers of :mod:`rlaopt_tpu_torch.ops.kernel_tiers`, cross
  term from the bf16 parts, kernel values and contraction in float32. The
  contraction takes K1b's engine: float32 for k ≤ 16, the tier-matched
  bf16 passes for k > 16 (``"split"``, three passes of hi/lo for bf16x3;
  ``"fast"``, one bf16 pass, for bfloat16). The triangle reproduces K2b's
  schedule: row tile I contracts the tiles J ≥ I forward in float32 and
  serves the rows of every tile J > I through the mirror, which at k ≥ 3
  takes the tier-matched contraction (``_sym_mirror_mode``).
* :func:`gram_pair` (K4, and K6 for Laplace) and :func:`gram_pair_tier`
  (K4b): ``(c·K @ V2, c·Kᵀ @ V1)`` with K = k(X1, X2), each row block of K
  evaluated once and contracted both ways. :func:`gram_pair` runs in the
  dtype of the points, float64 included (its float64 tile is the one of
  :func:`gram_matmat_f64`); the tier pair contracts forward in float32 and
  the mirror tier-matched at k ≥ 3, as K2b does.
* :func:`gram_pair_comp` and :func:`gram_pair_f64`, the certified pairs (the
  float64 tile's pair form with float32 and float64 V): both products in
  float64 from the float64 plain Gram product (:func:`gram_pair` on the
  float64 points).
* :func:`gram_matmat_f64` (K8) and :func:`gram_matvec_symmetric_f64` (K7):
  row blocks of K in float64 from the float64 casts of the points, the one
  float64 plain product. The expansion ``‖x‖² + ‖y‖² − 2·x·y`` cancels to
  ~1e-16 at coincident points: RBF keeps that as it is and takes the matmul
  form, while the Matérn family's square root would lift it to ~1e-8 on
  the diagonal of a symmetric product, so Matérn (and Laplace, which has
  no matmul form) sums the distances directly (``torch.cdist`` without the
  matmul form), as the kernels do.

The dispatcher sends CPU tensors here (float64 points to the float64
product); ``chip_smoke.py`` runs them on the card only to check and time
the kernels.
"""

from typing import Optional

import torch

from ..kernels.functions import kernel_from_sqdist, kernel_tile, scale_inputs
from .kernel_tiers import (
    TierOperand,
    finish_dot,
    norms_and_operands,
    split_bf16,
    tier_products,
)


__all__ = [
    "gram_matmat",
    "gram_matmat_comp",
    "gram_matvec_symmetric",
    "gram_matmat_tier",
    "gram_matvec_symmetric_tier",
    "gram_matmat_f64",
    "gram_matvec_symmetric_f64",
    "gram_pair",
    "gram_pair_tier",
    "gram_pair_comp",
    "gram_pair_f64",
    "tier_contract",
    "tf32_split",
    "SYMMETRIC_TILE",
    "NARROW_MAX_K",
]

# Elements in one streamed tile, the JAX package's budget (kernel_xla.py).
_TILE_ELEMENTS = 1 << 23
# Rows of the CUDA triangle kernels' tiles (csrc/gram_common.cuh kTile).
SYMMETRIC_TILE = 64
# Widest right-hand side contracted in float32 by the tier kernels.
NARROW_MAX_K = 16


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


def tier_contract(K: torch.Tensor, V: torch.Tensor, mode: str) -> torch.Tensor:
    """``K @ V`` (float32) by one of the tier contractions: ``"f32"``,
    ``"split"`` (hi·hi + hi·lo + lo·hi of both operands' bf16 parts) or
    ``"fast"`` (one pass of bf16 values); the products of bf16 values are
    exact in float32."""
    if mode == "f32":
        return K @ V
    if mode == "fast":
        return K.to(torch.bfloat16).float() @ V.to(torch.bfloat16).float()
    kh, kl = split_bf16(K)
    vh, vl = split_bf16(V)
    return kh @ vh + kh @ vl + kl @ vh


def _tier_values(kind, A: TierOperand, B: TierOperand, rows=slice(None)):
    scale, hx, hy = norms_and_operands(kind, A, B)
    Ar = TierOperand(A.hi[rows], None if A.lo is None else A.lo[rows], A.sq[rows])
    return finish_dot(kind, scale * tier_products(Ar, B), hx[rows], hy)


def _wide_mode(A: TierOperand) -> str:
    return "split" if A.passes == 3 else "fast"


def gram_matmat_tier(
    kind: str,
    A: TierOperand,
    B: TierOperand,
    V: torch.Tensor,
    const_scaling=1.0,
    row_block: Optional[int] = None,
) -> torch.Tensor:
    """K1b: ``c·k(X1, X2) @ V`` on a bf16 tier, from the parts of X1 (A) and
    X2 (B), with float32 V."""
    V, squeeze = _as_2d(V)
    n, k = A.hi.shape[0], V.shape[1]
    mode = "f32" if k <= NARROW_MAX_K else _wide_mode(A)
    bm = _block(row_block, B.hi.shape[0])
    out = torch.empty((n, k), dtype=torch.float32, device=V.device)
    for s in range(0, n, bm):
        out[s : s + bm] = tier_contract(_tier_values(kind, A, B, slice(s, s + bm)), V, mode)
    out = out * const_scaling
    return out[:, 0] if squeeze else out


def gram_matvec_symmetric_tier(
    kind: str,
    A: TierOperand,
    V: torch.Tensor,
    const_scaling=1.0,
    tile: int = SYMMETRIC_TILE,
    row_block: Optional[int] = None,
) -> torch.Tensor:
    """K2b: ``c·k(X, X) @ V`` (k ≤ 16) on a bf16 tier with K2b's schedule
    at tile ``tile``: entry (i, j) of the Gram matrix is evaluated with row
    operand i where tile(i) ≤ tile(j); the forward contraction is float32,
    the mirror one float32 at k ≤ 2 and tier-matched at k ≥ 3."""
    V, squeeze = _as_2d(V)
    n, k = A.hi.shape[0], V.shape[1]
    mirror_mode = "f32" if k <= 2 else _wide_mode(A)
    bm = max(tile, _block(row_block, n) // tile * tile)
    tiles = torch.arange(n, device=V.device) // tile
    out = torch.zeros((n, k), dtype=torch.float32, device=V.device)
    for s in range(0, n, bm):
        Kb = _tier_values(kind, A, A, slice(s, s + bm))
        rt = tiles[s : s + bm, None]
        forward = torch.where(tiles[None, :] >= rt, Kb, 0.0)
        out[s : s + bm] += forward @ V
        upper = torch.where(tiles[None, :] > rt, Kb, 0.0)
        out += tier_contract(upper.T.contiguous(), V[s : s + bm], mirror_mode)
    out = out * const_scaling
    return out[:, 0] if squeeze else out


def _f64_tile(kind: str, Xs: torch.Tensor, Ys: torch.Tensor) -> torch.Tensor:
    """Float64 kernel tile of pre-scaled points: the matmul expansion for
    RBF, directly summed distances for Laplace and the Matérn family."""
    if kind == "rbf":
        return kernel_tile(kind, Xs, Ys)
    if kind == "laplace":
        return torch.exp(-torch.cdist(Xs, Ys, p=1))
    r = torch.cdist(Xs, Ys, p=2, compute_mode="donot_use_mm_for_euclid_dist")
    return kernel_from_sqdist(kind, r * r)


def gram_matmat_f64(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    row_block: Optional[int] = None,
) -> torch.Tensor:
    """K8: ``c·k(X1, X2) @ V`` in float64 from float32 (or float64) points
    and a float64 lengthscale; float64 out."""
    V, squeeze = _as_2d(V.double())
    ls = torch.as_tensor(lengthscale, dtype=torch.float64, device=X1.device)
    Xs = X1.double() / ls
    Ys = X2.double() / ls
    bm = _block(row_block, X2.shape[0])
    out = torch.empty((X1.shape[0], V.shape[1]), dtype=torch.float64, device=V.device)
    for s in range(0, X1.shape[0], bm):
        out[s : s + bm] = _f64_tile(kind, Xs[s : s + bm], Ys) @ V
    out = out * const_scaling
    return out[:, 0] if squeeze else out


def gram_matvec_symmetric_f64(
    kind: str,
    X: torch.Tensor,
    V: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    row_block: Optional[int] = None,
) -> torch.Tensor:
    """K7: ``c·k(X, X) @ V`` in float64; the plain version is K8 on (X, X)."""
    return gram_matmat_f64(kind, X, X, V, lengthscale, const_scaling, row_block)


def gram_pair(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V2: torch.Tensor,
    V1: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    row_block: Optional[int] = None,
):
    """K4 / K6: ``(c·K @ V2, c·Kᵀ @ V1)`` with ``K = k(X1, X2)``, each row
    block of K evaluated once for both products. Float64 points take the
    float64 tile of :func:`gram_matmat_f64` (distances summed directly for
    Matérn and Laplace)."""
    V2, squeeze = _as_2d(V2)
    V1, _ = _as_2d(V1)
    if X1.dtype == torch.float64:
        ls = torch.as_tensor(lengthscale, dtype=torch.float64, device=X1.device)
        Xs, Ys = X1 / ls, X2 / ls

        def tile(a, b):
            return _f64_tile(kind, a, b)
    else:
        Xs, Ys = scale_inputs(X1, lengthscale), scale_inputs(X2, lengthscale)

        def tile(a, b):
            return kernel_tile(kind, a, b)
    bm = _block(row_block, X2.shape[0])
    out1 = torch.empty((X1.shape[0], V2.shape[1]), dtype=V2.dtype, device=V2.device)
    out2 = torch.zeros((X2.shape[0], V1.shape[1]), dtype=V1.dtype, device=V1.device)
    for s in range(0, X1.shape[0], bm):
        Kb = tile(Xs[s : s + bm], Ys)
        out1[s : s + bm] = Kb @ V2
        out2 += Kb.T @ V1[s : s + bm]
    out1, out2 = out1 * const_scaling, out2 * const_scaling
    return (out1[:, 0], out2[:, 0]) if squeeze else (out1, out2)


def gram_pair_f64(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V2: torch.Tensor,
    V1: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    row_block: Optional[int] = None,
):
    """K8's pair form: ``(c·K @ V2, c·Kᵀ @ V1)`` in float64 with K = k(X1,
    X2), from the float64 points and lengthscale (:func:`gram_pair`'s
    float64 tile, each row block of K once for both products)."""
    return gram_pair(kind, X1.double(), X2.double(), V2.double(), V1.double(), lengthscale,
                     const_scaling, row_block)


def gram_pair_comp(
    kind: str,
    X1: torch.Tensor,
    X2: torch.Tensor,
    V2: torch.Tensor,
    V1: torch.Tensor,
    lengthscale,
    const_scaling=1.0,
    row_block: Optional[int] = None,
):
    """The compensated pair (K1c's and K3c's pair form, float32 V): the same
    float64 products as :func:`gram_pair_f64`."""
    return gram_pair_f64(kind, X1, X2, V2, V1, lengthscale, const_scaling, row_block)


def gram_pair_tier(
    kind: str,
    A: TierOperand,
    B: TierOperand,
    V2: torch.Tensor,
    V1: torch.Tensor,
    const_scaling=1.0,
    row_block: Optional[int] = None,
):
    """K4b: ``(c·K @ V2, c·Kᵀ @ V1)`` on a bf16 tier from the parts of X1 (A)
    and X2 (B) (k ≤ 16): the forward contraction in float32, the mirror one
    in float32 at k ≤ 2 and tier-matched at k ≥ 3."""
    V2, squeeze = _as_2d(V2)
    V1, _ = _as_2d(V1)
    k = V2.shape[1]
    mirror_mode = "f32" if k <= 2 else _wide_mode(A)
    bm = _block(row_block, B.hi.shape[0])
    n1 = A.hi.shape[0]
    out1 = torch.empty((n1, k), dtype=torch.float32, device=V2.device)
    out2 = torch.zeros((B.hi.shape[0], k), dtype=torch.float32, device=V2.device)
    for s in range(0, n1, bm):
        Kb = _tier_values(kind, A, B, slice(s, s + bm))
        out1[s : s + bm] = Kb @ V2
        out2 += tier_contract(Kb.T.contiguous(), V1[s : s + bm], mirror_mode)
    out1, out2 = out1 * const_scaling, out2 * const_scaling
    return (out1[:, 0], out2[:, 0]) if squeeze else (out1, out2)


def tf32_split(V: torch.Tensor):
    """``(hi, lo)`` float32 TF32 parts of float32 ``V``, as the card's K1
    splits its values and V past 16 columns: ``hi`` the nearest value with
    11 significant bits (``cvt.rna.tf32.f32``: ties away from zero), ``lo``
    the same rounding of ``V − hi`` (exact in float32). ``hi + lo`` is V to
    2⁻²² of its size, and ``|lo| ≤ 2⁻¹¹ |hi|``. Taken in float64 by
    rounding each value to a multiple of its quantum, half away from zero:
    2^(e − 11) for a value in [2^(e − 1), 2^e), 2⁻¹³⁶ below 2⁻¹²⁶ (TF32's
    subnormals keep 10 bits, as float32's keep 23); the wrapper's
    :func:`kernel_cuda.wide_rhs` does it on the bit patterns."""

    def rna(x):
        x64 = x.double()
        quantum = torch.clamp(torch.frexp(x64)[1] - 11, min=-136)
        big = torch.floor(torch.ldexp(x64.abs(), -quantum) + 0.5)
        return torch.copysign(torch.ldexp(big, quantum), x64).float()

    hi = rna(V)
    return hi, rna(V - hi)
