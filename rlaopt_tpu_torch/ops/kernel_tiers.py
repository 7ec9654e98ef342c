"""The bf16 accuracy tiers of the Gram products: spelling, operands, epilogue.

Counterparts of ``rlaopt_tpu/ops/kernel_pallas.py``'s
``normalize_compute_dtype`` (line 80), ``_norms_and_operands`` (672),
``_split_bf16`` (687) and ``_finish_dot`` (192). A tier computes the cross
term ``x·y`` of the squared distance from bf16 parts of the pre-scaled points
(``"bf16x3"``: ``hi·hi + hi·lo + lo·hi``; ``"bfloat16"``: ``hi·hi``), each
product exact in float32, and finishes the kernel value in float32 from the
norm vectors:

* RBF: ``exp(cross − hx − hy)`` with ``hx = ‖x‖²/2``;
* Matérn: ``finish(max(hx + hy − 2·cross, 0))`` with ``hx = ‖x‖²``, the
  JAX package's X operand scaled by 2 (an exact power of two, so the split
  of ``2x`` is twice the split of ``x`` and the port scales the cross term
  instead of the operand).

The split is taken once per operator (:func:`tier_operand`) and padded in
depth to a multiple of 16 with zeros, the tensor cores' depth; the same parts
feed the plain versions and the CUDA kernels.
"""

from dataclasses import dataclass
from typing import Optional

import torch

from ..kernels.functions import kernel_from_sqdist


__all__ = [
    "TIERS",
    "TierOperand",
    "normalize_compute_dtype",
    "split_bf16",
    "split_rhs",
    "split_rhs_t",
    "rhs_t",
    "forward_contraction",
    "tier_operand",
    "norms_and_operands",
    "finish_dot",
    "tier_products",
]

TIERS = ("bf16x3", "bfloat16")
# Depth multiple of the parts: the k-extent of one bf16 tensor-core product.
DEPTH_MULTIPLE = 16
# K1b's contraction below 17 columns is the JAX package's dispatch
# (kernel_matmat_pallas): the tier-matched "split" on bf16x3 at 9 to 16
# columns where its three passes fold into one operand of depth 256 or less
# (d <= 85), the float32 one elsewhere. The padded depth stands for d:
# SPLIT_MAX_DEPTH = 80 (at d = 81 to 85 the port keeps float32, the more
# precise engine).
SPLIT_MIN_K, SPLIT_MAX_K, SPLIT_MAX_DEPTH = 9, 16, 80


def forward_contraction(k: int, dp: int, passes: int) -> str:
    """The contraction of K1b's ``c·k(X1, X2) @ V`` for k columns at the
    padded depth dp on the tier of ``passes`` (3 or 1), on the card and in
    the plain version alike: ``"f32"`` (float32), ``"split"`` (hi·hi + hi·lo
    + lo·hi of the values' and V's bf16 parts) or ``"fast"`` (one bf16
    pass), the JAX package's choice (``SPLIT_MAX_DEPTH``): past 16 columns
    tier-matched, on bf16x3 at 9 to 16 columns and a depth up to 80
    ``"split"``, else float32."""
    if k > SPLIT_MAX_K:
        return "split" if passes == 3 else "fast"
    if passes == 3 and k >= SPLIT_MIN_K and dp <= SPLIT_MAX_DEPTH:
        return "split"
    return "f32"


def normalize_compute_dtype(cd):
    """Canonical tier spelling: None (exact f32), "bf16x3" or "bfloat16".

    Accepts "bf16", "bfloat16" and ``torch.bfloat16`` for the one-pass tier;
    anything else raises ValueError, as the JAX package's helper does.
    """
    if cd is None or cd == "bf16x3":
        return cd
    if cd in ("bf16", "bfloat16") or cd is torch.bfloat16:
        return "bfloat16"
    raise ValueError(f"unsupported compute_dtype {cd!r}")


def split_bf16(A: torch.Tensor):
    """``A = hi + lo`` with both parts bf16 values (round to nearest even),
    returned as float32 tensors; exact to ~2⁻¹⁸ relative."""
    hi = A.to(torch.bfloat16).float()
    lo = (A - hi).to(torch.bfloat16).float()
    return hi, lo


def split_rhs(V: torch.Tensor, passes: int):
    """The right-hand side of K1b past 16 columns: ``(vh, vl)``, V's bf16
    parts (``vl`` None on the one-pass tier), each (m, kp) with kp the
    column count rounded up to a multiple of 16, zero past it, so that
    every row starts 16-byte aligned. Bit for bit the parts
    :func:`split_bf16` gives (round to nearest even), taken once per call
    instead of once per tile and row block."""
    if V.ndim != 2 or V.dtype != torch.float32:
        raise ValueError(f"split_rhs takes a 2-D float32 V, got {V.dtype} {tuple(V.shape)}")
    pad = -V.shape[1] % DEPTH_MULTIPLE
    Vp = torch.nn.functional.pad(V, (0, pad)) if pad else V
    vh = Vp.to(torch.bfloat16).contiguous()
    if passes == 1:
        return vh, None
    return vh, (Vp - vh.float()).to(torch.bfloat16).contiguous()


def split_rhs_t(V: torch.Tensor):
    """The right-hand side of K1b's warp-specialised kernel for its split
    contraction (bf16x3, k ≤ 16): ``(vh, vl)``, V's bf16 parts transposed,
    each (16, mpad) with mpad the row count rounded up to a multiple of 8,
    zero past V's columns and rows, so that each row of the parts is a whole
    number of 16-byte pieces (the kernel reads them by TMA). Bit for bit the
    parts :func:`split_bf16` gives, as :func:`split_rhs`."""
    if V.ndim != 2 or V.dtype != torch.float32 or V.shape[1] > DEPTH_MULTIPLE:
        raise ValueError(f"split_rhs_t takes a 2-D float32 V of at most {DEPTH_MULTIPLE} "
                         f"columns, got {V.dtype} {tuple(V.shape)}")
    vh = V.to(torch.bfloat16)
    return _transposed(vh), _transposed((V - vh.float()).to(torch.bfloat16))


def rhs_t(V: torch.Tensor):
    """The right-hand side of K1b's warp-specialised kernel for its float32
    contraction: V transposed, (16, mpad) float32, zero past V's columns
    and rows (mpad as :func:`split_rhs_t`'s)."""
    if V.ndim != 2 or V.dtype != torch.float32 or V.shape[1] > DEPTH_MULTIPLE:
        raise ValueError(f"rhs_t takes a 2-D float32 V of at most {DEPTH_MULTIPLE} "
                         f"columns, got {V.dtype} {tuple(V.shape)}")
    return _transposed(V)


def _transposed(V: torch.Tensor):
    m, k = V.shape
    t = torch.zeros((DEPTH_MULTIPLE, -(-m // 8) * 8), dtype=V.dtype, device=V.device)
    t[:k, :m] = V.T
    return t


@dataclass(frozen=True)
class TierOperand:
    """One data set's tier parts.

    hi, lo: (n, dp) bf16 parts of the pre-scaled points, dp the depth
        rounded up to a multiple of 16 with zero columns (lo is None on the
        one-pass tier).
    sq: (n,) float32 ``‖x‖²`` of the pre-scaled points.
    """

    hi: torch.Tensor
    lo: Optional[torch.Tensor]
    sq: torch.Tensor

    @property
    def passes(self) -> int:
        return 1 if self.lo is None else 3

    def rows(self, idx: torch.Tensor) -> "TierOperand":
        """The parts of the points ``idx``: the split is taken point by point,
        so these are the parts a split of those points would give."""
        lo = None if self.lo is None else self.lo[idx]
        return TierOperand(self.hi[idx], lo, self.sq[idx])


def tier_operand(Xs: torch.Tensor, compute_dtype) -> TierOperand:
    """The parts of float32 points ``Xs`` (already divided by the
    lengthscale) for ``compute_dtype`` ("bf16x3" or "bfloat16")."""
    cd = normalize_compute_dtype(compute_dtype)
    if cd is None:
        raise ValueError("the exact tier has no bf16 parts")
    if Xs.dtype != torch.float32:
        raise ValueError(f"tier operands are made from float32 points, got {Xs.dtype}")
    n, d = Xs.shape
    pad = -d % DEPTH_MULTIPLE
    Xp = torch.nn.functional.pad(Xs, (0, pad)) if pad else Xs
    sq = torch.sum(Xs * Xs, dim=1)
    if cd == "bfloat16":
        return TierOperand(Xp.to(torch.bfloat16).contiguous(), None, sq)
    hi, lo = split_bf16(Xp)
    return TierOperand(
        hi.to(torch.bfloat16).contiguous(), lo.to(torch.bfloat16).contiguous(), sq
    )


def norms_and_operands(kind: str, A: TierOperand, B: TierOperand):
    """``(cross_scale, hx, hy)`` of ``_norms_and_operands``: RBF (1, ‖x‖²/2,
    ‖y‖²/2); Matérn (2, ‖x‖², ‖y‖²), where 2 scales the X operand."""
    if kind == "rbf":
        return 1.0, 0.5 * A.sq, 0.5 * B.sq
    return 2.0, A.sq, B.sq


def tier_products(A: TierOperand, B: TierOperand) -> torch.Tensor:
    """The tier's cross term ``x·y`` (n, m) in float32: the products of bf16
    values are exact in float32, and only their sums round."""
    ah, bh = A.hi.float(), B.hi.float()
    cross = ah @ bh.T
    if A.lo is not None:
        cross = cross + ah @ B.lo.float().T + A.lo.float() @ bh.T
    return cross


def finish_dot(kind: str, cross, hx, hy):
    """Kernel values from the cross term (already times ``cross_scale``) and
    the norm vectors (``_finish_dot``): RBF exponentiates
    ``cross − hx − hy`` as it stands, Matérn takes the clamped squared
    distance."""
    if kind == "rbf":
        return torch.exp(cross - hx[:, None] - hy[None, :])
    return kernel_from_sqdist(kind, torch.clamp(hx[:, None] + hy[None, :] - cross, min=0.0))
