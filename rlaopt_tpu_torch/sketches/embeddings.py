"""Sketch embedding generators.

Port of ``rlaopt_tpu/sketches/embeddings.py``, drawing from a
``torch.Generator`` on the target device (see
:func:`rlaopt_tpu_torch.utils.rng.device_generator`):

* Gaussian   — ``randn(s, d)/sqrt(s)``
* Ortho      — reduced-QR Q of ``randn(d, s)``
* SparseSign — ζ=min(8,s) ±1 entries per column, scaled ζ^(-1/2), with the
               scatter's collision semantics (a repeated row overwrites)
* SRHT       — ``sqrt(p/s) · R · H̃ · D`` with p = next_pow2(d), applied by
               the butterfly FWHT of :mod:`rlaopt_tpu_torch.ops.fwht`

:func:`sketch_apply_left` computes Ω @ A without the (s, d) matrix where it
can: the fast transform for SRHT on a dense A, and Ωᵀ drawn directly in
(d, s) layout for an operator (``(Aᵀ Ωᵀ)ᵀ``), so Ω is never held twice.

The numbers differ from the JAX package's for the same seed; tests inject
the embedding. The three embeddings take the JAX package's parameters in
its order, ``key`` first: a ``torch.Generator`` or an int seed (the port's
stand-in for a JAX key); ``device``, the port's own, comes last. Every
function here draws on the CUDA card unless ``device`` names another (None,
the default, raises where there is no card).
"""

import torch

from .enums import _SketchMode
from ..ops.fwht import fwht, next_pow2
from ..utils.checkers import _as_device, _as_generator
from ..utils.linalg import hmm
from ..utils.rng import device_generator


__all__ = [
    "gauss_embedding",
    "ortho_embedding",
    "sparse_sign_embedding",
    "srht_params",
    "srht_apply",
    "srht_matrix",
    "left_embedding",
    "right_embedding",
    "sketch_apply_left",
]


def gauss_embedding(key, s: int, d: int, dtype=torch.float32, device=None):
    """Gaussian embedding (s, d), scaled so E[ΩᵀΩ] = I."""
    device = _as_device(device)
    g = device_generator(_as_generator(key), device)
    return torch.randn((s, d), generator=g, dtype=dtype, device=device) / s**0.5


def ortho_embedding(key, s: int, d: int, dtype=torch.float32, device=None):
    """Orthonormal embedding: reduced-QR Q factor of randn(d, s), shape (d, s).

    Columns are exactly orthonormal (requires s <= d).
    """
    device = _as_device(device)
    g = device_generator(_as_generator(key), device)
    G = torch.randn((d, s), generator=g, dtype=dtype, device=device)
    Q, _ = torch.linalg.qr(G, mode="reduced")
    return Q


def _sparse_sign_entries(gen, s: int, d: int, dtype, device):
    """The sparse-sign draws: (rows, cols, values) of the ζ·d entries,
    values already scaled by ζ^(-1/2) (±1·c is exact, so scaling before the
    scatter gives the bits of scaling after it, with one (s, d) matrix)."""
    zeta = 8 if s >= 8 else s
    g = device_generator(gen, device)
    z = 2.0 * torch.randint(0, 2, (zeta, d), generator=g, device=device).to(dtype) - 1.0
    rows = torch.randint(0, s, (zeta, d), generator=g, device=device)
    cols = torch.arange(d, device=device).expand(zeta, d)
    return rows, cols, z * zeta**-0.5


def sparse_sign_embedding(key, s: int, d: int, dtype=torch.float32, device=None):
    """Sparse-sign embedding (s, d): ζ=min(8,s) ±1 per column, scaled ζ^(-1/2)."""
    device = _as_device(device)
    rows, cols, vals = _sparse_sign_entries(_as_generator(key), s, d, dtype, device)
    Omega = torch.zeros((s, d), dtype=dtype, device=device)
    Omega[rows, cols] = vals
    return Omega


def srht_params(gen, s: int, d: int, dtype=torch.float32, device=None):
    """Draw SRHT randomness: (signs (p,), row_idx (s,)) with p = next_pow2(d)."""
    device = _as_device(device)
    p = next_pow2(d)
    g = device_generator(gen, device)
    signs = 2.0 * torch.randint(0, 2, (p,), generator=g, device=device).to(dtype) - 1.0
    rows = torch.randperm(p, generator=g, device=device)[:s]
    return signs, rows


def srht_apply(signs: torch.Tensor, rows: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Apply Θ = sqrt(p/s)·R·H̃·D·E to A along axis 0: (d, ...) → (s, ...).

    ``E`` zero-pads d → p = next_pow2(d); ``H̃ = H/sqrt(p)`` is the normalized
    Hadamard so that E[ΘᵀΘ] = I.
    """
    p = signs.shape[0]
    s = rows.shape[0]
    d = A.shape[0]
    vec = A.ndim == 1
    if vec:
        A = A[:, None]
    X = A * signs[:d, None]
    if p != d:
        X = torch.cat([X, X.new_zeros((p - d,) + tuple(X.shape[1:]))], dim=0)
    Y = fwht(X, axis=0) / torch.sqrt(torch.tensor(p, dtype=X.dtype))
    Y = Y[rows] * torch.sqrt(torch.tensor(p / s, dtype=X.dtype))
    return Y[:, 0] if vec else Y


def _parity(v: torch.Tensor) -> torch.Tensor:
    """Parity of the set bits of each non-negative int64."""
    for shift in (32, 16, 8, 4, 2, 1):
        v = v ^ (v >> shift)
    return v & 1


def srht_matrix(signs: torch.Tensor, rows: torch.Tensor, d: int) -> torch.Tensor:
    """Materialize the (s, d) SRHT matrix.

    Selected Hadamard rows are built directly via the bit identity
    ``H[r, c] = (-1)^popcount(r & c)`` (Sylvester order) — O(s·p) memory,
    never the p×p transform of an identity.
    """
    p = signs.shape[0]
    s = rows.shape[0]
    cols = torch.arange(p, dtype=torch.int64, device=signs.device)
    bits = _parity(rows.to(torch.int64)[:, None] & cols[None, :])
    H_sel = 1.0 - 2.0 * bits.to(signs.dtype)  # (s, p)
    scale = torch.sqrt(torch.tensor(p / s, dtype=signs.dtype)) / torch.sqrt(
        torch.tensor(p, dtype=signs.dtype)
    )
    Theta = H_sel * signs[None, :] * scale
    return Theta[:, :d]


def _left_embedding_t(name, gen, s: int, d: int, dtype, device=None):
    """Ωᵀ (d, s) contiguous, with the values of ``left_embedding(...).T`` for
    the same generator: drawn in that layout for the sparse-sign and
    orthonormal families (one (d, s) matrix), transposed for the others."""
    device = _as_device(device)
    mode = _SketchMode._from_str(name, "name")
    if mode == _SketchMode.SPARSE:
        rows, cols, vals = _sparse_sign_entries(gen, s, d, dtype, device)
        Omega_t = torch.zeros((d, s), dtype=dtype, device=device)
        Omega_t[cols, rows] = vals
        return Omega_t
    if mode == _SketchMode.ORTHO:
        return ortho_embedding(gen, s, d, dtype, device).contiguous()
    return left_embedding(name, gen, s, d, dtype, device).T.contiguous()


def sketch_apply_left(name, gen, s: int, A, dtype) -> torch.Tensor:
    """Compute Ω @ A (s, n) for the named left-mode sketch, structure-
    exploiting. ``A`` is a dense (d, n) tensor or a LinOp of d rows.

    SRHT on a dense A takes the fast transform (the (s, d) matrix is never
    made); a two-sided operator gets ``(Aᵀ Ωᵀ)ᵀ`` with Ωᵀ drawn in (d, s)
    layout; a dense A otherwise ``Ω @ A``.
    """
    from ..linops.base import LinOp

    mode = _SketchMode._from_str(name, "name")
    d = A.shape[0]
    device = A.device
    if isinstance(A, LinOp):
        if not A._is_two_sided:
            raise TypeError(
                "x @ A requires a two-sided operator (TwoSidedLinOp/SymmetricLinOp)"
            )
        return A.rmatmat(_left_embedding_t(name, gen, s, d, dtype, device)).T
    if mode == _SketchMode.SRHT:
        signs, rows = srht_params(gen, s, d, dtype, device)
        return srht_apply(signs, rows, A)
    return hmm(left_embedding(name, gen, s, d, dtype, device), A)


def left_embedding(name, gen, s: int, d: int, dtype, device=None):
    """Materialized left-mode (s, d) embedding for the named sketch family."""
    device = _as_device(device)
    mode = _SketchMode._from_str(name, "name")
    if mode == _SketchMode.GAUSS:
        return gauss_embedding(gen, s, d, dtype, device)
    if mode == _SketchMode.ORTHO:
        return ortho_embedding(gen, s, d, dtype, device).T
    if mode == _SketchMode.SPARSE:
        return sparse_sign_embedding(gen, s, d, dtype, device)
    signs, rows = srht_params(gen, s, d, dtype, device)
    return srht_matrix(signs, rows, d)


def right_embedding(name, gen, s: int, d: int, dtype, device=None):
    """Materialized right-mode (d, s) embedding for the named sketch family."""
    device = _as_device(device)
    mode = _SketchMode._from_str(name, "name")
    if mode == _SketchMode.ORTHO:
        return ortho_embedding(gen, s, d, dtype, device)
    return left_embedding(name, gen, s, d, dtype, device).T
