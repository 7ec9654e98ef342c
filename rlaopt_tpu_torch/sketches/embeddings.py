"""Sketch embedding generators.

Port of ``rlaopt_tpu/sketches/embeddings.py``, drawing from a
``torch.Generator`` on the target device (see
:func:`rlaopt_tpu_torch.utils.rng.device_generator`):

* Gaussian   — ``randn(s, d)/sqrt(s)``
* Ortho      — reduced-QR Q of ``randn(d, s)``
* SparseSign — ζ=min(8,s) ±1 entries per column, scaled ζ^(-1/2), with the
               scatter's collision semantics (a repeated row overwrites)
* SRHT       — not ported yet: it needs ``ops/fwht.py``.

The numbers differ from the JAX package's for the same seed; tests inject
the embedding.
"""

import torch

from .enums import _SketchMode
from ..utils.rng import device_generator


__all__ = [
    "gauss_embedding",
    "ortho_embedding",
    "sparse_sign_embedding",
    "left_embedding",
    "right_embedding",
]


def gauss_embedding(gen, s: int, d: int, dtype=torch.float32, device="cpu"):
    """Gaussian embedding (s, d), scaled so E[ΩᵀΩ] = I."""
    g = device_generator(gen, device)
    return torch.randn((s, d), generator=g, dtype=dtype, device=device) / s**0.5


def ortho_embedding(gen, s: int, d: int, dtype=torch.float32, device="cpu"):
    """Orthonormal embedding: reduced-QR Q factor of randn(d, s), shape (d, s).

    Columns are exactly orthonormal (requires s <= d).
    """
    g = device_generator(gen, device)
    G = torch.randn((d, s), generator=g, dtype=dtype, device=device)
    Q, _ = torch.linalg.qr(G, mode="reduced")
    return Q


def sparse_sign_embedding(gen, s: int, d: int, dtype=torch.float32, device="cpu"):
    """Sparse-sign embedding (s, d): ζ=min(8,s) ±1 per column, scaled ζ^(-1/2)."""
    zeta = 8 if s >= 8 else s
    g = device_generator(gen, device)
    z = 2.0 * torch.randint(0, 2, (zeta, d), generator=g, device=device).to(dtype) - 1.0
    rows = torch.randint(0, s, (zeta, d), generator=g, device=device)
    cols = torch.arange(d, device=device).expand(zeta, d)
    Omega = torch.zeros((s, d), dtype=dtype, device=device)
    Omega[rows, cols] = z
    return Omega * zeta**-0.5


def _srht_missing():
    raise NotImplementedError(
        "the SRHT sketch is not ported yet: it needs ops/fwht.py"
    )


def left_embedding(name, gen, s: int, d: int, dtype, device="cpu"):
    """Materialized left-mode (s, d) embedding for the named sketch family."""
    mode = _SketchMode._from_str(name, "name")
    if mode == _SketchMode.GAUSS:
        return gauss_embedding(gen, s, d, dtype, device)
    if mode == _SketchMode.ORTHO:
        return ortho_embedding(gen, s, d, dtype, device).T
    if mode == _SketchMode.SPARSE:
        return sparse_sign_embedding(gen, s, d, dtype, device)
    _srht_missing()


def right_embedding(name, gen, s: int, d: int, dtype, device="cpu"):
    """Materialized right-mode (d, s) embedding for the named sketch family."""
    mode = _SketchMode._from_str(name, "name")
    if mode == _SketchMode.ORTHO:
        return ortho_embedding(gen, s, d, dtype, device)
    return left_embedding(name, gen, s, d, dtype, device).T
