"""Fast Walsh–Hadamard transform: the butterfly ladder.

Port of the butterfly half of ``rlaopt_tpu/ops/fwht.py``. The JAX package's
``fwht`` takes a Kronecker-factor form (two dense contractions with small
Hadamard matrices) to run on the TPU's matrix unit; that is a TPU trade-off
and is not carried over. Here ``fwht`` runs :func:`fwht_butterfly`, the
classical ``log2(p)`` reshape/add ladder in plain tensor ops, in Sylvester
order: it matches ``hadamard_matrix(p) @ x`` exactly on integers.
"""

import functools

import numpy as np
import torch


__all__ = ["fwht", "fwht_butterfly", "hadamard_matrix", "next_pow2"]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p *= 2
    return p


@functools.lru_cache(maxsize=None)
def _hadamard_np(p: int) -> np.ndarray:
    if p & (p - 1):
        raise ValueError(f"Hadamard size must be a power of 2, got {p}")
    H = np.array([[1.0]])
    while H.shape[0] < p:
        H = np.block([[H, H], [H, -H]])
    return H


def hadamard_matrix(p: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Unnormalized Hadamard matrix of size p (power of 2), Sylvester order."""
    return torch.as_tensor(_hadamard_np(p), dtype=dtype, device=device)


def fwht_butterfly(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Unnormalized WHT along ``axis`` (length a power of 2) via the
    classical butterfly ladder: ``log2(p)`` stages, each one pass over x."""
    x = torch.movedim(x, axis, 0)
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"FWHT length must be a power of 2, got {n}")
    rest = x.shape[1:]
    h = 1
    while h < n:
        x = x.reshape(n // (2 * h), 2, h, *rest)
        a, b = x[:, 0], x[:, 1]
        x = torch.stack([a + b, a - b], dim=1).reshape(n, *rest)
        h *= 2
    return torch.movedim(x, 0, axis)


def fwht(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Unnormalized Walsh–Hadamard transform along ``axis`` (length a power
    of 2): :func:`fwht_butterfly`."""
    return fwht_butterfly(x, axis)
