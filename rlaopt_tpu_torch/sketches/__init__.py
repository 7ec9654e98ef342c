"""Randomized sketch embeddings: Gaussian / orthonormal / sparse-sign."""

from .embeddings import (  # noqa: F401
    gauss_embedding,
    left_embedding,
    ortho_embedding,
    right_embedding,
    sparse_sign_embedding,
)

__all__ = [
    "gauss_embedding",
    "ortho_embedding",
    "sparse_sign_embedding",
    "left_embedding",
    "right_embedding",
]
