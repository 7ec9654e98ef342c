"""Randomized sketch embeddings: Gaussian / orthonormal / sparse-sign / SRHT."""

from .embeddings import (  # noqa: F401
    gauss_embedding,
    left_embedding,
    ortho_embedding,
    right_embedding,
    sketch_apply_left,
    sparse_sign_embedding,
    srht_apply,
    srht_matrix,
    srht_params,
)

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
