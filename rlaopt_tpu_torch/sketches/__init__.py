"""Randomized sketching: Gaussian / orthonormal / sparse-sign / SRHT."""

from .base import Sketch  # noqa: F401
from .gauss import Gauss  # noqa: F401
from .ortho import Ortho  # noqa: F401
from .sparse_sign import Sparse  # noqa: F401
from .srht import SRHT  # noqa: F401
from .factory import get_sketch  # noqa: F401
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
    "Sketch",
    "Gauss",
    "Ortho",
    "Sparse",
    "SRHT",
    "get_sketch",
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
