"""Sparse CSR/CSC tensors and operators: the hand-written CSR kernel on a
card, the plain segment-sum versions on the CPU."""

from .sparse_tensor import SparseCSRTensor, _SparseTensor, _Layout  # noqa: F401
from .ops import (  # noqa: F401
    csc_matmat,
    csc_matvec,
    csr_matmat,
    csr_matvec,
    csr_transpose,
    gather_rows,
    native_available,
)
from .linop import sparse_aslinop, sparse_shard_rows  # noqa: F401

__all__ = [
    "SparseCSRTensor",
    "sparse_aslinop",
    "sparse_shard_rows",
    "csr_matvec",
    "csr_matmat",
    "csc_matvec",
    "csc_matmat",
    "csr_transpose",
    "gather_rows",
    "native_available",
]
