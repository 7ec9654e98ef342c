"""Gram kernels: hand-written CUDA (``kernel_cuda``), their plain PyTorch
versions (``kernel_plain``), the bf16 tiers' operands (``kernel_tiers``), the
float64 route (``kernel_value64``) and the device-based routing between them
(``kernel_dispatch``); and the Walsh–Hadamard transform (``fwht``), whose
names the package exports as the JAX package's ``ops`` does."""

from .fwht import fwht, fwht_butterfly, hadamard_matrix, next_pow2  # noqa: F401

__all__ = ["fwht", "fwht_butterfly", "hadamard_matrix", "next_pow2"]
