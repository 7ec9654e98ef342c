"""Gram kernels: hand-written CUDA (``kernel_cuda``), their plain PyTorch
versions (``kernel_plain``), the bf16 tiers' operands (``kernel_tiers``), the
float64 route (``kernel_value64``) and the device-based routing between them
(``kernel_dispatch``)."""
