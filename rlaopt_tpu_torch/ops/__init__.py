"""Gram kernels: hand-written CUDA (``kernel_cuda``), their plain PyTorch
versions (``kernel_plain``) and the device-based routing between them
(``kernel_dispatch``)."""
