"""Standard kernel operator classes (port of ``rlaopt_tpu/kernels/standard.py``)."""

from .factory import _create_kernel_class


__all__ = [
    "RBFLinOp",
    "LaplaceLinOp",
    "Matern12LinOp",
    "Matern32LinOp",
    "Matern52LinOp",
]


RBFLinOp = _create_kernel_class("RBF", "rbf")
LaplaceLinOp = _create_kernel_class("Laplace", "laplace")
Matern12LinOp = _create_kernel_class("Matern12", "matern12")
Matern32LinOp = _create_kernel_class("Matern32", "matern32")
Matern52LinOp = _create_kernel_class("Matern52", "matern52")
