"""Small linear-algebra helpers shared by preconditioners and solvers.

Port of ``rlaopt_tpu/utils/linalg.py``. A float32 ``torch.matmul`` on a CUDA
card runs in full float32 as long as ``torch.backends.cuda.matmul.allow_tf32``
stays False (PyTorch's default); the port never turns it on.
"""

import torch


__all__ = ["hmm", "as_matmat", "solve_tri_lower", "solve_tri_upper"]


def hmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision matmul (the JAX package's ``Precision.HIGHEST``)."""
    return torch.matmul(a, b)


def as_matmat(A):
    """Return a matmat callable for a dense matrix or LinOp."""
    from ..linops.base import LinOp

    if isinstance(A, LinOp):
        return lambda X: A @ X
    return lambda X: hmm(A, X)


def solve_tri_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b with L lower-triangular."""
    return torch.linalg.solve_triangular(L, b, upper=False)


def solve_tri_upper(U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve U x = b with U upper-triangular."""
    return torch.linalg.solve_triangular(U, b, upper=True)
