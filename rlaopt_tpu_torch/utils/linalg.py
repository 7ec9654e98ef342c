"""Small linear-algebra helpers shared by preconditioners and solvers.

Port of ``rlaopt_tpu/utils/linalg.py``. A float32 ``torch.matmul`` on a CUDA
card runs in full float32 as long as ``torch.backends.cuda.matmul.allow_tf32``
stays False (PyTorch's default); the port never turns it on.
"""

import torch


__all__ = [
    "hmm",
    "as_matmat",
    "densify",
    "cholesky_or_nan",
    "solve_tri_lower",
    "solve_tri_upper",
]


def hmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision matmul (the JAX package's ``Precision.HIGHEST``)."""
    return torch.matmul(a, b)


def as_matmat(A):
    """Return a matmat callable for a dense matrix or LinOp."""
    from ..linops.base import LinOp

    if isinstance(A, LinOp):
        return lambda X: A @ X
    return lambda X: hmm(A, X)


def densify(A, dtype=None) -> torch.Tensor:
    """A dense matrix or LinOp as a dense tensor (``A @ I`` for a LinOp)."""
    from ..linops.base import LinOp

    if isinstance(A, LinOp):
        return A @ torch.eye(A.shape[1], dtype=dtype or A.dtype, device=A.device)
    return A


def cholesky_or_nan(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of M, all NaN where the factorization fails.

    ``jnp.linalg.cholesky`` returns NaN on a matrix that is not positive
    definite, and SAP relies on that to skip a degenerate block;
    ``torch.linalg.cholesky`` raises instead. ``cholesky_ex`` reports the
    failure in a tensor, so the test stays on the device.
    """
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def solve_tri_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b with L lower-triangular."""
    return torch.linalg.solve_triangular(L, b, upper=False)


def solve_tri_upper(U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve U x = b with U upper-triangular."""
    return torch.linalg.solve_triangular(U, b, upper=True)
