"""Lanczos tridiagonalization for extremal-eigenvalue estimation.

Port of ``rlaopt_tpu/spectral_estimators/lanczos.py``: a fixed number of
steps from a normalized Gaussian start (a Python loop in place of
``lax.scan``), no reorthogonalization, the ``β > 0`` guard of the division.
"""

from typing import Optional, Tuple

import torch

from ..utils.checkers import _as_generator
from ..utils.rng import device_generator


__all__ = ["lanczos", "lanczos_eigsh"]


def lanczos(
    A,
    num_iters: int,
    key=None,
    q0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``num_iters`` Lanczos steps on a symmetric operator or matrix.

    Args:
        A: symmetric LinOp or dense (n, n) tensor.
        num_iters: number of steps m.
        key: int seed, ``torch.Generator`` or None, for the start vector.
        q0: a start vector to use in place of a draw (normalized here), so
            that tests can hand both packages the same one.

    Returns:
        (alphas (m,), betas (m-1,)): diagonal and off-diagonal of the
        tridiagonal T, whose eigenvalues approximate A's extremal ones.
    """
    n = A.shape[0]
    dtype, device = A.dtype, A.device
    if q0 is None:
        gen = device_generator(_as_generator(key), device)
        q0 = torch.randn((n,), generator=gen, dtype=dtype, device=device)
    q = q0.to(device, dtype) / torch.linalg.norm(q0)
    q_prev = torch.zeros_like(q)
    beta = torch.zeros((), dtype=dtype, device=device)
    alphas, betas = [], []
    for _ in range(num_iters):
        w = A @ q - beta * q_prev
        alpha = torch.dot(q, w)
        w = w - alpha * q
        beta = torch.linalg.norm(w)
        q_prev, q = q, w / torch.where(beta > 0, beta, torch.ones_like(beta))
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)[:-1]


def lanczos_eigsh(
    A,
    num_iters: int = 20,
    key=None,
    q0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Eigenvalues of the Lanczos tridiagonal (sorted ascending)."""
    alphas, betas = lanczos(A, num_iters, key, q0)
    T = torch.diag(alphas) + torch.diag(betas, 1) + torch.diag(betas, -1)
    return torch.linalg.eigvalsh(T)
