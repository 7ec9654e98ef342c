"""Hutchinson-type trace estimators.

Port of ``rlaopt_tpu/spectral_estimators/trace.py``, with its two fixes of
the reference kept: the probes take A's dtype, and the variance returned is
the sample variance of the k single-probe estimators ``eᵢ = k·dᵢ`` (the
reference's formula telescopes to zero). ``hutch_plus_plus`` is Hutch++
(low-rank deflation plus Hutchinson on the residual).
"""

from typing import Optional, Tuple

import torch

from ..linops.base import LinOp
from ..sketches.embeddings import left_embedding
from ..utils.checkers import _as_generator
from ..utils.rng import device_generator


__all__ = ["hutchinson", "hutch_plus_plus"]


def _lmul(M, A):
    """``M @ A`` with A possibly a LinOp."""
    if isinstance(A, LinOp):
        return A.__rmatmul__(M)
    return M @ A


def hutchinson(
    A,
    k: int,
    sketch: str = "gauss",
    key=None,
    Omega: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimate tr(A) for symmetric A with k random probes.

    Use "gauss" or "sparse" sketches (isotropic in expectation); "ortho"
    probes are not scaled for trace estimation. ``Omega`` (k, n) takes the
    place of the drawn probes, so that tests can hand both packages the same
    ones.

    Returns:
        (trace_estimate, sample_variance) — the variance of the k
        single-probe estimators around the mean.
    """
    n = A.shape[0]
    if Omega is None:
        Omega = left_embedding(sketch, _as_generator(key), k, n, A.dtype, A.device)
    OA = _lmul(Omega, A)  # (k, n)
    d = torch.sum(OA * Omega, dim=1)  # diag(Ω A Ωᵀ)
    trace = torch.sum(d)
    e = k * d  # per-probe estimators
    var = torch.sum((e - trace) ** 2) / (k - 1)
    return trace, var


def hutch_plus_plus(
    A,
    k: int,
    sketch: str = "gauss",
    key=None,
    S: Optional[torch.Tensor] = None,
    G: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Hutch++ trace estimator (Meyer et al. 2021).

    Splits the k matvecs as k/3 range-finding, k/3 deflated trace (exact on
    the captured subspace), k/3 Hutchinson on the residual. ``S`` and ``G``
    (n, max(k // 3, 1)) take the place of the two Gaussian draws.
    """
    n = A.shape[0]
    m = max(k // 3, 1)
    if S is None or G is None:
        gen = device_generator(_as_generator(key), A.device)
        S = torch.randn((n, m), generator=gen, dtype=A.dtype, device=A.device)
        G = torch.randn((n, m), generator=gen, dtype=A.dtype, device=A.device)
    # Range finder
    Q, _ = torch.linalg.qr(A @ S, mode="reduced")
    # Exact trace on the captured subspace
    t_defl = torch.trace(Q.T @ A @ Q)
    # Hutchinson on the residual (I − QQᵀ)A(I − QQᵀ)
    G = G - Q @ (Q.T @ G)
    t_resid = torch.trace(G.T @ A @ G) / m
    return t_defl + t_resid
