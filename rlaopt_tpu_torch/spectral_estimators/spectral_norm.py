"""Spectral-norm estimation via randomized power iteration.

Port of ``rlaopt_tpu/spectral_estimators/spectral_norm.py``: a normalized
Gaussian start, the estimate ``σ = vᵀ A v`` of each step, the stop once
``|σ_new − σ| ≤ rtol·σ`` or at ``max_iters``, and ``(σ, v)`` returned. The
JAX package stops a ``lax.while_loop`` early; here every one of the
``max_iters`` steps runs and a converged ``(v, σ)`` is frozen with
``torch.where``, which returns the same values without reading the test on
the host (SAP calls this every iteration, and a ``.item()`` per step would
wait on the device each time).
"""

from typing import Optional, Tuple

import torch

from ..utils.checkers import _as_generator
from ..utils.rng import device_generator


__all__ = ["randomized_powering"]


def randomized_powering(
    A,
    max_iters: int = 10,
    rtol: float = 1e-3,
    key=None,
    v0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimate λ_max of a symmetric(-izable) operator by power iteration.

    Args:
        A: symmetric LinOp or dense matrix (P⁻¹A with symmetric P and A is
            admissible: its spectrum is that of P^{-1/2} A P^{-1/2}).
        max_iters: iteration cap.
        rtol: relative convergence tolerance on the eigenvalue estimate.
        key: int seed, ``torch.Generator`` or None, for the start vector.
        v0: a start vector to use in place of a draw (normalized here), so
            that tests can hand both packages the same one.

    Returns:
        (sigma, v): the eigenvalue estimate (a 0-d tensor) and the final
        unit vector.
    """
    n, dtype, device = A.shape[0], A.dtype, A.device
    if v0 is None:
        gen = device_generator(_as_generator(key), device)
        v0 = torch.randn((n,), generator=gen, dtype=dtype, device=device)
    v = v0 / torch.linalg.norm(v0)
    sig = torch.zeros((), dtype=dtype, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    for i in range(max_iters):
        v_new = A @ v
        sig_new = torch.dot(v, v_new)
        # the first step always runs (the reference's err starts at inf);
        # NaN fails the test and stops, as in the while_loop
        err = torch.abs(sig_new - sig)
        v = torch.where(done, v, v_new / torch.linalg.norm(v_new))
        sig = torch.where(done, sig, sig_new)
        done = done | ~(err > rtol * sig_new)
    return sig, v
