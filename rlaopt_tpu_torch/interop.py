"""Carry state across from the JAX package.

Turns numpy arrays taken from ``rlaopt_tpu`` objects into this package's
objects, so that a solve begun there can continue here (and tests can hold
the two packages to the same iterates):

* :func:`kernel_operator` — a kernel operator from its payload
  ``(X, ls, scale, kind)``, built on one data set (``X1 is X2``);
* :func:`nystrom_preconditioner` — a built :class:`Nystrom` from
  ``NystromFactors(U, S)``, ``rho`` and the low-precision factor ``L``;
* :func:`pcg_state` — a :class:`PCGState` from ``(W, R, Z, P_, RZ, ok)``.

Nothing here imports ``jax``: callers convert with ``numpy.asarray``.
"""

from typing import Optional

import numpy as np
import torch

from .kernels.configs import KernelConfig
from .kernels.linop import KernelLinOp
from .preconditioners.configs import NystromConfig
from .preconditioners.nystrom import Nystrom
from .solvers.pcg import PCGState


__all__ = ["kernel_operator", "nystrom_preconditioner", "pcg_state"]


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def kernel_operator(
    X, ls, scale, kind: str, device="cpu", compute_dtype=None
) -> KernelLinOp:
    """``k(X, X)`` operator from the payload of a JAX ``KernelLinOp``
    (``op._data["X1"]``, ``["ls"]``, ``["scale"]``, ``op.kind`` and
    ``op.compute_dtype``)."""
    X_t = _t(X, device)
    ls_np = np.asarray(ls)
    lengthscale = float(ls_np) if ls_np.ndim == 0 else _t(ls_np, device, X_t.dtype)
    cfg = KernelConfig(lengthscale=lengthscale, const_scaling=float(np.asarray(scale)))
    return KernelLinOp(X_t, X_t, cfg, kind, compute_dtype=compute_dtype)


def nystrom_preconditioner(
    U,
    S,
    rho,
    L=None,
    config: Optional[NystromConfig] = None,
    device="cpu",
) -> Nystrom:
    """A built Nyström preconditioner from the JAX package's factors.

    ``L`` is the low-precision inverse factor (``Nystrom.L`` there); with
    None, float64 factors apply the inverse by the Woodbury form and
    float32 factors rebuild ``L`` on first use.
    """
    U_t = _t(U, device)
    rho_f = float(np.asarray(rho))
    P = Nystrom(config or NystromConfig(rank=U_t.shape[1], rho=rho_f))
    P.U, P.S = U_t, _t(S, device)
    P.rho = rho_f
    P.low_precision = U_t.dtype != torch.float64 or L is not None
    P.L = None if L is None else _t(L, device)
    return P


def pcg_state(W, R, Z, P_, RZ, ok, device="cpu") -> PCGState:
    """A :class:`PCGState` from the fields of the JAX package's PCGState."""
    return PCGState(
        W=_t(W, device),
        R=_t(R, device),
        Z=_t(Z, device),
        P_=_t(P_, device),
        RZ=_t(RZ, device),
        ok=_t(ok, device, torch.bool),
    )
