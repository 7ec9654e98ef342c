"""Carry state across from the JAX package.

Turns numpy arrays taken from ``rlaopt_tpu`` objects into this package's
objects, so that a solve begun there can continue here (and tests can hold
the two packages to the same iterates):

* :func:`kernel_operator` — a kernel operator from its payload
  ``(X, ls, scale, kind)``, built on one data set (``X1 is X2``);
* :func:`nystrom_preconditioner` — a built :class:`Nystrom` from
  ``NystromFactors(U, S)``, ``rho`` and the low-precision factor ``L``;
* :func:`pcg_state` — a :class:`PCGState` from ``(W, R, Z, P_, RZ, ok)``;
* :func:`newton_preconditioner` — a built :class:`Newton` from its factor
  ``L`` and ``rho``;
* :func:`sap_state` — a :class:`SAPState` from ``(W, V, Y, t)`` (the JAX
  state's key has no counterpart: the port's solver draws from its own
  generator);
* :func:`sparse_tensor` — a sparse CSR/CSC tensor from its numpy buffers
  ``(values, indices, indptr)``, shape and layout;
* :func:`skpre_preconditioner` — a built :class:`SkPre` from its factor
  ``L``;
* :func:`lsqr_state` — an :class:`LSQRState` from ``(Y, U, V, W, alpha,
  phibar, rhobar)``.

Nothing here imports ``jax``: callers convert with ``numpy.asarray``.
"""

from typing import Optional

import numpy as np
import torch

from .kernels.configs import KernelConfig
from .kernels.linop import KernelLinOp
from .preconditioners.configs import NewtonConfig, NystromConfig, SkPreConfig
from .preconditioners.newton import Newton
from .preconditioners.nystrom import Nystrom
from .preconditioners.skpre import SkPre
from .solvers.lsqr import LSQRState
from .solvers.pcg import PCGState
from .solvers.sap import SAPState
from .sparse.sparse_tensor import _Layout, _SparseTensor


__all__ = [
    "kernel_operator",
    "nystrom_preconditioner",
    "newton_preconditioner",
    "pcg_state",
    "sap_state",
    "sparse_tensor",
    "skpre_preconditioner",
    "lsqr_state",
]


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


def newton_preconditioner(L, rho, device="cpu") -> Newton:
    """A built Newton preconditioner from the JAX package's ``Newton.L``."""
    P = Newton(NewtonConfig(rho=float(np.asarray(rho))))
    P.L = _t(L, device)
    return P


def sap_state(W, V, Y, t, device="cpu") -> SAPState:
    """A :class:`SAPState` from the fields of the JAX package's SAPState
    (its iteration counter ``t`` included; its key is not carried)."""
    return SAPState(
        W=_t(W, device), V=_t(V, device), Y=_t(Y, device), t=int(np.asarray(t))
    )


def sparse_tensor(values, indices, indptr, shape, layout="csr", device="cpu") -> _SparseTensor:
    """A sparse tensor from the buffers of the JAX package's ``_SparseTensor``
    (``.values``, ``.indices``, ``.indptr``, ``.shape``; ``layout`` "csr" or
    "csc", the lower-case name of its ``.layout``)."""
    return _SparseTensor(
        np.asarray(values), np.asarray(indices), np.asarray(indptr), shape,
        _Layout[layout.upper()], device,
    )


def skpre_preconditioner(L, config: Optional[SkPreConfig] = None, device="cpu") -> SkPre:
    """A built SkPre from the JAX package's factor ``SkPre.L``."""
    L_t = _t(L, device)
    P = SkPre(config or SkPreConfig(sketch_size=L_t.shape[0], rho=0.0))
    P.L = L_t
    return P


def lsqr_state(Y, U, V, W, alpha, phibar, rhobar, device="cpu") -> LSQRState:
    """An :class:`LSQRState` from the fields of the JAX package's LSQRState."""
    return LSQRState(*(_t(a, device) for a in (Y, U, V, W, alpha, phibar, rhobar)))
