"""Carry state across from the JAX package.

Turns numpy arrays taken from ``rlaopt_tpu`` objects into this package's
objects, so that a solve begun there can continue here (and tests can hold
the two packages to the same iterates):

* :func:`kernel_operator` — a kernel operator from its payload
  ``(X, ls, scale, kind)``, built on one data set (``X1 is X2``);
* :func:`sharded_kernel_operator` — a sharded kernel operator from the
  payload of a JAX ``ShardedKernelLinOp`` (points, lengthscale, scale,
  ``memory_mode`` and the mesh size) on a mesh of that many positions;
* :func:`nystrom_preconditioner` — a built :class:`Nystrom` from
  ``NystromFactors(U, S)``, ``rho`` and the low-precision factor ``L``;
* :func:`pcg_state` — a :class:`PCGState` from ``(W, R, Z, P_, RZ, ok)``;
* :func:`newton_preconditioner` — a built :class:`Newton` from its factor
  ``L`` and ``rho``;
* :func:`sap_state` — a :class:`SAPState` from ``(W, V, Y, key, t)`` (the
  key's words seed the port's stream, which differs from JAX's);
* :func:`sparse_tensor` — a sparse CSR/CSC tensor from its numpy buffers
  ``(values, indices, indptr)``, shape and layout;
* :func:`skpre_preconditioner` — a built :class:`SkPre` from its factor
  ``L``;
* :func:`lsqr_state` — an :class:`LSQRState` from ``(Y, U, V, W, alpha,
  phibar, rhobar)``.

Nothing here imports ``jax``: callers convert with ``numpy.asarray``. Each
function places what it makes on ``device``, the CUDA card by default (None
raises where there is no card).
"""

from typing import Optional

import numpy as np
import torch

from .kernels.configs import KernelConfig
from .kernels.linop import KernelLinOp
from .kernels.sharded import ShardedKernelLinOp
from .parallel.mesh import make_mesh
from .preconditioners.configs import NewtonConfig, NystromConfig, SkPreConfig
from .preconditioners.newton import Newton
from .preconditioners.nystrom import Nystrom
from .preconditioners.skpre import SkPre
from .solvers.lsqr import LSQRState
from .solvers.pcg import PCGState
from .solvers.sap import SAPState
from .sparse.sparse_tensor import _Layout, _SparseTensor
from .utils.checkers import _as_device


__all__ = [
    "kernel_operator",
    "sharded_kernel_operator",
    "nystrom_preconditioner",
    "newton_preconditioner",
    "pcg_state",
    "sap_state",
    "sparse_tensor",
    "skpre_preconditioner",
    "lsqr_state",
]


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=_as_device(device))


def kernel_operator(
    X, ls, scale, kind: str, device=None, compute_dtype=None
) -> KernelLinOp:
    """``k(X, X)`` operator from the payload of a JAX ``KernelLinOp``
    (``op._data["X1"]``, ``["ls"]``, ``["scale"]``, ``op.kind`` and
    ``op.compute_dtype``)."""
    X_t = _t(X, device)
    ls_np = np.asarray(ls)
    lengthscale = float(ls_np) if ls_np.ndim == 0 else _t(ls_np, device, X_t.dtype)
    cfg = KernelConfig(lengthscale=lengthscale, const_scaling=float(np.asarray(scale)))
    return KernelLinOp(X_t, X_t, cfg, kind, compute_dtype=compute_dtype)


def sharded_kernel_operator(
    X1, ls, scale, kind: str, memory_mode: str, n_positions: int, X2=None,
    device=None, compute_dtype=None,
) -> ShardedKernelLinOp:
    """A sharded kernel operator from the payload of a JAX
    ``ShardedKernelLinOp`` (``np.asarray(op.A1)``, ``op._data["ls"]``,
    ``op._scale``, ``op.kind``, ``op.memory_mode`` and the mesh size), on
    ``n_positions`` positions of ``device``. ``X2=None`` builds it on one
    data set (``A1 is A2``: the triangle kernel on own shards and, in ring
    mode, the symmetric half-ring), as the JAX operator built that way."""
    X1_t = _t(X1, device)
    X2_t = X1_t if X2 is None else _t(X2, device)
    ls_np = np.asarray(ls)
    if ls_np.ndim and np.all(ls_np == ls_np.flat[0]):
        ls_np = ls_np.flat[0]  # the JAX operator broadcasts a scalar to (d,)
    lengthscale = float(ls_np) if np.ndim(ls_np) == 0 else _t(ls_np, device, X1_t.dtype)
    cfg = KernelConfig(lengthscale=lengthscale, const_scaling=float(np.asarray(scale)))
    mesh = make_mesh(devices=[_as_device(device)] * n_positions)
    return ShardedKernelLinOp(
        X1_t, X2_t, cfg, kind, mesh=mesh, memory_mode=memory_mode,
        compute_dtype=compute_dtype,
    )


def nystrom_preconditioner(
    U,
    S,
    rho,
    L=None,
    config: Optional[NystromConfig] = None,
    device=None,
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


def pcg_state(W, R, Z, P_, RZ, ok, device=None) -> PCGState:
    """A :class:`PCGState` from the fields of the JAX package's PCGState."""
    return PCGState(
        W=_t(W, device),
        R=_t(R, device),
        Z=_t(Z, device),
        P_=_t(P_, device),
        RZ=_t(RZ, device),
        ok=_t(ok, device, torch.bool),
    )


def newton_preconditioner(L, rho, device=None) -> Newton:
    """A built Newton preconditioner from the JAX package's ``Newton.L``."""
    P = Newton(NewtonConfig(rho=float(np.asarray(rho))))
    P.L = _t(L, device)
    return P


def sap_state(W, V, Y, key, t, device=None) -> SAPState:
    """A :class:`SAPState` from the fields of the JAX package's SAPState, in
    its order: ``key`` is the JAX key's raw data (two 32-bit words,
    ``jax.random.key_data`` of a typed key), kept on the host as the port's
    key; the port then draws its own stream from those words."""
    return SAPState(
        W=_t(W, device), V=_t(V, device), Y=_t(Y, device),
        key=torch.as_tensor(np.asarray(key).astype(np.int64)), t=int(np.asarray(t)),
    )


def sparse_tensor(values, indices, indptr, shape, layout="csr", device=None) -> _SparseTensor:
    """A sparse tensor from the buffers of the JAX package's ``_SparseTensor``
    (``.values``, ``.indices``, ``.indptr``, ``.shape``; ``layout`` "csr" or
    "csc", the lower-case name of its ``.layout``)."""
    return _SparseTensor(
        np.asarray(values), np.asarray(indices), np.asarray(indptr), shape,
        _Layout[layout.upper()], _as_device(device),
    )


def skpre_preconditioner(L, config: Optional[SkPreConfig] = None, device=None) -> SkPre:
    """A built SkPre from the JAX package's factor ``SkPre.L``."""
    L_t = _t(L, device)
    P = SkPre(config or SkPreConfig(sketch_size=L_t.shape[0], rho=0.0))
    P.L = L_t
    return P


def lsqr_state(Y, U, V, W, alpha, phibar, rhobar, device=None) -> LSQRState:
    """An :class:`LSQRState` from the fields of the JAX package's LSQRState."""
    return LSQRState(*(_t(a, device) for a in (Y, U, V, W, alpha, phibar, rhobar)))
