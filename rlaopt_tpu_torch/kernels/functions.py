"""Closed-form kernel tile formulas.

Port of ``rlaopt_tpu/kernels/functions.py``: RBF, Laplace and Matérn 1/2,
3/2, 5/2 on dense tiles of pre-scaled inputs, in the input dtype (float32 or
float64). Squared distances use the expansion ``‖x‖² + ‖y‖² − 2·x·yᵀ``,
clamped at zero before any square root; the Laplace (L1) distance has no
matmul form and is summed directly.
"""

from typing import Callable, Dict

import torch


__all__ = [
    "KERNEL_KINDS",
    "kernel_tile",
    "kernel_from_sqdist",
    "sqdist_tile",
    "l1dist_tile",
    "scale_inputs",
]

_SQRT3 = 3.0**0.5
_SQRT5 = 5.0**0.5


def scale_inputs(X: torch.Tensor, lengthscale) -> torch.Tensor:
    """X / ℓ with a float or ARD (d,) lengthscale."""
    return X / torch.as_tensor(lengthscale, dtype=X.dtype, device=X.device)


def sqdist_tile(Xs: torch.Tensor, Ys: torch.Tensor, precision=None) -> torch.Tensor:
    """Pairwise squared distances ‖xᵢ−yⱼ‖² via the matmul expansion, ≥ 0.

    ``precision``: the JAX package's matmul precision, taken and ignored as
    :func:`kernel_tile` takes it (the product is full float32 or float64)."""
    xn = torch.sum(Xs * Xs, dim=1)[:, None]
    yn = torch.sum(Ys * Ys, dim=1)[None, :]
    return torch.clamp(xn + yn - 2.0 * (Xs @ Ys.T), min=0.0)


def l1dist_tile(Xs: torch.Tensor, Ys: torch.Tensor, chunk: int = 16):
    """Pairwise L1 distances Σ_d |xᵢd − yⱼd|, summed directly, one feature
    chunk of width ``chunk`` at a time (the JAX package's default 16).

    Each chunk is a ``torch.cdist`` with ``p=1``, which writes the (n, m)
    distances and makes no temporary of its own: a broadcast over a chunk
    would make an (n, m, chunk) one, 6.4 GB in float32 for SAP's dense
    10,000-point block at a chunk of 16. :func:`kernel_tile` takes the whole
    width as one chunk (one sweep of the output).
    """
    if chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk}")
    d = Xs.shape[1]
    out = torch.cdist(Xs[:, :chunk], Ys[:, :chunk], p=1)
    for s in range(chunk, d, chunk):
        out += torch.cdist(Xs[:, s : s + chunk], Ys[:, s : s + chunk], p=1)
    return out


def _rbf(D2):
    return torch.exp(-0.5 * D2)


def _matern12(D2):
    return torch.exp(-torch.sqrt(D2))


def _matern32(D2):
    D = torch.sqrt(D2)
    return (1.0 + _SQRT3 * D) * torch.exp(-_SQRT3 * D)


def _matern52(D2):
    D = torch.sqrt(D2)
    return (1.0 + _SQRT5 * D + (5.0 / 3.0) * D2) * torch.exp(-_SQRT5 * D)


# The squared-distance families, as functions of the squared distance.
_OF_SQDIST: Dict[str, Callable] = {
    "rbf": _rbf,
    "matern12": _matern12,
    "matern32": _matern32,
    "matern52": _matern52,
}

KERNEL_KINDS = ("rbf", "laplace", "matern12", "matern32", "matern52")


def kernel_from_sqdist(kind: str, D2: torch.Tensor) -> torch.Tensor:
    """Kernel values of a squared-distance family (RBF, Matérn) from squared
    distances ``D2 ≥ 0`` of pre-scaled points."""
    try:
        fn = _OF_SQDIST[kind]
    except KeyError:
        raise ValueError(
            f"kernel kind {kind!r} is not a function of the squared distance; "
            f"expected one of {tuple(_OF_SQDIST)}"
        ) from None
    return fn(D2)


def kernel_tile(kind: str, Xs: torch.Tensor, Ys: torch.Tensor, precision=None) -> torch.Tensor:
    """Evaluate the (pre-scaled) kernel tile k(Xs, Ys) of shape (m, n).

    ``precision`` is the JAX package's (``Precision.HIGHEST`` by default
    there), taken and ignored: a float32 product here is already full
    float32 on the CPU, and on a card TF32 stays off
    (``torch.backends.cuda.matmul.allow_tf32`` is False by default)."""
    if kind not in KERNEL_KINDS:
        raise ValueError(
            f"Unknown kernel kind {kind!r}; expected one of {KERNEL_KINDS}"
        )
    if kind == "laplace":
        return torch.exp(-l1dist_tile(Xs, Ys, chunk=max(Xs.shape[1], 1)))
    return kernel_from_sqdist(kind, sqdist_tile(Xs, Ys, precision))
