"""Value-accurate kernel Gram matmat — the certified-residual route.

Port of ``rlaopt_tpu/ops/kernel_value64.py``. The JAX package gets ~3e-9
kernel values on a TPU, which has no float64, from two-float arithmetic
(``ops/twofloat.py``). The H100 has FP64 units, so the port computes the
float64 product directly (:func:`rlaopt_tpu_torch.ops.kernel_dispatch.
kernel_matmat_f64`: the CUDA kernels K7 and K8 on a card, the plain float64
version on the CPU) and keeps the JAX function's contract: the same name,
the ``X1 is X2`` auto-detection, the d ≤ 512 guard and the ``(hi, lo)``
float32 return. ``ops/twofloat.py`` is not ported.

:func:`kernel_matmat_value64` is the public counterpart of the JAX function
for callers that want its ``(hi, lo)`` form; refinement takes the float64
result of :func:`kernel_matmat_f64` as it is.
"""

import torch

from .kernel_dispatch import kernel_matmat_f64


__all__ = ["kernel_matmat_value64", "VALUE64_MAX_D"]

# Feature-dim cap, the JAX package's guard.
VALUE64_MAX_D = 512

_KINDS = ("rbf", "laplace", "matern12", "matern32", "matern52")


def kernel_matmat_value64(
    X1: torch.Tensor,
    X2: torch.Tensor,
    V: torch.Tensor,
    lengthscale,
    const_scaling: float = 1.0,
    *,
    kind: str = "rbf",
    symmetric=None,
    devices=None,
):
    """``c·k(X1, X2) @ V`` with float64 kernel values, any family, as a
    ``(hi, lo)`` float32 pair (add ``lo`` last).

    ``V`` may be float32 or float64 (taken in float64). ``symmetric`` (None:
    ``X1 is X2``) takes the triangle kernel; an explicit ``symmetric=True``
    with distinct buffers is checked on 16 sampled rows, since the triangle
    reads X1 only.

    ``devices``: None, or a list of devices (the positions of a mesh, say)
    over which X1's rows are spread: one chunk of rows per device in turn,
    each against all of X2 (the forward form, K8 on a card: a slab of rows
    is a rectangle, also of a symmetric product), X2 and V staged once per
    device, every chunk issued before any is gathered; the result lies on
    X1's device. The JAX package's TPU tiling knobs (``tile_m``,
    ``tile_n``, ``chunk_rows``, ``interpret``, ``_debug_skip``) have no
    meaning for these kernels and are not taken.
    """
    if kind not in _KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    n, d = X1.shape
    if d > VALUE64_MAX_D:
        raise ValueError(
            f"value64 kernel supports d <= {VALUE64_MAX_D} (got d={d}); "
            "use the host f64 path for wider feature dims"
        )
    if symmetric is None:
        symmetric = X1 is X2
    elif symmetric and X1 is not X2:
        if X1.shape != X2.shape:
            raise ValueError(
                "symmetric=True requires X1 and X2 to be the same data "
                f"set; got shapes {tuple(X1.shape)} vs {tuple(X2.shape)}"
            )
        idx = torch.linspace(0, n - 1, min(16, n), device=X1.device).long()
        if not torch.equal(X1[idx], X2[idx]):
            raise ValueError(
                "symmetric=True but X1 and X2 differ (checked 16 sampled "
                "rows); pass symmetric=False (or None) for distinct data"
            )
    if devices:
        out = _spread_rows(kind, X1, X2, V, lengthscale, float(const_scaling), devices)
    else:
        out = kernel_matmat_f64(
            kind, X1, X2, V, lengthscale, float(const_scaling), symmetric=symmetric
        )
    hi = out.float()
    return hi, (out - hi.double()).float()


def _spread_rows(kind, X1, X2, V, lengthscale, c, devices):
    """The float64 product with X1's rows in one chunk per device, round
    robin over ``devices``, gathered on X1's device in row order."""
    devs = [torch.device(dv) for dv in devices]
    step = -(-X1.shape[0] // len(devs))
    staged, parts = {}, []
    for i, s in enumerate(range(0, X1.shape[0], step)):
        dev = devs[i % len(devs)]
        if dev not in staged:
            ls = lengthscale.to(dev) if isinstance(lengthscale, torch.Tensor) else lengthscale
            staged[dev] = (X2.to(dev), V.to(dev), ls)
        X2d, Vd, ls = staged[dev]
        parts.append(kernel_matmat_f64(kind, X1[s : s + step].to(dev), X2d, Vd, ls, c))
    return torch.cat([p.to(X1.device) for p in parts])
