"""Plain reference of RBF kernel ridge regression.

K[i, j] = exp(-|x_i - x_j|^2 / (2 l^2)), the system (K + reg I) W = y. The
reference evaluates ``K[rows, :] @ V`` in blocks of rows, from the points,
the lengthscale and V alone, and the residual norms of iterates from those
products. It uses PyTorch's dense operations and nothing of the program:
no kernel, no plain version of a kernel, no oracle.

``dtype=torch.float64`` is the reference. ``tf32=True`` (float32) rounds
both operands of each of its two products to TF32, a 10-bit mantissa, before
a float32 product: what a float32 apply with TF32 tensor cores computes,
on any device. It is the control of an exact float32 configuration.
"""

import torch

# Values of K held at once: 2^26 (512 MiB in float64).
BLOCK_VALUES = 1 << 26


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & -0x2000).view(torch.float32)


def _mm(a, b, tf32: bool):
    return tf32_round(a) @ tf32_round(b) if tf32 else a @ b


def gram_apply(X, rows, V, lengthscale: float, dtype=torch.float64, tf32: bool = False,
               block_values: int = BLOCK_VALUES):
    """``K[rows, :] @ V`` in ``dtype`` on X's device; ``rows`` a 1-D index
    tensor, V (n, c)."""
    dev = X.device
    Xs = X.to(dtype) / lengthscale
    sq = torch.sum(Xs * Xs, dim=1)
    V = V.to(dev, dtype)
    rows = rows.to(dev)
    n = Xs.shape[0]
    step = max(1, block_values // n)
    out = torch.empty((rows.shape[0], V.shape[1]), dtype=dtype, device=dev)
    for a in range(0, rows.shape[0], step):
        idx = rows[a:a + step]
        D2 = sq[idx, None] + sq[None, :] - 2.0 * _mm(Xs[idx], Xs.T, tf32)
        K = torch.exp(-0.5 * torch.clamp(D2, min=0.0))
        out[a:a + step] = _mm(K, V, tf32)
    return out


def residual_norms(X, y, W, reg: float, lengthscale: float, rows, dtype=torch.float64,
                   tf32: bool = False):
    """Per column, the estimate of ``|y - (K + reg I) W|`` from ``rows``:
    the norm over those rows scaled by sqrt(n / len(rows)) (the exact norm
    when ``rows`` are all of them)."""
    n = X.shape[0]
    rows = rows.to(X.device)
    W = W.to(X.device, dtype)
    KW = gram_apply(X, rows, W, lengthscale, dtype, tf32)
    r = y.to(X.device, dtype)[rows] - (KW + reg * W[rows])
    return torch.linalg.norm(r, dim=0) * (n / rows.shape[0]) ** 0.5
