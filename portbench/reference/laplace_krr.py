"""Plain reference of Laplace kernel ridge regression solved by ASkotch.

K[i, j] = exp(-sum_f |x_if - x_jf| / l), the system (K + reg I) W = Y.
It uses PyTorch's elementwise operations and a matrix product, and nothing
of the program: no kernel, no plain version of a kernel, no oracle, and no
``torch.cdist`` (the routine the program's dense block calls). The L1
distance of a block of rows to every point is summed feature by feature,
in the reference's dtype, before the exponential; the contraction runs
with TF32 off, whatever the process set.

``dtype=torch.float64`` is the reference. ``tf32=True`` (float32) rounds
both operands of the contraction to TF32, a 10-bit mantissa, before a
float32 product: what a float32 apply with TF32 tensor cores computes, on
any device. It is the control of an exact float32 configuration (the L1
distance has no product to round).

``gram_apply`` and ``residual_norms`` judge what a run produced, in row
blocks, at any n; ``gram_block`` judges a block's dense tile. The ASkotch
step on a dense K is ``askotch_krr``'s
:func:`~portbench.reference.askotch_krr.askotch_step`, which takes any
dense K: this module makes the K it takes (:func:`dense_gram`).
"""

import torch

from .askotch_krr import askotch_step  # noqa: F401
from .rbf_krr import tf32_round

# Values of K held at once: 2^26 (512 MiB in float64), twice (the
# distances and one feature's differences).
BLOCK_VALUES = 1 << 26


def gram_apply(X, rows, V, lengthscale: float, dtype=torch.float64, tf32: bool = False,
               block_values: int = BLOCK_VALUES):
    """``K[rows, :] @ V`` in ``dtype`` on X's device; ``rows`` a 1-D index
    tensor, V (n, c)."""
    dev = X.device
    Xs = X.to(dtype) / lengthscale
    XT = Xs.T.contiguous()  # (d, n): one feature of every point, contiguous
    V = V.to(dev, dtype)
    rows = rows.to(dev)
    n = Xs.shape[0]
    step = max(1, min(block_values // n, rows.shape[0]))
    dist = torch.empty((step, n), dtype=dtype, device=dev)
    diff = torch.empty_like(dist)
    out = torch.empty((rows.shape[0], V.shape[1]), dtype=dtype, device=dev)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for a in range(0, rows.shape[0], step):
            Xi = Xs[rows[a:a + step]]
            b = Xi.shape[0]
            K = _laplace(Xi, XT, dist[:b], diff[:b])
            out[a:a + b] = tf32_round(K) @ tf32_round(V) if tf32 else K @ V
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    return out


def gram_block(X, rows, cols, lengthscale: float, dtype=torch.float64):
    """``K[rows, cols]`` in ``dtype`` on X's device; ``rows`` and ``cols``
    1-D index tensors (all of it held at once, twice)."""
    Xs = X.to(dtype) / lengthscale
    XT = Xs[cols.to(X.device)].T.contiguous()
    D = torch.empty((rows.shape[0], XT.shape[1]), dtype=dtype, device=X.device)
    return _laplace(Xs[rows.to(X.device)], XT, D, torch.empty_like(D))


def _laplace(Xi, XT, D, T):
    """exp(-L1 distance) of the rows Xi (b, d) to the columns XT (d, m),
    summed feature by feature in D (b, m), which it returns; T is scratch
    of D's shape."""
    D.zero_()
    for f in range(XT.shape[0]):
        torch.sub(Xi[:, f:f + 1], XT[f], out=T)
        D.add_(T.abs_())
    return D.neg_().exp_()


def residual_norms(X, y, W, reg: float, lengthscale: float, rows, dtype=torch.float64,
                   block_values: int = BLOCK_VALUES):
    """Per column, the estimate of ``|y - (K + reg I) W|`` from ``rows``:
    the norm over those rows scaled by sqrt(n / len(rows)) (the exact norm
    when ``rows`` are all of them)."""
    n = X.shape[0]
    rows = rows.to(X.device)
    W = W.to(X.device, dtype)
    KW = gram_apply(X, rows, W, lengthscale, dtype, block_values=block_values)
    r = y.to(X.device, dtype)[rows] - (KW + reg * W[rows])
    return torch.linalg.norm(r, dim=0) * (n / rows.shape[0]) ** 0.5


def dense_gram(X, lengthscale: float) -> torch.Tensor:
    """The whole K in float64 (small n)."""
    return gram_apply(X, torch.arange(X.shape[0]), torch.eye(X.shape[0], dtype=torch.float64),
                      lengthscale)
