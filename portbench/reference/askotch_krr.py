"""Plain reference of RBF kernel ridge regression solved by ASkotch.

K[i, j] = exp(-|x_i - x_j|^2 / (2 l^2)), the system (K + reg I) W = Y.
It uses PyTorch's dense operations and nothing of the program: no kernel,
no plain version of a kernel, no oracle. Its products run with TF32 off,
whatever the process set.

``gram_apply`` and ``residual_norms`` judge what a run produced, in row
blocks, at any n. :func:`askotch_step` is one step of ASkotch (Rathore,
Frangella, Yang, Dereziński, Udell, arXiv:2407.10070: block-coordinate
sketch-and-project with a Nyström block preconditioner and Nesterov-type
acceleration) on a dense K, for small n. Its random draws come in as
arguments (the block, the Nyström test matrix, the power iteration's
start), so that a test can hand it the draws of the run it checks.
Departures from the paper, each as the repository's solvers do it:

* Nyström: with the test matrix Ω (b, r), Y = K_BB Ω, the shift
  s = eps·tr(Ωᵀ Y) enters the Cholesky factor of Ωᵀ Y + s I only (the
  paper's stable form also adds sΩ to Y); the eigenvalues are max(σ² − s,
  0) of B = L⁻¹ Yᵀ.
* The damping is ρ = reg + λ_r, λ_r the Nyström approximation's smallest
  eigenvalue (the paper's adaptive damping, the solvers' default).
* The stepsize is 1/λ with λ from at most ``power_iters`` steps of the
  power method on P⁻¹(K_BB + reg I) from the given start, stopped once
  successive Rayleigh quotients agree to 1e-3: an estimate of λ_max, as
  in the paper's implementation, not the exact eigenvalue.
* A column whose direction is not finite (a degenerate block) is not
  updated.
"""

import torch

# Values of K held at once: 2^26 (512 MiB in float64).
BLOCK_VALUES = 1 << 26


def gram_apply(X, rows, V, lengthscale: float, dtype=torch.float64,
               block_values: int = BLOCK_VALUES):
    """``K[rows, :] @ V`` in ``dtype`` on X's device; ``rows`` a 1-D index
    tensor, V (n, c)."""
    dev = X.device
    Xs = X.to(dtype) / lengthscale
    sq = torch.sum(Xs * Xs, dim=1)
    V = V.to(dev, dtype)
    rows = rows.to(dev)
    step = max(1, block_values // Xs.shape[0])
    out = torch.empty((rows.shape[0], V.shape[1]), dtype=dtype, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for a in range(0, rows.shape[0], step):
            idx = rows[a:a + step]
            D2 = sq[idx, None] + sq[None, :] - 2.0 * (Xs[idx] @ Xs.T)
            out[a:a + step] = torch.exp(-0.5 * torch.clamp(D2, min=0.0)) @ V
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def residual_norms(X, y, W, reg: float, lengthscale: float, rows, dtype=torch.float64,
                   block_values: int = BLOCK_VALUES):
    """Per column, the estimate of ``|y - (K + reg I) W|`` from ``rows``:
    the norm over those rows scaled by sqrt(n / len(rows)) (the exact norm
    when ``rows`` are all of them)."""
    n = X.shape[0]
    rows = rows.to(X.device)
    W = W.to(X.device, dtype)
    KW = gram_apply(X, rows, W, lengthscale, dtype, block_values)
    r = y.to(X.device, dtype)[rows] - (KW + reg * W[rows])
    return torch.linalg.norm(r, dim=0) * (n / rows.shape[0]) ** 0.5


def dense_gram(X, lengthscale: float) -> torch.Tensor:
    """The whole K in float64 (small n)."""
    return gram_apply(X, torch.arange(X.shape[0]), torch.eye(X.shape[0], dtype=torch.float64),
                      lengthscale)


def nystrom_inverse(K_BB, Omega, reg: float):
    """``x ↦ P⁻¹ x`` for P = U diag(S) Uᵀ + ρ I, U diag(S) Uᵀ the rank-r
    Nyström approximation of K_BB from the test matrix Ω (b, r) and ρ =
    reg + min(S)."""
    Y = K_BB @ Omega
    core = Omega.T @ Y
    shift = torch.finfo(core.dtype).eps * torch.trace(core)
    L = torch.linalg.cholesky(core + shift * torch.eye(core.shape[0], dtype=core.dtype))
    B = torch.linalg.solve_triangular(L, Y.T, upper=False)
    U, sig, _ = torch.linalg.svd(B.T, full_matrices=False)
    S = torch.clamp(sig**2 - shift, min=0.0)
    rho = reg + S[-1]

    def apply(x):
        Ux = U.T @ x
        return (x - U @ Ux) / rho + U @ (Ux / (S + rho)[:, None])

    return apply


def power_lambda(op, v0, iters: int, rtol: float = 1e-3):
    """λ_max of ``op`` by the power method from ``v0`` (see the module's
    docstring)."""
    v = v0 / torch.linalg.norm(v0)
    lam = torch.zeros((), dtype=v.dtype)
    for _ in range(iters):
        w = op(v)
        new = torch.dot(v, w)
        err = abs(float(new - lam))
        v, lam = w / torch.linalg.norm(w), new
        if not err > rtol * float(new):
            break
    return lam


def askotch_step(K, y, reg: float, state, blk, Omega, v0, power_iters: int, accel=None):
    """One ASkotch step on the dense K: ``state`` is (W, V, Yp), the
    iterate, the momentum term and the point the gradient is taken at (all
    W without acceleration); ``accel`` None or (μ, ν). Returns the next
    state."""
    W, V, Yp = state
    K_BB = K[blk][:, blk]
    inv = nystrom_inverse(K_BB, Omega, reg)
    lam = power_lambda(lambda v: inv((K_BB @ v + reg * v)[:, None])[:, 0], v0, power_iters)
    eta = 1.0 / lam
    at = Yp if accel is not None else W
    grad = K[blk] @ at + reg * at[blk] - y[blk]
    d = inv(grad)
    ok = (torch.all(torch.isfinite(d), dim=0) & torch.isfinite(eta))[None, :]
    d = torch.where(ok, d, torch.zeros_like(d))
    if accel is None:
        W = W.clone()
        W[blk] -= eta * d
        return W, W, W
    mu, nu = accel
    beta, gamma = 1 - (mu / nu) ** 0.5, 1 / (mu * nu) ** 0.5
    alpha = 1 / (1 + gamma * nu)
    W1 = Yp.clone()
    W1[blk] -= eta * d
    W1 = torch.where(ok, W1, W)
    V1 = beta * V + (1 - beta) * Yp
    V1[blk] -= eta * gamma * d
    V1 = torch.where(ok, V1, V)
    Y1 = torch.where(ok, alpha * V1 + (1 - alpha) * W1, Yp)
    return W1, V1, Y1
