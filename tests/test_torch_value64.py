"""The port's float64 route (``kernel_matmat_value64`` over
``kernel_matmat_f64``: K7/K8 on a card, the plain float64 version here)
against the JAX value64 engine in interpret mode and a numpy float64
product, on the same numpy inputs.

The JAX contract is ~3e-9 of max|ref| (two-float kernel values on the TPU);
the port computes the float64 product itself, so it is held to that bound
against JAX and to float64 round-off (1e-12) against numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.ops.kernel_value64 import kernel_matmat_value64 as jax_value64
from rlaopt_tpu_torch.ops import kernel_cuda
from rlaopt_tpu_torch.ops.kernel_dispatch import kernel_matmat_f64
from rlaopt_tpu_torch.ops.kernel_value64 import VALUE64_MAX_D, kernel_matmat_value64

KINDS = ("rbf", "laplace", "matern12", "matern32", "matern52")
ARD = np.array([0.7, 1.1, 1.9, 2.5, 0.9])


def _numpy_f64(kind, X, Y, V, ls, c):
    Xs = np.asarray(X, np.float64) / np.asarray(ls, np.float64)
    Ys = np.asarray(Y, np.float64) / np.asarray(ls, np.float64)
    diff = Xs[:, None, :] - Ys[None, :, :]
    if kind == "laplace":
        K = np.exp(-np.abs(diff).sum(-1))
    else:
        d2 = (diff**2).sum(-1)
        r = np.sqrt(d2)
        K = {
            "rbf": lambda: np.exp(-0.5 * d2),
            "matern12": lambda: np.exp(-r),
            "matern32": lambda: (1 + 3**0.5 * r) * np.exp(-(3**0.5) * r),
            "matern52": lambda: (1 + 5**0.5 * r + 5 / 3 * d2) * np.exp(-(5**0.5) * r),
        }[kind]()
    return c * K @ np.asarray(V, np.float64)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_value64_matches_jax_and_float64(kind, ard, symmetric):
    rng = np.random.default_rng(4)
    n, m, d, k = 300, 280, 5, 3
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = X if symmetric else rng.standard_normal((m, d)).astype(np.float32)
    V = rng.standard_normal((Y.shape[0], k)).astype(np.float32)
    ls = ARD if ard else 1.6
    c = 0.83
    Xj = jnp.asarray(X)
    jhi, jlo = jax_value64(
        Xj, Xj if symmetric else jnp.asarray(Y), V, ls, c, kind=kind, interpret=True
    )
    jax_out = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    Xt = torch.from_numpy(X)
    Yt = Xt if symmetric else torch.from_numpy(Y)
    lst = torch.as_tensor(ls, dtype=torch.float64)
    hi, lo = kernel_matmat_value64(Xt, Yt, torch.from_numpy(V).double(), lst, c, kind=kind)
    assert hi.dtype == lo.dtype == torch.float32
    port = hi.double() + lo.double()
    ref = _numpy_f64(kind, X, Y, V, ls, c)
    assert _rel(port, ref) <= 1e-12
    assert _rel(port, jax_out) <= 3e-9


def test_value64_guards_and_routes():
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((40, 2)))
    with pytest.raises(ValueError, match="unknown kernel kind"):
        kernel_matmat_value64(X, X, V, 1.0, kind="cauchy")
    wide = torch.zeros((4, VALUE64_MAX_D + 1))
    with pytest.raises(ValueError, match="d <= 512"):
        kernel_matmat_value64(wide, wide, torch.zeros((4, 1)), 1.0)
    other = X.clone()
    other[0, 0] += 1.0
    with pytest.raises(ValueError, match="differ"):
        kernel_matmat_value64(X, other, V, 1.0, symmetric=True)
    # an explicit symmetric=True on an equal copy takes the triangle route
    hi, lo = kernel_matmat_value64(X, X.clone(), V, 1.0, symmetric=True)
    ref = kernel_matmat_f64("rbf", X, X, V, 1.0)
    assert torch.equal(hi.double() + lo.double(), ref.float().double() + (ref - ref.float().double()).float().double())
    # the float64 route on the CPU launches nothing
    kernel_cuda.reset_launch_counts()
    kernel_matmat_f64("laplace", X, X, V, 1.0, symmetric=True)
    assert set(kernel_cuda.launch_counts().values()) == {0}
