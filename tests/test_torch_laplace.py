"""The port's Laplace Gram products against the JAX package's Pallas Laplace
kernels (``_laplace_matmat``, ``_laplace_matvec_symmetric``) run in
interpret mode on the CPU, from the same numpy inputs.

On the CPU the port's dispatcher sends these products to the plain
versions, which the card's kernels K3, K3c and K5 are held to in
``chip_smoke.py`` and ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.ops.kernel_pallas import kernel_matmat_pallas, kernel_matvec_symmetric
from rlaopt_tpu_torch.kernels import KernelConfig, LaplaceLinOp
from rlaopt_tpu_torch.kernels.functions import l1dist_tile
from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
from rlaopt_tpu_torch.ops.kernel_dispatch import kernel_matmat, kernel_matmat_compensated
from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand


def _data(seed, n, m, d, k):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((m, k)).astype(np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _worst(got, ref) -> str:
    """Both sides at the entry where they differ most, and the max|.| of
    each side: which of the two went wrong when a comparison fails."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    at = np.unravel_index(np.abs(got - ref).argmax(), got.shape)
    return (f"worst entry {tuple(int(i) for i in at)}: port {float(got[at])!r}, JAX "
            f"{float(ref[at])!r}; max|port| {float(np.abs(got).max())!r}, max|JAX| "
            f"{float(np.abs(ref).max())!r}")


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# Lengthscales near the mean L1 distance of d standard-normal features
# (2d/√π), where kernel values sit near e⁻¹, as on the slice's paths.
@pytest.mark.parametrize("k", [1, 10, 17, 64, 500])
@pytest.mark.parametrize("d", [28, 50, 70])
def test_general_matches_pallas_interpret(d, k):
    """``_laplace_matmat`` (K3's TPU kernel; d = 70 crosses its 64-feature
    block; past 16 columns, k = 17, 64 and 500, its "highest" contraction,
    which the card's 3xTF32 kernel meets) against the port's float32
    product: both sum |x − y| over d float32 features, in other orders, so
    2e-6 of max|ref|."""
    X1, X2, V = _data(d + k, 200, 260, d, k)
    ls = 2 * d / np.sqrt(np.pi)
    ref = kernel_matmat_pallas("laplace", X1, X2, V, ls, 0.8, interpret=True)
    got = kernel_matmat("laplace", *_t(X1, X2, V), ls, 0.8)
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= 2e-6, _worst(got, ref)


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("n", [700, 1024])
def test_triangle_matches_pallas_interpret(n, k):
    """``_laplace_matvec_symmetric`` (K5's TPU kernel) at tile 256: 3 tiles
    (odd) at n = 700, 4 (even) at 1024. The port's symmetric route (the
    plain K5) on an operator built on one data set: 2e-6."""
    X, _, V = _data(n + k, n, n, 28, k)
    ls = 32.0
    ref = kernel_matvec_symmetric("laplace", X, V, ls, 1.2, tile=256, interpret=True)
    Xt, Vt = _t(X, V)
    got = kernel_matmat("laplace", Xt, Xt, Vt, ls, 1.2, symmetric=True)
    assert _rel(got, ref) <= 2e-6
    op = LaplaceLinOp(Xt, Xt, KernelConfig(lengthscale=ls, const_scaling=1.2))
    assert _rel(op @ Vt, ref) <= 2e-6


def test_compensated_against_float64_and_the_pallas_contract():
    """K3c's plain version (float64 tiles, TwoSum across column tiles into a
    float pair) is the float64 product to 1e-12. The JAX compensated kernel
    keeps float32 kernel values of points pre-scaled in float32: its gap to
    the float64 product here is ~1e-7 (held to 1e-6), and the port's
    compensated product is at least 100x closer."""
    X1, X2, V = _data(5, 300, 333, 50, 3)
    ls = 8.0
    ref64 = kernel_plain.gram_matmat_f64("laplace", *_t(X1, X2, V), ls, 0.7)
    hi, lo = kernel_matmat_compensated("laplace", *_t(X1, X2, V), torch.tensor(ls, dtype=torch.float64), 0.7)
    got = hi.double() + lo.double()
    err = _rel(got, ref64)
    assert err <= 1e-12
    jhi, jlo = kernel_matmat_pallas("laplace", X1, X2, V, ls, 0.7, interpret=True,
                                    compensated=True)
    jerr = _rel(np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64), ref64)
    assert 1e-9 < jerr <= 1e-6
    assert err <= 1e-2 * jerr


def test_ard_lengthscale_and_scale():
    """A (d,) lengthscale and const_scaling, general and triangle."""
    X, _, V = _data(8, 300, 300, 6, 2)
    ls = np.array([0.7, 1.1, 1.9, 2.5, 0.9, 3.0], np.float32)
    ref = kernel_matmat_pallas("laplace", X, X, V, jnp.asarray(ls), 1.3, interpret=True)
    Xt, Vt, lst = _t(X, V, ls)
    assert _rel(kernel_matmat("laplace", Xt, Xt, Vt, lst, 1.3), ref) <= 2e-6
    assert _rel(kernel_matmat("laplace", Xt, Xt, Vt, lst, 1.3, symmetric=True), ref) <= 2e-6
    ref64 = kernel_plain.gram_matmat_f64("laplace", Xt, Xt, Vt, lst.double(), 1.3)
    hi, lo = kernel_matmat_compensated("laplace", Xt, Xt, Vt, lst.double(), 1.3)
    assert _rel(hi.double() + lo.double(), ref64) <= 1e-12


def test_l1dist_is_the_broadcast_sum():
    """``l1dist_tile`` sums directly (no (n, m, chunk) temporary); it equals
    the feature-chunked broadcast sum it replaced: exactly in float64 up to
    summation order (1e-14), and to float32 rounding in float32."""
    rng = np.random.default_rng(9)
    X, Y = rng.standard_normal((70, 37)), rng.standard_normal((50, 37))
    for dtype, tol in ((torch.float64, 1e-14), (torch.float32, 1e-6)):
        Xt, Yt = torch.tensor(X, dtype=dtype), torch.tensor(Y, dtype=dtype)
        acc = torch.zeros((70, 50), dtype=dtype)
        for f in range(0, 37, 16):
            acc += torch.sum(torch.abs(Xt[:, None, f : f + 16] - Yt[None, :, f : f + 16]), -1)
        assert _rel(l1dist_tile(Xt, Yt), acc) <= tol


def test_laplace_wrappers_take_cuda_tensors_only():
    """On the CPU the dispatcher never reaches the Laplace kernels, and
    their wrappers (the exact tier's, with ``kind="laplace"``) refuse CPU
    tensors; the bf16 tiers' kernels refuse the Laplace family."""
    t = torch.zeros((4, 2))
    kernel_cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel_cuda.gram_matmat("laplace", t, t, t[:, :1], 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel_cuda.gram_matmat_comp("laplace", t, t, t[:, :1], 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel_cuda.gram_matvec_symmetric("laplace", t, t[:, :1], 1.0)
    parts = tier_operand(t, "bf16x3")
    with pytest.raises(NotImplementedError, match="Laplace family has no tier"):
        kernel_cuda.gram_matvec_symmetric_tier("laplace", parts, t[:, :1], 1.0)
    X = torch.randn((40, 3))
    op = LaplaceLinOp(X, X, KernelConfig(lengthscale=2.0))
    op @ torch.randn(40)
    op.matmat_compensated(torch.randn((40, 2)))
    assert set(kernel_cuda.launch_counts().values()) == {0}
