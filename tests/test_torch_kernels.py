"""Port parity: the Gram kernels' plain PyTorch versions against the JAX
package (XLA streaming path and the Pallas kernels in interpret mode), on the
same numpy inputs. The CUDA kernels are held to the plain versions on a card
in ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.kernels.functions import kernel_tile as jax_kernel_tile
from rlaopt_tpu.ops.kernel_pallas import (
    kernel_matmat_pallas,
    kernel_matvec_symmetric,
)
from rlaopt_tpu.ops.kernel_xla import kernel_matmat_xla
from rlaopt_tpu_torch.kernels.functions import KERNEL_KINDS, kernel_tile
from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
from rlaopt_tpu_torch.ops.kernel_dispatch import kernel_matmat
from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand

SQDIST_KINDS = ("rbf", "matern12", "matern32", "matern52")


def _data(seed, n, m, d, k, dtype):
    rng = np.random.default_rng(seed)
    X1 = rng.standard_normal((n, d)).astype(dtype)
    X2 = rng.standard_normal((m, d)).astype(dtype)
    V = rng.standard_normal((m, k)).astype(dtype)
    return X1, X2, V


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("kind", KERNEL_KINDS)
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_kernel_tile_matches_jax(kind, dtype, rtol):
    X1, X2, _ = _data(0, 37, 29, 6, 1, dtype)
    ref = np.asarray(jax_kernel_tile(kind, jnp.asarray(X1), jnp.asarray(X2)))
    got = kernel_tile(kind, torch.from_numpy(X1), torch.from_numpy(X2)).numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("kind", KERNEL_KINDS)
def test_plain_matmat_matches_xla_f64(kind):
    X1, X2, V = _data(1, 83, 61, 7, 3, np.float64)
    ref = kernel_matmat_xla(
        kind, jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(V), 1.7, 0.8,
        row_block=16,
    )
    got = kernel_plain.gram_matmat(
        kind, torch.from_numpy(X1), torch.from_numpy(X2), torch.from_numpy(V),
        1.7, 0.8, row_block=16,
    )
    assert _rel(got, ref) <= 1e-11


@pytest.mark.parametrize("kind", SQDIST_KINDS)
@pytest.mark.parametrize("k", [1, 3, 7, 16, 17, 130])
def test_plain_matmat_matches_pallas_f32(kind, k):
    """Ragged n, m and d against several row and column tiles, at the
    widths where the card's K1 changes form (its tile up to 16 columns, the
    3xTF32 kernel past 16): 1e-5 of max|ref|, float32 sums in two orders."""
    X1, X2, V = _data(2, 77, 301, 11, k, np.float32)
    ref = kernel_matmat_pallas(
        kind, jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(V), 2.3, 1.2,
        tile_m=32, tile_n=128, interpret=True,
    )
    got = kernel_plain.gram_matmat(
        kind, torch.from_numpy(X1), torch.from_numpy(X2), torch.from_numpy(V),
        2.3, 1.2,
    )
    assert got.shape == (77, k)
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("k", [1, 2, 10])
def test_plain_symmetric_matches_pallas_triangle(k):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((600, 9)).astype(np.float32)
    V = rng.standard_normal((600, k)).astype(np.float32)
    ref = kernel_matvec_symmetric(
        "rbf", jnp.asarray(X), jnp.asarray(V), 1.9, 1.1, tile=256,
        interpret=True,
    )
    got = kernel_plain.gram_matvec_symmetric(
        "rbf", torch.from_numpy(X), torch.from_numpy(V), 1.9, 1.1
    )
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("kind", SQDIST_KINDS)
def test_plain_symmetric_matches_pallas_triangle_every_family(kind, k):
    """K2's plain version against the JAX triangle kernel in interpret mode
    in every squared-distance family, at the widths of the card's triangle
    (1, 2 ... 16 right-hand sides a launch): 1e-5 of max|ref| (float32 sums
    in two orders). Matérn-1/2's diagonal: both sides take the float32
    matmul expansion, whose cancelled distance of a point with itself comes
    out of the square root ~1e-3 from 0, differently in the two orders; so
    there the rows whose own row of V is zero (no diagonal value) are held
    to 1e-5, even rows then odd ones, as chip_smoke.py holds K2b."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((600, 9)).astype(np.float32)
    V = rng.standard_normal((600, k)).astype(np.float32)
    parities = (0, 1) if kind == "matern12" else (None,)
    for parity in parities:
        rows = np.ones(600, bool) if parity is None else np.arange(600) % 2 == parity
        Vp = np.where(rows[:, None], 0.0, V).astype(np.float32) if parity is not None else V
        ref = kernel_matvec_symmetric(
            kind, jnp.asarray(X), jnp.asarray(Vp), 1.9, 1.1, tile=256, interpret=True,
        )
        got = kernel_plain.gram_matvec_symmetric(
            kind, torch.from_numpy(X), torch.from_numpy(Vp), 1.9, 1.1
        )
        assert _rel(got[rows], np.asarray(ref)[rows]) <= 1e-5


def test_plain_compensated_accumulation():
    """Mirror of the JAX package's compensated test: hi + lo tracks the f64
    sum beyond the plain f32 accumulation floor across many column tiles."""
    X1, X2, V = _data(4, 16, 4096, 4, 2, np.float32)
    ref = jax_kernel_tile("rbf", jnp.asarray(X1, jnp.float64),
                          jnp.asarray(X2, jnp.float64))
    ref = np.asarray(ref) @ V.astype(np.float64)
    t1, t2, tv = map(torch.from_numpy, (X1, X2, V))
    hi, lo = kernel_plain.gram_matmat_comp("rbf", t1, t2, tv, 1.0, col_block=128)
    plain = kernel_plain.gram_matmat("rbf", t1, t2, tv, 1.0)
    err_comp = _rel(hi.double() + lo.double(), ref)
    assert err_comp < 2e-7
    assert err_comp <= _rel(plain, ref)
    jhi, jlo = kernel_matmat_pallas(
        "rbf", jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(V), 1.0, 1.0,
        tile_m=16, tile_n=128, interpret=True, compensated=True,
    )
    jax_comp = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    assert _rel(hi.double() + lo.double(), jax_comp) < 2e-7
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), rtol=1e-5, atol=1e-5)


def test_plain_compensated_matern_and_vector():
    X1, X2, V = _data(5, 40, 700, 6, 1, np.float32)
    ref = jax_kernel_tile("matern32", jnp.asarray(X1 / np.float32(1.5), jnp.float64),
                          jnp.asarray(X2 / np.float32(1.5), jnp.float64))
    ref = 0.7 * np.asarray(ref) @ V[:, 0].astype(np.float64)
    hi, lo = kernel_plain.gram_matmat_comp(
        "matern32", torch.from_numpy(X1), torch.from_numpy(X2),
        torch.from_numpy(V[:, 0]), 1.5, 0.7, col_block=64,
    )
    assert hi.shape == (40,) and lo.shape == (40,)
    assert _rel(hi.double() + lo.double(), ref) < 2e-7


@pytest.mark.parametrize("kind", SQDIST_KINDS)
def test_compensated_divides_by_the_lengthscale_in_float64(kind):
    """``hi + lo`` is the float64 product of the unscaled float32 points:
    the f32 rounding of ``X / ℓ``, which K1 and the JAX package's
    compensated path keep, is not in it."""
    X1, X2, V = _data(10, 30, 500, 7, 2, np.float32)
    ls, c = 28**0.5, 0.9
    t1, t2, tv = map(torch.from_numpy, (X1, X2, V))
    ref = kernel_plain.gram_matmat_f64(kind, t1, t2, tv, ls, c)
    hi, lo = kernel_plain.gram_matmat_comp(kind, t1, t2, tv, ls, c, col_block=64)
    assert _rel(hi.double() + lo.double(), ref) < 1e-12
    prescaled = kernel_plain.gram_matmat_f64(kind, t1 / ls, t2 / ls, tv, 1.0, c)
    assert _rel(prescaled, ref) > 1e-10


def test_compensated_gap_to_jax_at_the_slice_lengthscale():
    """The port's K1c and the JAX compensated kernel are different contracts.

    At the slice's d = 28 and lengthscale √28 the JAX kernel (f32 points
    pre-scaled in f32, f32 kernel values, TwoSum across column tiles) sits
    4.6e-7 of max|ref| from the float64 product of the unscaled points
    (seed 11; 2.3e-7 to 4.6e-7 over seeds 11-13), while the port's K1c
    (float64 inside a tile) sits at float64 round-off. That gap is the
    difference between the two packages' true residuals; it is what lets
    the port's logged residual agree with a float64 one at the f32
    operator's floor."""
    X1, X2, V = _data(11, 64, 1024, 28, 2, np.float32)
    ls = 28**0.5
    jhi, jlo = kernel_matmat_pallas(
        "rbf", jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(V), ls, 1.0,
        tile_m=32, tile_n=128, interpret=True, compensated=True,
    )
    jax_comp = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    t1, t2, tv = map(torch.from_numpy, (X1, X2, V))
    hi, lo = kernel_plain.gram_matmat_comp("rbf", t1, t2, tv, ls, col_block=128)
    port = hi.double() + lo.double()
    ref = kernel_plain.gram_matmat_f64("rbf", t1, t2, tv, ls)
    assert _rel(port, ref) < 1e-12
    jax_err = _rel(jax_comp, ref)
    assert 1e-7 < jax_err < 1e-6
    assert 1e-7 < _rel(port, jax_comp) < 1e-6
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), rtol=1e-5, atol=1e-5)


def test_dispatch_sends_cpu_to_plain_and_counts_nothing():
    kernel_cuda.reset_launch_counts()
    X1, X2, V = _data(6, 20, 20, 3, 2, np.float32)
    t1, tv = torch.from_numpy(X1), torch.from_numpy(V)
    out = kernel_matmat("rbf", t1, t1, tv, 1.0, symmetric=True)
    ref = kernel_plain.gram_matmat("rbf", t1, t1, tv, 1.0)
    assert torch.equal(out, ref)
    # float64 points take the one float64 plain product
    t64, v64 = t1.double(), tv.double()
    out = kernel_matmat("matern32", t64, t64, v64, 1.0, symmetric=True)
    assert torch.equal(out, kernel_plain.gram_matmat_f64("matern32", t64, t64, v64, 1.0))
    assert set(kernel_cuda.launch_counts().values()) == {0}


def test_cuda_wrappers_refuse_what_they_cannot_take():
    t = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel_cuda.gram_matmat("rbf", t, t, t[:, :1], 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel_cuda.gram_matmat("laplace", t, t, t[:, :1], 1.0)
    parts = tier_operand(t, "bf16x3")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel_cuda.gram_matmat_tier("rbf", parts, parts, t[:, :1], 1.0)
    for tier_product in (lambda: kernel_cuda.gram_matmat_tier("laplace", parts, parts, t[:, :1]),
                         lambda: kernel_cuda.gram_matvec_symmetric_tier("laplace", parts,
                                                                        t[:, :1]),
                         lambda: kernel_cuda.gram_pair_tier("laplace", parts, parts, t[:, :1],
                                                            t[:, :1])):
        with pytest.raises(NotImplementedError, match="Laplace family has no tier"):
            tier_product()
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel_cuda.gram_matmat_f64("rbf", t, t, t[:, :1].double(), 1.0)
    from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp

    with pytest.raises(ValueError, match="unsupported compute_dtype"):
        RBFLinOp(t, t, KernelConfig(lengthscale=1.0), compute_dtype="fp8")
    assert set(kernel_cuda.launch_counts().values()) == {0}


def test_compensated_applies_operator_scale():
    """``(c·K).matmat_compensated`` carries the operator-level scale set by
    ``*`` as well as the config's ``const_scaling``."""
    from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp

    X, _, V = _data(9, 50, 50, 3, 2, np.float64)
    Xt = torch.from_numpy(X)
    K = RBFLinOp(Xt, Xt, KernelConfig(lengthscale=1.1, const_scaling=0.5))
    hi, lo = (K * 3.0).matmat_compensated(torch.from_numpy(V))
    ref = 1.5 * kernel_tile("rbf", Xt / 1.1, Xt / 1.1) @ torch.from_numpy(V)
    assert _rel(hi + lo, ref) <= 1e-13
