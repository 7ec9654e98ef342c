"""The bf16 tiers' plain versions (the oracles of K1b and K2b) against the
JAX package's Pallas tiers in interpret mode, on the same numpy inputs.

Both sides take the same bf16 roundings of the same float32 points, so what
is left between them is the order of the float32 sums (the cross term, the
contraction) and ``exp``: measured ≤ 7e-7 of max|ref| wherever both
contract in float32, and 1.9e-6 where bf16x3 takes its three-pass "split"
contraction (the general product at k = 20, the triangle's mirror rows at
k = 3), whose hi/lo split of the kernel values moves with their float32
round-off.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.ops.kernel_pallas import kernel_matmat_pallas, kernel_matvec_symmetric
from rlaopt_tpu_torch.ops import kernel_plain
from rlaopt_tpu_torch.ops.kernel_tiers import (
    normalize_compute_dtype,
    split_bf16,
    tier_operand,
)

N, M, D = 256, 200, 28
LS, C = D**0.5, 0.9
TIERS = ("bf16x3", "bfloat16")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _points(seed, n, m, k):
    rng = np.random.default_rng(seed)
    X1 = rng.standard_normal((n, D)).astype(np.float32)
    X2 = rng.standard_normal((m, D)).astype(np.float32)
    V = rng.standard_normal((m, k)).astype(np.float32)
    return X1, X2, V


def _parts(X, cd):
    return tier_operand(torch.from_numpy(X) / LS, cd)


@pytest.mark.parametrize("cd", TIERS)
@pytest.mark.parametrize("kind", ["rbf", "matern32"])
@pytest.mark.parametrize("k", [1, 7, 20])
def test_plain_tier_matmat_matches_pallas(cd, kind, k):
    X1, X2, V = _points(k, N, M, k)
    ref = kernel_matmat_pallas(
        kind, jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(V), LS, C,
        compute_dtype=cd, interpret=True,
    )
    A, B = _parts(X1, cd), _parts(X2, cd)
    got = kernel_plain.gram_matmat_tier(kind, A, B, torch.from_numpy(V), C)
    if k <= 16:
        assert _rel(got, ref) <= 1e-6
    elif cd == "bf16x3":
        assert _rel(got, ref) <= 3e-6
    else:
        # The one-pass "fast" contraction is a DEFAULT-precision dot in the
        # JAX kernel: one bf16 pass on the TPU, full float32 in the CPU
        # interpreter. The port's plain version rounds K and V to bf16 as the
        # TPU does, 2.9e-3 of max|ref| from the interpreter (2^-8 per
        # product); with a float32 contraction its kernel values meet the
        # JAX kernel's at the float32 bound.
        assert _rel(got, ref) <= 2.0**-7
        Kv = kernel_plain._tier_values(kind, A, B)
        f32 = kernel_plain.tier_contract(Kv, torch.from_numpy(V), "f32") * C
        assert _rel(f32, ref) <= 1e-6


@pytest.mark.parametrize("cd", TIERS)
@pytest.mark.parametrize("k", [1, 3])
def test_plain_tier_triangle_matches_pallas(cd, k):
    """At n = 2T the JAX triangle's circulant schedule is K2b's upper
    triangle (tile (0, 1) forward for rows 0..T-1, mirrored for T..2T-1),
    so the plain version at tile T takes the mirror contraction on the same
    entries: float32 at k = 1, split or fast at k = 3."""
    X, _, _ = _points(5, N, 1, 1)
    V = np.random.default_rng(6).standard_normal((N, k)).astype(np.float32)
    ref = kernel_matvec_symmetric(
        "rbf", jnp.asarray(X), jnp.asarray(V), LS, C, compute_dtype=cd,
        tile=128, interpret=True,
    )
    got = kernel_plain.gram_matvec_symmetric_tier(
        "rbf", _parts(X, cd), torch.from_numpy(V), C, tile=128
    )
    assert _rel(got, ref) <= (3e-6 if cd == "bf16x3" and k == 3 else 1e-6)


@pytest.mark.parametrize("cd", TIERS)
def test_tier_triangle_is_the_general_tier_product(cd):
    """K2b's plain version at its own tile (64) against K1b's on (X, X):
    equal to float32 order at k ≤ 2; at k = 3 the mirror rows take the
    tier-matched contraction (bf16x3: ~2^-18 per product; bfloat16: one
    bf16 rounding of K and V, ~2^-8)."""
    X, _, _ = _points(7, 300, 1, 1)
    A = _parts(X, cd)
    for k, bound in ((2, 1e-6), (3, 1e-5 if cd == "bf16x3" else 2.0**-7)):
        V = torch.from_numpy(np.random.default_rng(k).standard_normal((300, k)).astype(np.float32))
        tri = kernel_plain.gram_matvec_symmetric_tier("rbf", A, V, C)
        gen = kernel_plain.gram_matmat_tier("rbf", A, A, V, C)
        assert _rel(tri, gen) <= bound


def test_tier_spelling_and_parts():
    assert normalize_compute_dtype(None) is None
    assert normalize_compute_dtype("bf16") == "bfloat16"
    assert normalize_compute_dtype(torch.bfloat16) == "bfloat16"
    assert normalize_compute_dtype("bf16x3") == "bf16x3"
    with pytest.raises(ValueError, match="unsupported compute_dtype"):
        normalize_compute_dtype("float16")
    X = torch.from_numpy(np.random.default_rng(1).standard_normal((9, 5)).astype(np.float32))
    P = tier_operand(X, "bf16x3")
    assert P.hi.dtype == P.lo.dtype == torch.bfloat16 and P.hi.shape == (9, 16)
    assert torch.all(P.hi[:, 5:] == 0) and P.passes == 3
    hi, lo = split_bf16(X)
    # hi + lo carries 16 of the 24 bits: ~2^-17 relative at worst
    assert torch.all((hi + lo - X).abs() <= 2.0**-16 * X.abs())
    assert torch.equal(P.hi[:, :5].float(), hi)
    assert tier_operand(X, "bfloat16").lo is None
    torch.testing.assert_close(P.sq, (X * X).sum(1))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


def _f64_ref(kind, X1, X2, V, ls, c):
    from rlaopt_tpu_torch.ops.kernel_plain import gram_matmat_f64

    return gram_matmat_f64(kind, torch.from_numpy(X1), torch.from_numpy(X2),
                           torch.from_numpy(V).double(), ls, c)


@pytest.mark.parametrize("key", list(SMOKE.JAX_TIER_ERR), ids=str)
def test_jax_tier_error_behind_the_card_bound(key):
    """``chip_smoke.py`` holds K1b and K2b against float64 to 3x the error
    of the JAX package's tier on the same data (where no fixed bound is
    set); this measures that error in interpret mode and pins the
    script's constant to within a factor of 2 above it. The HIGGS entries
    are measured at n = 1024 of the recipe the card runs at n = 100,000."""
    data, cd, form, which = key
    if data == "ragged":
        A1, A2, W, S = SMOKE.ragged_data()
        kind, ls, c, k = which, 1.3, 0.9, 7
        X2, V = (A2, W) if form == "gen" else (A1, S)
    else:
        A1, _ = SMOKE.synthetic_higgs(1024)
        kind, ls, c, k = "rbf", D**0.5, 1.0, which
        X2 = A1
        V = np.random.default_rng(3).standard_normal((1024, k)).astype(np.float32)
    if form == "gen":
        got = kernel_matmat_pallas(
            kind, jnp.asarray(A1), jnp.asarray(X2), jnp.asarray(V), ls, c,
            compute_dtype=cd, interpret=True,
        )
    else:
        got = kernel_matvec_symmetric(
            kind, jnp.asarray(A1), jnp.asarray(V), ls, c, compute_dtype=cd,
            interpret=True,
        )
    err = _rel(got, _f64_ref(kind, A1, X2, V, ls, c))
    const = SMOKE.JAX_TIER_ERR[key]
    assert const / 2 <= err <= const


@pytest.mark.parametrize("cd", TIERS)
def test_oracles_gather_the_parents_tier_parts(cd, monkeypatch):
    """The row and block oracles of a tier operator take the rows of the
    operator's parts, and split nothing anew (SAP calls the row oracle every
    iteration; a split of all of X2 there is O(n·d) work a step). The split
    is point by point, so the gathered parts are the parts of the gathered
    points: the oracles' products equal those of operators built on the
    gathered points exactly, and the row oracle's equals the operator's
    apply restricted to ``blk`` to the float32 order of the triangle's sums
    (2e-6 of max|ref|; k = 2, below the tier-matched mirror of k ≥ 3)."""
    import rlaopt_tpu_torch.kernels.linop as linop
    from rlaopt_tpu_torch.kernels import KernelConfig, KernelLinOp, RBFLinOp

    rng = np.random.default_rng(31)
    X = torch.from_numpy(rng.standard_normal((300, D)).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((300, 2)).astype(np.float32))
    cfg = KernelConfig(lengthscale=LS)
    K = RBFLinOp(X, X, cfg, compute_dtype=cd)
    splits = []
    real = linop.tier_operand
    monkeypatch.setattr(linop, "tier_operand", lambda *a: splits.append(1) or real(*a))
    blk = torch.from_numpy(rng.choice(300, 70, replace=False))
    R, Bk = K.row_oracle(blk), K.blk_oracle(blk)
    assert splits == []
    assert R._tier[1] is K._tier[1]
    got = R @ W
    assert torch.equal(got, KernelLinOp(X[blk], X, cfg, "rbf", cd) @ W)
    assert torch.equal(Bk @ W[blk], KernelLinOp(X[blk], X[blk], cfg, "rbf", cd) @ W[blk])
    assert len(splits) == 4  # the two reference operators split both their sides
    assert _rel(got, (K @ W)[blk]) <= 2e-6
