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

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.ops.kernel_pallas import (
    kernel_matmat_pallas,
    kernel_matvec_symmetric,
    kernel_pair_matmat,
)
from rlaopt_tpu_torch.ops import kernel_plain, kernel_tiers
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


def _worst(got, ref) -> str:
    """Both sides at the entry where they differ most, and the max|.| of
    each side: which of the two went wrong when a comparison fails."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    at = np.unravel_index(np.abs(got - ref).argmax(), got.shape)
    return (f"worst entry {tuple(int(i) for i in at)}: port {float(got[at])!r}, JAX "
            f"{float(ref[at])!r}; max|port| {float(np.abs(got).max())!r}, max|JAX| "
            f"{float(np.abs(ref).max())!r}")


def _points(seed, n, m, k):
    rng = np.random.default_rng(seed)
    X1 = rng.standard_normal((n, D)).astype(np.float32)
    X2 = rng.standard_normal((m, D)).astype(np.float32)
    V = rng.standard_normal((m, k)).astype(np.float32)
    return X1, X2, V


def _parts(X, cd):
    return tier_operand(torch.from_numpy(X) / LS, cd)


def _matmat_case(cd, kind, k):
    """The plain K1b against the JAX tier in interpret mode on one case:
    ``(rel, rel_f32)``, the second (the plain version's kernel values with a
    float32 contraction) for the one-pass tier past 16 columns only."""
    X1, X2, V = _points(k, N, M, k)
    ref = kernel_matmat_pallas(
        kind, jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(V), LS, C,
        compute_dtype=cd, interpret=True,
    )
    A, B = _parts(X1, cd), _parts(X2, cd)
    got = kernel_plain.gram_matmat_tier(kind, A, B, torch.from_numpy(V), C)
    rel_f32 = None
    if k > 16 and cd == "bfloat16":
        Kv = kernel_plain._tier_values(kind, A, B)
        rel_f32 = _rel(kernel_plain.tier_contract(Kv, torch.from_numpy(V), "f32") * C, ref)
    return _rel(got, ref), rel_f32


MATMAT_CASES = [(cd, kind, k) for k in (1, 7, 20) for kind in ("rbf", "matern32")
                for cd in TIERS]

# Runs _matmat_case on every case in a fresh interpreter: JAX on the CPU with
# the settings of tests/conftest.py, float64 enabled, and no persistent
# compilation cache.
_CASES_SCRIPT = """
import json, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")
sys.path.insert(0, sys.argv[1])
from tests import test_torch_tiers as T
print(json.dumps([T._matmat_case(*case) for case in T.MATMAT_CASES]))
"""


@pytest.fixture(scope="module")
def matmat_errors():
    """Each case's errors, computed in a process of their own, so that they
    depend on nothing an earlier test of the worker left behind (threads,
    compiled code) and on no entry of the persistent JAX compilation cache
    that ``tests/conftest.py`` shares between workers and runs."""
    env = {key: val for key, val in os.environ.items() if not key.startswith("JAX_COMPILATION")}
    env["JAX_PLATFORMS"] = "cpu"
    done = subprocess.run([sys.executable, "-c", _CASES_SCRIPT, REPO], capture_output=True,
                          text=True, env=env, timeout=900, check=False)
    assert done.returncode == 0, done.stderr[-4000:]
    return dict(zip(MATMAT_CASES, json.loads(done.stdout.strip().splitlines()[-1])))


# Config 9's row oracle in small: RBF, X = N(0, 1)/sqrt(50), k = 10.
SPLIT_N, SPLIT_M, SPLIT_D, SPLIT_K = 128, 1024, 50, 10


# (tier, d, k) where the JAX package's forward dispatch is held against
# ``kernel_tiers.forward_contraction``: the split at config 9's width and
# up to d = 80, float32 at 8 columns, past its fold (d = 90) and on the
# one-pass tier.
DISPATCH_CASES = [("bf16x3", 50, 10), ("bf16x3", 50, 8), ("bf16x3", 28, 16), ("bf16x3", 80, 12),
                  ("bf16x3", 90, 12), ("bfloat16", 50, 10)]


def _dispatch_case(cd, d, k):
    """Whether the JAX package's forward kernel with its own contraction
    gives the bits it gives with the one ``forward_contraction`` names for
    the port (``"vpu"`` for float32), on 128 x 1024 points."""
    from rlaopt_tpu_torch.ops.kernel_tiers import forward_contraction

    rng = np.random.default_rng(d + k)
    X1, X2 = ((rng.standard_normal((n, d)) / d**0.5).astype(np.float32) for n in (128, 1024))
    V = rng.standard_normal((1024, k)).astype(np.float32)
    mode = forward_contraction(k, -(-d // 16) * 16, 3 if cd == "bf16x3" else 1)
    own, named = (np.asarray(kernel_matmat_pallas(
        "rbf", jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(V), 1.0, 1.0, compute_dtype=cd,
        interpret=True, acc_mode=acc)) for acc in (None, {"f32": "vpu"}.get(mode, mode)))
    return bool(np.array_equal(own, named))


def _split_case():
    """The JAX package's bf16x3 forward kernel in interpret mode with its
    tier-matched contraction (``acc_mode="split"``) and with the float32 one
    (``"vpu"``), each against the float64 product, the port's plain version
    (whose contraction at this shape is the split) against the first, and
    :func:`_dispatch_case` on each of ``DISPATCH_CASES``."""
    from rlaopt_tpu_torch.ops.kernel_plain import gram_matmat_f64

    rng = np.random.default_rng(SPLIT_D)
    X1, X2 = ((rng.standard_normal((n, SPLIT_D)) / SPLIT_D**0.5).astype(np.float32)
              for n in (SPLIT_N, SPLIT_M))
    V = rng.standard_normal((SPLIT_M, SPLIT_K)).astype(np.float32)
    ref = gram_matmat_f64("rbf", torch.from_numpy(X1), torch.from_numpy(X2),
                          torch.from_numpy(V).double(), 1.0, 1.0)
    out = {}
    for mode in ("split", "vpu"):
        got = kernel_matmat_pallas("rbf", jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(V), 1.0,
                                   1.0, compute_dtype="bf16x3", interpret=True, acc_mode=mode)
        out[mode] = _rel(got, ref)
        if mode == "split":
            split = got
    A, B = (tier_operand(torch.from_numpy(X), "bf16x3") for X in (X1, X2))
    plain = kernel_plain.gram_matmat_tier("rbf", A, B, torch.from_numpy(V), 1.0)
    out["plain"] = _rel(plain, split)
    out["dispatch"] = [_dispatch_case(*case) for case in DISPATCH_CASES]
    return out


_SPLIT_SCRIPT = _CASES_SCRIPT.replace(
    "[T._matmat_case(*case) for case in T.MATMAT_CASES]", "T._split_case()")


@pytest.fixture(scope="module")
def split_errors():
    """:func:`_split_case` in a process of its own, as :func:`matmat_errors`."""
    env = {key: val for key, val in os.environ.items() if not key.startswith("JAX_COMPILATION")}
    env["JAX_PLATFORMS"] = "cpu"
    done = subprocess.run([sys.executable, "-c", _SPLIT_SCRIPT, REPO], capture_output=True,
                          text=True, env=env, timeout=900, check=False)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_jax_split_contraction_within_the_tier_bound(split_errors):
    """The error budget K1b inherits where its contraction is tier-matched
    (hi·hi + hi·lo + lo·hi of the values' and W's bf16 parts), the JAX
    package's ``acc_mode="split"``. At config 9's
    width (d = 50, k = 10) that forward product stays within the bf16x3
    tier's bound against float64 (``chip_smoke.py``'s ``BF16X3_F64_BOUND``,
    which holds K1b on the card), as the float32 contraction does (the
    split's error, measured 7.0e-6 of max|ref|, is the tier's: the bf16 hi
    and lo of values and W leave 2⁻¹⁷ of each product, which sums with the
    products' signs as the products do; the float32 contraction's is
    ~1e-6), and the port's plain version of the kernel meets it at the
    parity of the split contraction past 16 columns
    (:func:`test_plain_tier_matmat_matches_pallas`: 3e-6)."""
    assert split_errors["split"] <= SMOKE.BF16X3_F64_BOUND
    assert split_errors["vpu"] <= SMOKE.BF16X3_F64_BOUND
    assert split_errors["plain"] <= 3e-6


@pytest.mark.parametrize("case", range(len(DISPATCH_CASES)))
def test_forward_contraction_is_the_jax_dispatch(case, split_errors):
    """K1b's contraction (``kernel_tiers.forward_contraction``, on the card
    and in the plain version) is the one the JAX package's forward kernel
    picks for the shape: its default output is bit for bit its output with
    that contraction named."""
    assert split_errors["dispatch"][case], DISPATCH_CASES[case]


@pytest.mark.parametrize("cd", TIERS)
@pytest.mark.parametrize("kind", ["rbf", "matern32"])
@pytest.mark.parametrize("k", [1, 7, 20])
def test_plain_tier_matmat_matches_pallas(cd, kind, k, matmat_errors):
    rel, rel_f32 = matmat_errors[(cd, kind, k)]
    if k <= 16:
        assert rel <= 1e-6
    elif cd == "bf16x3":
        assert rel <= 3e-6
    else:
        # The one-pass "fast" contraction is a DEFAULT-precision dot in the
        # JAX kernel: one bf16 pass on the TPU, full float32 in the CPU
        # interpreter. The port's plain version rounds K and V to bf16 as the
        # TPU does, 2.9e-3 of max|ref| from the interpreter (2^-8 per
        # product); with a float32 contraction its kernel values meet the
        # JAX kernel's at the float32 bound.
        assert rel <= 2.0**-7
        assert rel_f32 <= 1e-6


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
    assert _rel(got, ref) <= (3e-6 if cd == "bf16x3" and k == 3 else 1e-6), _worst(got, ref)


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
    """``chip_smoke.py`` holds K1b, K2b and K4b against float64 to 3x the
    error of the JAX package's tier on the same data (where no fixed bound
    is set); this measures that error in interpret mode and pins the
    script's constant to within a factor of 2 above it. The HIGGS entries
    are measured at n = 1024 of the recipe the card runs at n = 100,000;
    the pair entries are the largest error of both outputs at k = 1 and 3
    (the pair check's k = 16 errs less on this data: 2.1e-5 of the bound's
    2.8e-5 at most, measured alike)."""
    data, cd, form, which = key
    if form == "pair":
        A1, A2, _, _ = SMOKE.ragged_data()
        errs = []
        for k in (1, 3):
            V2, V1 = SMOKE.pair_ragged_rhs(k)
            got = kernel_pair_matmat(
                which, *(jnp.asarray(a) for a in (A1, A2, V2, V1)), 1.3, 0.9,
                compute_dtype=cd, interpret=True,
            )
            errs += [_rel(got[0], _f64_ref(which, A1, A2, V2, 1.3, 0.9)),
                     _rel(got[1], _f64_ref(which, A2, A1, V1, 1.3, 0.9))]
        const = SMOKE.JAX_TIER_ERR[key]
        assert const / 2 <= max(errs) <= const
        return
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
    import rlaopt_tpu_torch.ops.kernel_dispatch as dispatch
    from rlaopt_tpu_torch.kernels import KernelConfig, KernelLinOp, RBFLinOp

    rng = np.random.default_rng(31)
    X = torch.from_numpy(rng.standard_normal((300, D)).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((300, 2)).astype(np.float32))
    cfg = KernelConfig(lengthscale=LS)
    K = RBFLinOp(X, X, cfg, compute_dtype=cd)
    splits = []
    real = dispatch.tier_operand
    monkeypatch.setattr(dispatch, "tier_operand", lambda *a: splits.append(1) or real(*a))
    blk = torch.from_numpy(rng.choice(300, 70, replace=False))
    R, Bk = K.row_oracle(blk), K.blk_oracle(blk)
    assert splits == []
    assert R._points[1] is K._points[1] and R._points[1].tier is not None
    got = R @ W
    assert torch.equal(got, KernelLinOp(X[blk], X, cfg, "rbf", compute_dtype=cd) @ W)
    assert torch.equal(Bk @ W[blk], KernelLinOp(X[blk], X[blk], cfg, "rbf", compute_dtype=cd) @ W[blk])
    assert len(splits) == 4  # the two reference operators split both their sides
    assert _rel(got, (K @ W)[blk]) <= 2e-6


@pytest.mark.parametrize("name,group", [
    ("tile_triangle<0, 1>(float const*, float const*, float*, int)", "gram_matvec_symmetric"),
    ("tile_pair<0, 1>(float const*, float const*, float const*, float const*, float*, float*, "
     "int)", "gram_pair"),
    ("tile_pair<4, 1>(float const*, float const*, float const*)", "gram_pair"),
    ("tile_triangle<4, 8>(float const*, float const*, float*, int)", "gram_matvec_symmetric"),
    ("tile_triangle<1, 2>(float const*)", "gram_matvec_symmetric"),
    ("tile_pair<1, 16>(float const*, float const*)", "gram_pair"),
    ("tile_pair<4, 4>(float const*)", "gram_pair"),
    ("gram_tier_pair<0, 3, 1>(GramArgs, int)", "gram_pair_tier"),
    ("gram_tier_pair<3, 1, 16>(GramArgs, int)", "gram_pair_tier"),
    ("gram_comp_symmetric<0, 2, float>(double const*, float const*, double*, int, int, int, "
     "int, int)", "gram_matvec_symmetric_comp"),
    ("gram_comp_finish<float>(double*, float*, float*, unsigned long, double)",
     "gram_matvec_symmetric_comp"),
    ("gram_comp_symmetric<0, 1, double>(double const*, double const*, double*, int, int, int, "
     "int, int)", "gram_matvec_symmetric_f64"),
    ("gram_comp_symmetric<4, 4, double>(double const*, double const*)",
     "gram_matvec_symmetric_f64"),
    ("gram_comp_finish<double>(double*, float*, float*, unsigned long, double)",
     "gram_matvec_symmetric_f64"),
    ("gram_matmat_narrow<0, 1, 1>(GramArgs)", "gram_matmat_comp"),
    ("gram_matmat_narrow<4, 16, 1>(GramArgs)", "gram_matmat_comp"),
    ("gram_matmat_narrow<2, 8, 2>(GramArgs)", "gram_matmat_f64"),
    ("gram_comp_forward<0, 16, float>(CompArgs)", "gram_matmat_comp"),
    ("gram_comp_forward<3, 16, float>(CompArgs)", "gram_matmat_comp"),
    ("gram_comp_forward<4, 16, float>(CompArgs)", "gram_matmat_comp"),
    ("gram_comp_forward<0, 16, double>(CompArgs)", "gram_matmat_f64"),
    ("gram_comp_forward<4, 16, double>(CompArgs)", "gram_matmat_f64"),
    ("gram_comp_pair<0, 1, float>(CompArgs)", "gram_pair_comp"),
    ("gram_comp_pair<4, 4, float>(CompArgs)", "gram_pair_comp"),
    ("gram_comp_pair<1, 2, double>(CompArgs)", "gram_pair_f64"),
    ("gram_comp_symmetric<4, 4, float>(CompArgs)", "gram_matvec_symmetric_comp"),
    ("gram_comp_symmetric<0, 1, double>(CompArgs)", "gram_matvec_symmetric_f64"),
    ("gram_comp_finish<float, 0>(double const*, int, unsigned long, double, void*, float*)",
     "gram_matvec_symmetric_comp"),
    ("gram_comp_finish<double, 0>(double const*, int, unsigned long, double, void*, float*)",
     "gram_matvec_symmetric_f64"),
    ("gram_comp_finish<float, 1>(double const*, int, unsigned long, double, void*, float*)",
     "gram_matmat_comp"),
    ("gram_comp_finish<double, 1>(double const*, int, unsigned long, double, void*, float*)",
     "gram_matmat_f64"),
    ("gram_comp_finish<float, 2>(double const*, int, unsigned long, double, void*, float*)",
     "gram_pair_comp"),
    ("gram_comp_finish<double, 2>(double const*, int, unsigned long, double, void*, float*)",
     "gram_pair_f64"),
    ("gram_wide_tf32<4, 16, 2>(float const*, float const*, float4 const*, float*)",
     "gram_matmat"),
    ("gram_tier_symmetric<0, 3, 1>(GramArgs, int)", "gram_matvec_symmetric_tier"),
    ("gram_tier_symmetric<3, 1, 16>(GramArgs, int)", "gram_matvec_symmetric_tier"),
    ("gram_tier_symmetric<0, 3, 1, 32>(GramArgs, int, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st)", "gram_matvec_symmetric_tier"),
    ("gram_tier_symmetric<2, 1, 2, 64>(GramArgs, int, CUtensorMap_st)",
     "gram_matvec_symmetric_tier"),
    ("gram_tier_triangle<0, 3, 4>(GramArgs, int)", "gram_matvec_symmetric_tier"),
    ("gram_tier_triangle<3, 1, 16>(GramArgs, int)", "gram_matvec_symmetric_tier"),
    ("gram_tier_forward<0, 3, 1>(GramArgs, int)", "gram_matmat_tier"),
    ("gram_tier_forward<2, 1, 16>(GramArgs, int)", "gram_matmat_tier"),
    ("gram_tier_wide<1, 3, 16>(GramArgs, int)", "gram_matmat_tier"),
    ("gram_tier_rows<0, 3, 128, 64, 1, 2>(GramArgs, int, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st)",
     "gram_matmat_tier"),
    ("gram_tier_rows<3, 1, 64, 64, 2, 1>(GramArgs, int, CUtensorMap_st)", "gram_matmat_tier"),
    ("gram_comp_symmetric<0, 1>(double const*, float const*, double*, int, int, int, int, int)",
     "gram_matvec_symmetric_comp"),
    ("gram_comp_finish(double const*, float*, float*, unsigned long, double)",
     "gram_matvec_symmetric_comp"),
    ("csr_spmm_lanes<float, 1, 4>(long const*, int const*)", "csr_spmm"),
    ("csr_spmm_wide<float, 1, 8>(long const*, long const*)", "csr_spmm"),
    ("csr_spmm_sum_segments<double>(double const*, long const*)", "csr_spmm"),
    ("laplace_triangle<16>(float const*, float const*, float*, int)",
     "gram_matvec_symmetric"),
    ("tile_forward<0, 1>(float const*, float const*, float const*, float*, float*, int)",
     "gram_matmat"),
    ("tile_forward<4, 16>(float const*)", "gram_matmat"),
    ("tile_triangle<3, 8>(float const*, float const*, float*, int)", "gram_matvec_symmetric"),
    ("tile_triangle<4, 1>(float const*)", "gram_matvec_symmetric"),
    ("gram_wide_tf32<2, 16, 2>(float const*, float const*, float4 const*, float*)",
     "gram_matmat"),
    ("gram_wide_ws<0, 128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float*, int, int, int, int, int, double)", "gram_matmat"),
    ("gram_wide_ws<4, 64>(CUtensorMap_st)", "gram_matmat"),
])
def test_profile_groups_each_kernel_template(name, group):
    """``chip_smoke.py`` names each Gram kernel in a profile by its
    template arguments (family, the narrow kernel's mode last, as older
    profiles name it; the float64 tile's form, family and V type, its
    finishing pass's form last), as demangled in the
    device events. The register tile's forms and the 3xTF32 wide kernel go
    to the one wrapper of every family (K4 and K6 are the tile's pair form,
    K1 and K3 past 16 columns the wide kernel), as the float64 tile's
    forms do; K3's tile under the names of earlier builds
    (``laplace_triangle``) is grouped the same."""
    assert SMOKE._kernel_group("void (anonymous namespace)::" + name) == group


def test_registers_of_tells_the_float64_triangles_apart():
    """``chip_smoke.registers_of`` gives each wrapper the ``-Xptxas -v``
    entries of its own kernels: the float64 triangle's instantiations go to
    K7 where V is double and to the triangle K1c where it is float, by the
    same rule as the profile's groups."""
    reg = {"gram_comp_symmetric<0,1,f>": {"registers": 255},
           "gram_comp_symmetric<4,16,f>": {"registers": 255},
           "gram_comp_symmetric<0,4,d>": {"registers": 254},
           "gram_tier_pair<0,3,1>": {"registers": 128}}
    assert set(SMOKE.registers_of("gram_matvec_symmetric_f64", reg)) == {
        "gram_comp_symmetric<0,4,d>"}
    assert set(SMOKE.registers_of("gram_matvec_symmetric_comp", reg)) == {
        "gram_comp_symmetric<0,1,f>", "gram_comp_symmetric<4,16,f>"}
    assert set(SMOKE.registers_of("gram_pair_tier", reg)) == {"gram_tier_pair<0,3,1>"}
    assert SMOKE.registers_of("gram_matmat", reg) == {}


def test_registers_of_the_float64_forms():
    """``chip_smoke.registers_of`` gives the float64 tile's forward and pair
    forms to their wrappers: the forward form by V's type (K8 where V is
    double, K1c and K3c, the Laplace family's, otherwise), the pair by V's
    type; the triangle's stay with K7 and the triangle K1c."""
    reg = {"gram_comp_forward<0,16,f>": {"registers": 200},
           "gram_comp_forward<4,16,f>": {"registers": 198},
           "gram_comp_forward<2,16,d>": {"registers": 210},
           "gram_comp_pair<1,4,f>": {"registers": 255},
           "gram_comp_pair<4,1,d>": {"registers": 255},
           "gram_comp_symmetric<0,1,f>": {"registers": 255}}
    assert set(SMOKE.registers_of("gram_matmat_comp", reg)) == {"gram_comp_forward<0,16,f>",
                                                                "gram_comp_forward<4,16,f>"}
    assert set(SMOKE.registers_of("gram_matmat_f64", reg)) == {"gram_comp_forward<2,16,d>"}
    assert set(SMOKE.registers_of("gram_pair_comp", reg)) == {"gram_comp_pair<1,4,f>"}
    assert set(SMOKE.registers_of("gram_pair_f64", reg)) == {"gram_comp_pair<4,1,d>"}
    assert set(SMOKE.registers_of("gram_matvec_symmetric_comp", reg)) == {
        "gram_comp_symmetric<0,1,f>"}
    names = SMOKE.ptxas_report(
        "Compiling entry function '_ZN12_GLOBAL__N_117gram_comp_forwardILi4ELi16EfEEvNS_8CompArgsE'"
        " for 'sm_90a'\n    0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 198 registers\n", SMOKE.REDESIGNED)
    assert names == {"gram_comp_forward<4,16,f>": {"spill_stores": 0, "spill_loads": 0,
                                                   "registers": 198}}


@pytest.mark.parametrize("kernel,n,m,k,kind,ops,nbytes", [
    # the forward form: each of n·m values once in float64 (3 operations a
    # feature, 2 for Laplace's L1, 1 for the exponential), 2k of contraction
    ("gram_matmat_comp", 12_500, 12_500, 1, "rbf", 12_500**2 * (3 * 28 + 1 + 2),
     4 * 25_000 * 28 + 4 * 12_500 + 8 * 12_500),
    ("gram_matmat_comp", 33_334, 33_334, 1, "laplace", 33_334**2 * (2 * 28 + 1 + 2),
     4 * 66_668 * 28 + 4 * 33_334 + 8 * 33_334),
    ("gram_matmat_f64", 8_192, 1_000_000, 1, "rbf", 8_192e6 * (3 * 28 + 1 + 2),
     4 * 1_008_192 * 28 + 8 * 1_000_000 + 8 * 8_192),
    # the pairs: 4k of contraction, V1 read and out2 written (float64 sums)
    ("gram_pair_comp", 12_500, 12_500, 1, "rbf", 12_500**2 * (3 * 28 + 1 + 4),
     4 * 25_000 * 28 + 2 * 4 * 12_500 + 2 * 8 * 12_500),
    ("gram_pair_f64", 12_500, 12_500, 10, "rbf", 12_500**2 * (3 * 28 + 1 + 40),
     4 * 25_000 * 28 + 2 * 8 * 125_000 + 2 * 8 * 125_000),
    ("gram_pair_comp", 33_334, 33_334, 1, "laplace", 33_334**2 * (2 * 28 + 1 + 4),
     4 * 66_668 * 28 + 2 * 4 * 33_334 + 2 * 8 * 33_334),
])
def test_bound_ms_of_the_float64_forms(kernel, n, m, k, kind, ops, nbytes):
    """``chip_smoke.bound_ms`` of the float64 tile's forward form and the
    certified pairs: their operations on the FP64 units (34 TFLOP/s),
    bound by operations at these shapes (their bytes: the float32 points,
    V of 4 or 8 bytes an entry, the outputs 8 bytes an entry, and for the
    pairs V1 read and out2 written, well under). At one row against 10⁶
    with d = 1 the same count of bytes bounds them."""
    assert kernel in SMOKE.COMP_KERNELS + SMOKE.F64_KERNELS
    got, by = SMOKE.bound_ms(kernel, n, m, 28, k, kind)
    assert by == "operations" and got == pytest.approx(ops / SMOKE.PEAK["fp64"] * 1e3)
    assert nbytes / SMOKE.HBM_BYTES_PER_S * 1e3 < got
    vb = 8 if kernel in SMOKE.F64_KERNELS else 4
    pair = kernel in SMOKE.PAIR_KERNELS
    few = 4 * (1 + 10**6) + vb * 10**6 * k + 8 * k + (vb * k + 8 * 10**6 * k if pair else 0)
    got, by = SMOKE.bound_ms(kernel, 1, 10**6, 1, k, kind)
    assert by == "bytes" and got == pytest.approx(few / SMOKE.HBM_BYTES_PER_S * 1e3)


def test_registers_of_gives_k1_both_wide_kernels():
    """``gram_matmat`` (K1 and K3) is given the ``-Xptxas -v`` entries of
    both kernels past 16 columns, the warpgroup form and the ``mma.sync``
    one, in every family; no other wrapper is."""
    reg = {"gram_wide_ws<0,128>": {"registers": 224}, "gram_wide_ws<4,64>": {"registers": 200},
           "gram_wide_tf32<1,16,2>": {"registers": 255}}
    assert set(SMOKE.registers_of("gram_matmat", reg)) == set(reg)
    assert SMOKE.registers_of("gram_matmat_tier", reg) == {}
    assert SMOKE.registers_of("gram_pair", reg) == {}


def test_registers_of_the_laplace_tile_forms_and_the_csr_schedules():
    """The register tile is one body in two kernels (forward, triangle),
    instantiated for Laplace (K3, K5) and the squared-distance families
    (K1, K2): each wrapper, which takes every family, is given its form's
    instantiations of every family; K1 also its wide kernel. ``csr_spmm`` gets
    the short-row, wide and segment-sum kernels of #9's schedules,
    ``csr_spmv`` the short-row kernel it runs at k = 1."""
    reg = {"tile_forward<4,1>": {"registers": 128}, "tile_triangle<4,16>": {"registers": 128},
           "tile_forward<0,16>": {"registers": 128}, "tile_triangle<3,2>": {"registers": 128},
           "gram_wide_tf32<1,16,2>": {"registers": 255},
           "csr_spmm_lanes<f,1,4>": {"registers": 40}, "csr_spmm_wide<f,1,8>": {"registers": 48},
           "csr_spmm_sum_segments<d>": {"registers": 32}}
    assert set(SMOKE.registers_of("gram_matmat", reg)) == {
        "tile_forward<4,1>", "tile_forward<0,16>", "gram_wide_tf32<1,16,2>"}
    assert set(SMOKE.registers_of("gram_matvec_symmetric", reg)) == {"tile_triangle<4,16>",
                                                                     "tile_triangle<3,2>"}
    assert set(SMOKE.registers_of("csr_spmm", reg)) == {
        "csr_spmm_lanes<f,1,4>", "csr_spmm_wide<f,1,8>", "csr_spmm_sum_segments<d>"}
    assert set(SMOKE.registers_of("csr_spmv", reg)) == {"csr_spmm_lanes<f,1,4>"}
    names = SMOKE.ptxas_report(
        "Compiling entry function '_ZN12_GLOBAL__N_113tile_triangleILi4ELi16EEEvPKfS2_Pfiiiiid'"
        " for 'sm_90a'\n    4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 128 registers\n", SMOKE.REDESIGNED)
    assert names == {"tile_triangle<4,16>": {"spill_stores": 4, "spill_loads": 8,
                                             "registers": 128}}


def test_ptxas_report_reads_the_kernel_not_its_files_namespace():
    """The warpgroup form's translation unit names its anonymous namespace
    after the file (``_gram_wide_ws_cu_``): ``ptxas_report`` reads the
    kernel's template arguments from the kernel's own (length-prefixed)
    name and leaves the file's ``sum_splits`` out."""
    log = ("Compiling entry function '_ZN48_GLOBAL__N__0d3a753c_15_gram_wide_ws_cu_80454602"
           "12gram_wide_wsILi4ELi168EEEv14CUtensorMap_stS1_S1_S1_Pfiiiiid' for 'sm_90a'\n"
           "    16 bytes spill stores, 16 bytes spill loads\nptxas info    : Used 168 registers\n"
           "Compiling entry function '_ZN48_GLOBAL__N__0d3a753c_15_gram_wide_ws_cu_80454602"
           "10sum_splitsEPKfPfimd' for 'sm_90a'\nptxas info    : Used 32 registers\n")
    assert SMOKE.ptxas_report(log, SMOKE.REDESIGNED) == {
        "gram_wide_ws<4,168>": {"spill_stores": 16, "spill_loads": 16, "registers": 168}}


def test_reround_steps_tell_a_rounding_flip_from_a_fault():
    """``chip_smoke.reround_steps`` on a one-pass mirror ``c·bf16(K)ᵀ @
    bf16(V)``: where a kernel value one float32 ulp from a bf16 rounding
    boundary rounds the other way, the largest error is that one step and
    nothing remains; an error of another size leaves itself; no error
    leaves none. ``reround_bound`` is two of the largest steps over
    max|ref|."""
    rng = np.random.default_rng(3)
    K = torch.from_numpy(rng.uniform(0.1, 0.9, (40, 6)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    c = 0.9
    mid = torch.tensor(0.5 + 2.0**-9)  # halfway between bf16 0.5 and 0.50390625
    K[7, 2] = torch.nextafter(mid, torch.tensor(0.0))  # rounds down to 0.5
    ref = c * (K.bfloat16().float().T @ V.bfloat16().float())
    flipped = ref.clone()
    flipped[2] += c * 2.0**-8 * V[7].bfloat16().float()  # rounded up instead
    scale = ref.abs().max().item()
    e, steps, rest = SMOKE.reround_steps(K, V, flipped, ref, c)
    assert rest <= 1e-6 and abs(steps) > 1e-4
    assert abs(e) * scale == pytest.approx(c * 2.0**-8 * V[7].abs().max().item(), rel=1e-2)
    fault = ref.clone()
    fault[4, 1] += 0.1
    e, steps, rest = SMOKE.reround_steps(K, V, fault, ref, c)
    assert rest == pytest.approx(0.1 / scale, rel=1e-3) and steps == 0.0
    assert SMOKE.reround_steps(K, V, ref, ref, c) == (0.0, 0.0, 0.0)
    assert SMOKE.reround_bound(V, ref, c) == pytest.approx(
        2 * c * 2.0**-8 * V.abs().max().item() / scale)


def test_bound_of_the_triangle_k1c():
    """``chip_smoke.bound_ms`` counts the triangle K1c
    (``gram_matvec_symmetric_comp``, one of ``COMP_KERNELS``) as n²/2
    float64 values, each contracted both ways, with the float32 pair written
    out: half the general K1c's value work at the same n."""
    n, d = 100_000, 28
    assert "gram_matvec_symmetric_comp" in SMOKE.COMP_KERNELS
    ms, by = SMOKE.bound_ms("gram_matvec_symmetric_comp", n, n, d, 1)
    assert by == "operations"
    assert ms == pytest.approx((n * n / 2 * (3 * d + 1) + 2 * n * n) / SMOKE.PEAK["fp64"] * 1e3)
    general, _ = SMOKE.bound_ms("gram_matmat_comp", n, n, d, 1)
    assert general == pytest.approx((n * n * (3 * d + 1) + 2 * n * n) / SMOKE.PEAK["fp64"] * 1e3)
    assert SMOKE.PEAK["fp64_tc"] == 67e12  # the FP64 tensor cores: used by no kernel yet


def test_bound_counts_the_exponential_on_the_sfu():
    """``chip_smoke.bound_ms`` counts one SFU operation per kernel value for
    the float32 exponential (two for Matérn, whose square root also goes
    there), at 16 a clock per SM: K2b at the HIGGS shape is bound by it
    (5e9 values in 1.196 ms, above the 0.849 ms of its tensor-core
    passes), the float32 K2 by its distance arithmetic as before, and the
    float64-tile kernels take their exponential in float64."""
    n, d = 100_000, 28
    values = n * n / 2
    sfu = SMOKE.PEAK["sfu"]
    assert sfu == 16 * 132 * 1.98e9
    ms, by = SMOKE.bound_ms("gram_matvec_symmetric_tier", n, n, d, 1, "rbf", "bf16x3")
    assert by == "operations" and ms == pytest.approx(values / sfu * 1e3)
    ms, _ = SMOKE.bound_ms("gram_matvec_symmetric_tier", n, n, d, 1, "matern32", "bf16x3")
    assert ms == pytest.approx(2 * values / sfu * 1e3)
    ms, _ = SMOKE.bound_ms("gram_matvec_symmetric", n, n, d, 1)
    assert ms == pytest.approx((values * 3 * d + 2 * n * n) / SMOKE.PEAK["fp32"] * 1e3)
    ms, _ = SMOKE.bound_ms("gram_matvec_symmetric_f64", n, n, d, 1)
    assert ms == pytest.approx((values * (3 * d + 1) + 2 * n * n) / SMOKE.PEAK["fp64"] * 1e3)


class _K2bEntry:
    """K2b's C entry emulated on the host with the arguments of its ctypes
    signature: it writes the plain version of the tier into ``out`` (read
    through the pointers) and records each call."""

    def __init__(self, P, c):
        self.P, self.c, self.calls = P, c, []

    def rl_gram_matvec_symmetric_tier(self, *args):
        from rlaopt_tpu_torch.ops import kernel_cuda

        assert len(args) == len(kernel_cuda._SIGNATURES["rl_gram_matvec_symmetric_tier"])
        code, passes, xh, xl, hx, v, out, n, dp, k, c, _s = args
        assert (xh, xl, passes) == (self.P.hi.data_ptr(), kernel_cuda._ptr(self.P.lo),
                                    self.P.passes)
        V = torch.from_numpy(np.ctypeslib.as_array(
            ctypes.cast(v, ctypes.POINTER(ctypes.c_float)), shape=(n, k)).copy())
        kind = {code: kind for kind, code in kernel_cuda.KIND_CODES.items()}[code]
        ref = kernel_plain.gram_matvec_symmetric_tier(kind, self.P, V, c)
        np.ctypeslib.as_array(ctypes.cast(out, ctypes.POINTER(ctypes.c_float)),
                              shape=(n, k))[:] = ref.numpy()
        self.calls.append({"n": n, "dp": dp, "k": k, "c": c})
        return 0


@pytest.mark.parametrize("d,k,route", [
    (28, 1, "warpgroup"), (28, 2, "warpgroup"), (28, 3, "strip"), (28, 10, "strip"),
    (28, 16, "strip"), (128, 1, "warpgroup"), (129, 1, "strip"), (129, 2, "strip"),
    (10, 2, "warpgroup"), (28, 17, None), (28, 0, None),
])
def test_k2b_wrapper_contract_and_route(d, k, route, monkeypatch):
    """``kernel_cuda.gram_matvec_symmetric_tier`` down to its emulated C
    entry: the operands and shapes it hands over, k ≤ 16 (a wider or an empty
    V raises before any launch), and the route ``symmetric_tier_route`` picks
    by k and the padded depth alone (the warp-specialised kernel up to two
    columns at a depth up to 128, the strip's triangle past either), counted
    per route beside the wrapper's launches."""
    import contextlib

    from rlaopt_tpu_torch.ops import kernel_cuda

    X = np.random.default_rng(d).standard_normal((150, d)).astype(np.float32)
    P = tier_operand(torch.from_numpy(X) / d**0.5, "bf16x3")
    V = torch.from_numpy(np.random.default_rng(k).standard_normal((150, max(k, 0)))
                         .astype(np.float32))
    entry = _K2bEntry(P, C)
    monkeypatch.setattr(kernel_cuda, "_check_tensors", lambda dtypes, *ts: None)
    monkeypatch.setattr(kernel_cuda, "build", lambda: None)
    monkeypatch.setattr(kernel_cuda, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setitem(kernel_cuda._lib, "handle", entry)
    kernel_cuda.reset_launch_counts()
    if route is None:
        with pytest.raises(ValueError):
            kernel_cuda.gram_matvec_symmetric_tier("rbf", P, V, C)
        assert entry.calls == [] and kernel_cuda.launch_counts()["gram_matvec_symmetric_tier"] == 0
        return
    got = kernel_cuda.gram_matvec_symmetric_tier("rbf", P, V, C)
    dp = -(-d // 16) * 16
    assert entry.calls == [{"n": 150, "dp": dp, "k": k, "c": C}]
    assert kernel_cuda.symmetric_tier_route(k, dp) == route
    assert got.shape == (150, k)
    assert _rel(got, kernel_plain.gram_matvec_symmetric_tier("rbf", P, V, C)) == 0
    assert kernel_cuda.launch_counts()["gram_matvec_symmetric_tier"] == 1
    assert {key: n for key, n in kernel_cuda.route_counts().items()
            if key.startswith("gram_matvec_symmetric_tier.")} == {
        "gram_matvec_symmetric_tier.warpgroup": int(route == "warpgroup"),
        "gram_matvec_symmetric_tier.strip": int(route == "strip")}
    with pytest.raises(ValueError, match="does not match"):  # V's rows must match X's
        kernel_cuda.gram_matvec_symmetric_tier("rbf", P, V[:149], C)
    bad = type(P)(P.hi[:, :-1].contiguous(), P.lo[:, :-1].contiguous(), P.sq)
    with pytest.raises(ValueError, match="multiple of 16"):
        kernel_cuda.gram_matvec_symmetric_tier("rbf", bad, V, C)
    assert len(entry.calls) == 1


def _from_ptr(ptr, shape, ctype=ctypes.c_float):
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=shape)


class _K1bEntry:
    """The two C entries of ``kernel_cuda.gram_matmat_tier`` emulated on
    the CPU: the operands read through their pointers, the product computed
    from them by the plain version of the route (the warp-specialised
    kernel's contraction from W transposed: tier-matched from its bf16
    parts, or float32; the strip's and the wide kernel's through
    ``kernel_plain``)."""

    def __init__(self, A, B):
        self.A, self.B, self.calls = A, B, []

    def _kind(self, code):
        from rlaopt_tpu_torch.ops import kernel_cuda

        return {code: kind for kind, code in kernel_cuda.KIND_CODES.items()}[code]

    def rl_gram_matmat_tier_rows(self, *args):
        from rlaopt_tpu_torch.ops import kernel_cuda

        assert len(args) == len(kernel_cuda._SIGNATURES["rl_gram_matmat_tier_rows"])
        (code, passes, x1h, x1l, hx, x2h, x2l, hy, wh, wl, part, out, n, m, mpad, dp, k,
         split, splits, c, _s) = args
        assert (x1h, x1l, x2h, x2l, passes) == (
            self.A.hi.data_ptr(), kernel_cuda._ptr(self.A.lo), self.B.hi.data_ptr(),
            kernel_cuda._ptr(self.B.lo), self.A.passes)
        assert (part is None) == (splits == 1) and mpad % 8 == 0 and mpad - 8 < m <= mpad
        assert (wl is None) == (not split) and (passes == 3 or not split)

        def parts(ptr):
            bits = _from_ptr(ptr, (16, mpad), ctypes.c_uint16).astype(np.int32) << 16
            return torch.from_numpy(bits.view(np.float32).copy())

        if split:
            W = [parts(wh), parts(wl)]
        else:
            W = [torch.from_numpy(_from_ptr(wh, (16, mpad)).copy())]
        assert all(float(w[k:].abs().sum() + w[:, m:].abs().sum()) == 0 for w in W)
        kind = self._kind(code)
        vals = kernel_plain._tier_values(kind, self.A, self.B)
        if split:
            kh, kl = split_bf16(vals)
            got = kh @ W[0][:k, :m].T + kh @ W[1][:k, :m].T + kl @ W[0][:k, :m].T
        else:
            got = vals @ W[0][:k, :m].T
        _from_ptr(out, (n, k))[:] = (got * c).numpy()
        self.calls.append({"route": "warpgroup", "n": n, "m": m, "dp": dp, "k": k,
                           "splits": splits, "c": c,
                           "contraction": "split" if split else "f32"})
        return 0

    def rl_gram_matmat_tier(self, *args):
        from rlaopt_tpu_torch.ops import kernel_cuda

        assert len(args) == len(kernel_cuda._SIGNATURES["rl_gram_matmat_tier"])
        (code, passes, x1h, x1l, hx, x2h, x2l, hy, v, vh, vl, part, out, n, m, dp, k, kp,
         splits, c, _s) = args
        assert (x1h, x2h, passes) == (self.A.hi.data_ptr(), self.B.hi.data_ptr(), self.A.passes)
        assert (vh is None) == (k <= 16)
        V = torch.from_numpy(_from_ptr(v, (m, k)).copy())
        ref = kernel_plain.gram_matmat_tier(self._kind(code), self.A, self.B, V, c)
        _from_ptr(out, (n, k))[:] = ref.numpy()
        self.calls.append({"route": "wide" if k > 16 else "strip", "n": n, "m": m, "dp": dp,
                           "k": k, "splits": splits, "c": c,
                           "contraction": kernel_tiers.forward_contraction(k, dp, passes)})
        return 0


@pytest.mark.parametrize("d,k,route", [
    (28, 1, "warpgroup"), (28, 10, "warpgroup"), (50, 16, "warpgroup"), (128, 3, "warpgroup"),
    (10, 2, "warpgroup"), (18, 5, "warpgroup"), (100, 12, "warpgroup"), (129, 3, "strip"),
    (150, 16, "strip"), (28, 17, "wide"), (28, 0, None),
])
@pytest.mark.parametrize("cd", TIERS)
def test_k1b_wrapper_contract_and_route(d, k, route, cd, monkeypatch):
    """``kernel_cuda.gram_matmat_tier`` down to its emulated C entries: the
    route ``forward_tier_route`` picks by k and the padded depth alone (the
    warp-specialised kernel up to 16 columns at a depth up to 128, the
    strip's forward form past that depth, the wide kernel past 16 columns),
    the operands each entry takes (the warp-specialised kernel W transposed
    to (16, m rounded up to 8), zero past V: its bf16 parts where
    ``forward_contraction`` names the split, else float32; and the runs of
    ``tier_splits`` for its route), the plain version's product bit for
    bit, and each
    route's launches counted beside the wrapper's, in the tracing counter
    ``rlaopt.cuda.gram_matmat_tier.<route>.launches`` too."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from rlaopt_tpu_torch.ops import kernel_cuda
    from rlaopt_tpu_torch.utils import profiling

    rng = np.random.default_rng(d + k)
    A = tier_operand(torch.from_numpy(rng.standard_normal((150, d)).astype(np.float32)) / d**0.5,
                     cd)
    B = tier_operand(torch.from_numpy(rng.standard_normal((1001, d)).astype(np.float32)) / d**0.5,
                     cd)
    V = torch.from_numpy(rng.standard_normal((1001, max(k, 0))).astype(np.float32))
    entry = _K1bEntry(A, B)
    monkeypatch.setattr(kernel_cuda, "_check_tensors", lambda dtypes, *ts: None)
    monkeypatch.setattr(kernel_cuda, "build", lambda: None)
    monkeypatch.setattr(kernel_cuda, "_stream", lambda t: None)
    monkeypatch.setattr(kernel_cuda, "sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setitem(kernel_cuda._lib, "handle", entry)
    kernel_cuda.reset_launch_counts()
    if route is None:
        with pytest.raises(ValueError):
            kernel_cuda.gram_matmat_tier("rbf", A, B, V, C)
        assert entry.calls == [] and kernel_cuda.launch_counts()["gram_matmat_tier"] == 0
        return
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = kernel_cuda.gram_matmat_tier("rbf", A, B, V, C)
    dp = -(-d // 16) * 16
    splits = kernel_cuda.tier_splits(150, 1001, k, dp, 132) if k <= 16 else 1
    assert kernel_cuda.forward_tier_route(k, dp) == route
    assert entry.calls == [{"route": route, "n": 150, "m": 1001, "dp": dp, "k": k,
                            "splits": splits, "c": C,
                            "contraction": kernel_tiers.forward_contraction(k, dp, A.passes)}]
    assert got.shape == (150, k)
    ref = kernel_plain.gram_matmat_tier("rbf", A, B, V, C)
    assert _rel(got, ref) == 0
    assert kernel_cuda.launch_counts()["gram_matmat_tier"] == 1
    assert {key: n for key, n in kernel_cuda.route_counts().items()
            if key.startswith("gram_matmat_tier.")} == {
        f"gram_matmat_tier.{r}": int(r == route) for r in ("warpgroup", "strip", "wide")}
    assert profiling.counters()[f"rlaopt.cuda.gram_matmat_tier.{route}.launches"] == 1
    with pytest.raises(ValueError, match="does not match"):  # V's rows must match X2's
        kernel_cuda.gram_matmat_tier("rbf", A, B, V[:1000], C)
    assert len(entry.calls) == 1


@pytest.mark.parametrize("n,m,k,dp,runs", [
    (100_000, 10_000_000, 10, 64, 77), (10_000, 1_000_000, 10, 64, 6),
    (4_096, 10_000_000, 10, 64, 77), (100_000, 100_000, 1, 64, 1), (12_500, 100_000, 10, 16, 5),
    (150, 1001, 10, 32, 1),
])
def test_k1b_warpgroup_runs(n, m, k, dp, runs):
    """The runs of the m axis the warp-specialised kernel takes (one block
    of 128 rows an SM on 132 SMs): one where the row blocks fill two rounds
    of the card, more where they do not (config 4's 10⁴-row oracle, config
    8's 12,500 rows), and past 2²⁰ columns runs of at most 131,072 (configs 7
    and 9, and SAP's 4,096 sampled rows, at 10⁷)."""
    from rlaopt_tpu_torch.ops import kernel_cuda

    assert kernel_cuda.forward_tier_route(k, dp) == "warpgroup"
    assert kernel_cuda.tier_splits(n, m, k, dp, 132) == runs
    tiles = -(-m // 64)
    assert -(-tiles // runs) <= kernel_cuda.TIER_RUN_TILES or tiles <= kernel_cuda.TIER_LONG_TILES

