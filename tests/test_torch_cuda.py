"""The hand-written CUDA kernels (Gram products and the CSR SpMV/SpMM)
against their plain PyTorch versions (float64) on a card. Marked ``cuda``:
they skip without one. This file imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from rlaopt_tpu_torch import interop
from rlaopt_tpu_torch.models import LstSq
from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand
from rlaopt_tpu_torch.preconditioners import SkPreConfig
from rlaopt_tpu_torch.solvers import LSQRConfig
from rlaopt_tpu_torch.sparse import SparseCSRTensor
from rlaopt_tpu_torch.sparse import ops as tops

SQDIST_KINDS = ("rbf", "matern12", "matern32", "matern52")


def _data(seed, n, m, d, k):
    rng = np.random.default_rng(seed)
    X1 = rng.standard_normal((n, d)).astype(np.float32)
    X2 = rng.standard_normal((m, d)).astype(np.float32)
    V = rng.standard_normal((m, k)).astype(np.float32)
    return X1, X2, V


def _rel(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def _reround_bound(V, ref, c):
    """Bound of kernel against plain version where the one-pass tier
    re-rounds float32 kernel values to bf16: where the two values differ in
    their last float bit across a bf16 rounding boundary, the product moves
    by one bf16 step, at most 2^-8·c·|v| for values below 1. Two such steps
    in one output row, relative to max|ref|. (K2b on Matérn-3/2 at k = 3
    reached 4.8e-4 of max|ref| over 40 draws of V on an H100, one step.)"""
    return 2 * c * 2.0**-8 * V.abs().max().item() / ref.abs().max().item()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SQDIST_KINDS)
@pytest.mark.parametrize("k", [1, 3, 16, 70])
def test_cuda_matmat_matches_plain(cuda_device, kind, k):
    X1, X2, V = _data(7, 1000, 777, 3, k)
    args = [torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V)]
    ref = kernel_plain.gram_matmat_f64(kind, *args, 1.3, 0.9)
    got = kernel_cuda.gram_matmat(kind, *args, 1.3, 0.9)
    hi, lo = kernel_cuda.gram_matmat_comp(kind, *args, 1.3, 0.9)
    torch.cuda.synchronize()
    err = _rel(got, ref)
    err_comp = _rel(hi.double() + lo.double(), ref)
    assert err <= 2e-5
    assert err_comp <= err
    assert err_comp <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_cuda_symmetric_matches_plain(cuda_device, k):
    rng = np.random.default_rng(8)
    X = torch.from_numpy(rng.standard_normal((1300, 28)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((1300, k)).astype(np.float32))
    X, V = X.to(cuda_device), V.to(cuda_device)
    ref = kernel_plain.gram_matvec_symmetric_f64("rbf", X, V, 5.3)
    got = kernel_cuda.gram_matvec_symmetric("rbf", X, V, 5.3)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SQDIST_KINDS)
def test_cuda_ard_lengthscale(cuda_device, kind):
    """A (d,) lengthscale: K1 and K2 get points pre-scaled by the wrapper,
    K1c divides by it in float64 inside the kernel."""
    X1, X2, V = _data(9, 500, 300, 5, 3)
    ls = torch.tensor([0.7, 1.1, 1.9, 2.5, 0.9], device=cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V)]
    ref = kernel_plain.gram_matmat_f64(kind, *args, ls)
    got = kernel_cuda.gram_matmat(kind, *args, ls)
    hi, lo = kernel_cuda.gram_matmat_comp(kind, *args, ls.double())
    Xs = args[0][:300]  # as many points as V has rows
    ref_sym = kernel_plain.gram_matvec_symmetric_f64(kind, Xs, args[2], ls)
    sym = kernel_cuda.gram_matvec_symmetric(kind, Xs, args[2], ls)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 2e-5
    assert _rel(hi.double() + lo.double(), ref) <= 1e-10
    assert _rel(sym, ref_sym) <= 2e-5


@pytest.mark.cuda
def test_cuda_launch_counts_and_refusals(cuda_device):
    X = torch.randn((300, 4), device=cuda_device)
    V = torch.randn((300, 17), device=cuda_device)
    kernel_cuda.reset_launch_counts()
    kernel_cuda.gram_matmat("rbf", X, X, V, 1.0)
    kernel_cuda.gram_matmat_comp("rbf", X, X, V[:, :2], 1.0)
    assert kernel_cuda.launch_counts() == {
        "gram_matmat": 1, "gram_matmat_comp": 1, "gram_matvec_symmetric_comp": 0,
        "gram_matvec_symmetric": 0,
        "gram_matmat_tier": 0, "gram_matvec_symmetric_tier": 0,
        "gram_matmat_f64": 0, "gram_matvec_symmetric_f64": 0,
        "gram_pair": 0, "gram_pair_tier": 0,
        "gram_pair_comp": 0, "gram_pair_f64": 0,
        "csr_spmv": 0, "csr_spmm": 0,
    }
    with pytest.raises(ValueError, match="k <= 16"):
        kernel_cuda.gram_matvec_symmetric("rbf", X, V, 1.0)
    with pytest.raises(NotImplementedError, match="takes torch.float32"):
        kernel_cuda.gram_matmat("rbf", X.double(), X.double(), V.double(), 1.0)
    parts = tier_operand(X, "bf16x3")
    with pytest.raises(NotImplementedError, match="Laplace family has no tier"):
        kernel_cuda.gram_matmat_tier("laplace", parts, parts, V, 1.0)
    assert kernel_cuda.launch_counts()["gram_matvec_symmetric"] == 0
    assert kernel_cuda.launch_counts()["gram_matmat_tier"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["bf16x3", "bfloat16"])
@pytest.mark.parametrize("kind", SQDIST_KINDS)
@pytest.mark.parametrize("k", [1, 3, 16, 70])
def test_cuda_tiers_match_their_plain_versions(cuda_device, cd, kind, k):
    """K1b and K2b against the plain version of their tier (float32 on the
    card; K1b's contraction ``forward_contraction``'s, as the card's): 1e-5
    of max|ref| where both contract alike; where the one-pass tier re-rounds
    kernel values to bf16 (k > 16, and K2b's mirror at k >= 3), two bf16
    steps of a product in a row
    (:func:`_reround_bound`). K2b on Matérn-1/2: its diagonal values are
    the square root of a cancelled float sum (measured 7.8e-5 on an H100),
    so the whole product is held to 1e-3, and the rows whose own row of V
    is zero, which hold no diagonal value, to the regular bound."""
    X1, X2, V = _data(11, 700, 530, 28, k)
    X1, X2, V = (torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V))
    A, B = tier_operand(X1 / 5.3, cd), tier_operand(X2 / 5.3, cd)
    got = kernel_cuda.gram_matmat_tier(kind, A, B, V, 0.8)
    ref = kernel_plain.gram_matmat_tier(kind, A, B, V, 0.8)
    torch.cuda.synchronize()
    reround = cd == "bfloat16" and k > 16
    assert _rel(got, ref) <= (_reround_bound(V, ref, 0.8) if reround else 1e-5)
    if k <= 16:
        gen = torch.Generator(device=cuda_device).manual_seed(k)
        Vs = torch.randn((700, k), generator=gen, device=cuda_device)

        def bound(V, ref):
            return _reround_bound(V, ref, 0.8) if cd == "bfloat16" and k >= 3 else 1e-5

        got = kernel_cuda.gram_matvec_symmetric_tier(kind, A, Vs, 0.8)
        ref = kernel_plain.gram_matvec_symmetric_tier(kind, A, Vs, 0.8)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= (1e-3 if kind == "matern12" else bound(Vs, ref))
        if kind == "matern12":
            for parity in (0, 1):
                rows = torch.arange(700, device=cuda_device) % 2 == parity
                Vz = torch.where(rows[:, None], 0.0, Vs)
                got = kernel_cuda.gram_matvec_symmetric_tier(kind, A, Vz, 0.8)[rows]
                ref = kernel_plain.gram_matvec_symmetric_tier(kind, A, Vz, 0.8)[rows]
                torch.cuda.synchronize()
                assert _rel(got, ref) <= bound(Vz, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["bf16x3", "bfloat16"])
@pytest.mark.parametrize("kind", SQDIST_KINDS)
@pytest.mark.parametrize("k", [1, 2, 3, 8, 16, 17, 64, 129, 500])
def test_cuda_k1b_ragged_every_width(cuda_device, cd, kind, k, monkeypatch):
    """K1b against the plain version of its tier on ragged n and m (not
    whole 64-row tiles), every width of its schedules: the warp-specialised
    kernel (k <= 16 at d = 28) with one run of the m axis and with three
    (the partials summed by a second launch), and the wide kernel at 64 and
    128 columns a block with a ragged last block. Bounds as in
    :func:`test_cuda_tiers_match_their_plain_versions`."""
    X1, X2, V = _data(31, 333, 1201, 28, k)
    X1, X2, V = (torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V))
    A, B = tier_operand(X1 / 5.3, cd), tier_operand(X2 / 5.3, cd)
    ref = kernel_plain.gram_matmat_tier(kind, A, B, V, 0.8)
    reround = cd == "bfloat16" and k > 16
    bound = _reround_bound(V, ref, 0.8) if reround else 1e-5
    for runs in ((1, 3) if k <= 16 else (1,)):
        monkeypatch.setattr(kernel_cuda, "tier_splits", lambda *a, runs=runs: runs)
        got = kernel_cuda.gram_matmat_tier(kind, A, B, V, 0.8)
        torch.cuda.synchronize()
        assert got.shape == (333, k)
        assert _rel(got, ref) <= bound, runs


# K1b against float64: the bf16x3 tier's error is the cross term's and, at
# 9 to 16 columns up to a depth of 80, the split contraction's, each 2^-17
# of a product that sums with the products' signs (measured up to 1.04e-5
# of max|ref| at k = 1 on an H100, both contracting tier-matched); the
# one-pass tier's cross term is 2^-8 of one.
K1B_F64_BOUND = {"bf16x3": 4e-5, "bfloat16": 2.0**-6}


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["bf16x3", "bfloat16"])
@pytest.mark.parametrize("kind", ["rbf", "matern32"])
@pytest.mark.parametrize("k", [1, 2, 3, 10, 16])
@pytest.mark.parametrize("d", [10, 28, 50, 100])
def test_cuda_k1b_warpgroup_route(cuda_device, cd, kind, k, d):
    """K1b's warp-specialised kernel (every padded depth from 16 to 112, k
    <= 16: the float32 contraction on 1, 8 and 16 of W's columns, and the
    split, ``forward_contraction``) on ragged n and m against the plain
    version of its tier (1e-5) and the float64 product (``K1B_F64_BOUND``),
    on random V of both signs; two calls give the same bits, and the
    route's counter moved once a call."""
    X1, X2, V = _data(41 + d, 333, 1201, d, k)
    X1, X2, V = (torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V))
    A, B = tier_operand(X1 / d**0.5, cd), tier_operand(X2 / d**0.5, cd)
    assert kernel_cuda.forward_tier_route(k, A.hi.shape[1]) == "warpgroup"
    kernel_cuda.reset_launch_counts()
    got = kernel_cuda.gram_matmat_tier(kind, A, B, V, 0.8)
    again = kernel_cuda.gram_matmat_tier(kind, A, B, V, 0.8)
    torch.cuda.synchronize()
    assert kernel_cuda.route_counts()["gram_matmat_tier.warpgroup"] == 2
    assert torch.equal(got, again)
    ref = kernel_plain.gram_matmat_tier(kind, A, B, V, 0.8)
    assert _rel(got, ref) <= 1e-5
    f64 = kernel_plain.gram_matmat_f64(kind, X1.double(), X2.double(), V.double(), d**0.5, 0.8)
    assert _rel(got, f64) <= K1B_F64_BOUND[cd]


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["bf16x3", "bfloat16"])
def test_cuda_k1b_warpgroup_runs_past_long_tiles(cuda_device, cd):
    """Past ``TIER_LONG_TILES`` 64-column tiles (2^20 columns) the kernel
    walks the m axis in runs of at most ``TIER_RUN_TILES`` tiles, whose
    partials ``sum_splits`` adds in a fixed order: against the plain
    version and float64 as above, the same bits twice."""
    n, m, d, k = 200, kernel_cuda.TIER_LONG_TILES * 64 + 1_000, 28, 3
    X1, X2, V = _data(43, n, m, d, k)
    X1, X2, V = (torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V))
    A, B = tier_operand(X1 / 5.3, cd), tier_operand(X2 / 5.3, cd)
    dp = A.hi.shape[1]
    runs = kernel_cuda.tier_splits(n, m, k, dp, kernel_cuda.sm_count(cuda_device))
    assert kernel_cuda.forward_tier_route(k, dp) == "warpgroup"
    assert -(-m // 64) > kernel_cuda.TIER_LONG_TILES and runs > 1
    got = kernel_cuda.gram_matmat_tier("rbf", A, B, V, 0.8)
    again = kernel_cuda.gram_matmat_tier("rbf", A, B, V, 0.8)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = kernel_plain.gram_matmat_tier("rbf", A, B, V, 0.8)
    assert _rel(got, ref) <= 1e-5
    f64 = kernel_plain.gram_matmat_f64("rbf", X1.double(), X2.double(), V.double(), 5.3, 0.8)
    assert _rel(got, f64) <= K1B_F64_BOUND[cd]


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["bf16x3", "bfloat16"])
@pytest.mark.parametrize("kind", ["rbf", "matern32"])
@pytest.mark.parametrize("k", [1, 3, 16])
def test_cuda_k1b_strip_past_depth_128(cuda_device, cd, kind, k, monkeypatch):
    """K1b past a padded depth of 128 (d = 150) takes the strip's forward
    form: on ragged n and m, with one run of the m axis and with three,
    against the plain version of its tier (1e-5) and the float64 product
    (``K1B_F64_BOUND``); the strip's counter moved once a call."""
    d = 150
    X1, X2, V = _data(47 + k, 333, 1201, d, k)
    X1, X2, V = (torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V))
    A, B = tier_operand(X1 / d**0.5, cd), tier_operand(X2 / d**0.5, cd)
    assert kernel_cuda.forward_tier_route(k, A.hi.shape[1]) == "strip"
    ref = kernel_plain.gram_matmat_tier(kind, A, B, V, 0.8)
    f64 = kernel_plain.gram_matmat_f64(kind, X1.double(), X2.double(), V.double(), d**0.5, 0.8)
    for runs in (1, 3):
        monkeypatch.setattr(kernel_cuda, "tier_splits", lambda *a, runs=runs: runs)
        kernel_cuda.reset_launch_counts()
        got = kernel_cuda.gram_matmat_tier(kind, A, B, V, 0.8)
        torch.cuda.synchronize()
        assert kernel_cuda.route_counts()["gram_matmat_tier.strip"] == 1
        assert got.shape == (333, k)
        assert _rel(got, ref) <= 1e-5, runs
        assert _rel(got, f64) <= K1B_F64_BOUND[cd], runs


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SQDIST_KINDS)
@pytest.mark.parametrize("k", [1, 2, 3, 16, 17])
@pytest.mark.parametrize("n", [1000, 129])
def test_cuda_symmetric_comp_matches(cuda_device, kind, k, n):
    """The triangle K1c against the general K1c and the float64 plain
    version at ragged n (tiles of 128 points: a ragged last tile, and one
    point past a whole tile), k from 1 to 17 (1, 2 or 4 columns a slice):
    hi + lo within 1e-10 of max|ref| of both, as ``chip_smoke.py`` holds
    it; the ARD lengthscale of a float64 tensor."""
    X, _, V = _data(5 + k, n, n, 7, k)
    X, V = torch.from_numpy(X).to(cuda_device), torch.from_numpy(V).to(cuda_device)
    ls = torch.linspace(0.8, 1.9, 7, dtype=torch.float64, device=cuda_device)
    ref = kernel_plain.gram_matmat_f64(kind, X, X, V, ls, 0.9)
    hi, lo = kernel_cuda.gram_matvec_symmetric_comp(kind, X, V, ls, 0.9)
    ghi, glo = kernel_cuda.gram_matmat_comp(kind, X, X, V, ls, 0.9)
    torch.cuda.synchronize()
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == (n, k)
    got = hi.double() + lo.double()
    assert _rel(got, ref) <= 1e-10
    assert _rel(got, ghi.double() + glo.double()) <= 1e-10
    h1, l1 = kernel_cuda.gram_matvec_symmetric_comp(kind, X, V[:, 0], ls, 0.9)
    assert h1.shape == (n,) and _rel(h1.double() + l1.double(), ref[:, 0]) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SQDIST_KINDS + ("laplace",))
@pytest.mark.parametrize("k", [1, 5, 9, 20])
def test_cuda_f64_match_plain(cuda_device, kind, k):
    """K8 and K7 against the float64 plain version, scalar and ARD
    lengthscales: float64 end to end, so 1e-10 of max|ref|."""
    X1, X2, V = _data(12, 600, 450, 5, k)
    X1, X2 = torch.from_numpy(X1).to(cuda_device), torch.from_numpy(X2).to(cuda_device)
    V = torch.from_numpy(V).to(cuda_device).double()
    Vs = torch.randn((600, k), device=cuda_device, dtype=torch.float64)
    for ls in (1.7, torch.tensor([0.7, 1.1, 1.9, 2.5, 0.9], dtype=torch.float64,
                                 device=cuda_device)):
        got = kernel_cuda.gram_matmat_f64(kind, X1, X2, V, ls, 0.7)
        ref = kernel_plain.gram_matmat_f64(kind, X1, X2, V, ls, 0.7)
        sym = kernel_cuda.gram_matvec_symmetric_f64(kind, X1, Vs, ls, 0.7)
        ref_sym = kernel_plain.gram_matmat_f64(kind, X1, X1, Vs, ls, 0.7)
        torch.cuda.synchronize()
        assert got.dtype == sym.dtype == torch.float64
        assert _rel(got, ref) <= 1e-10
        assert _rel(sym, ref_sym) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SQDIST_KINDS + ("laplace",))
@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("k", [1, 4, 5, 10])
def test_cuda_k7_matches_float64(cuda_device, kind, ard, k):
    """K7 (the float64 triangle of ``csrc/gram_comp.cu``) against the float64
    plain version at a ragged n and d (1,000 points: 8 tiles of 128, the
    last part full; d = 20: two chunks of 16 features, the second part
    zero), every width of its slices (1, 4; 5 and 10 in 2 and 3 slices):
    float64 end to end, 1e-10 of max|ref|."""
    X, _, V = _data(17, 1000, 1000, 20, k)
    X = torch.from_numpy(X).to(cuda_device)
    V = torch.from_numpy(V).to(cuda_device).double()
    ls = (torch.linspace(3.0, 6.0, 20, dtype=torch.float64, device=cuda_device) if ard
          else 4.4)
    got = kernel_cuda.gram_matvec_symmetric_f64(kind, X, V, ls, 0.7)
    ref = kernel_plain.gram_matmat_f64(kind, X, X, V, ls, 0.7)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 and got.shape == (1000, k)
    assert _rel(got, ref) <= 1e-10


@pytest.mark.cuda
def test_cuda_refinement_certifies(cuda_device):
    """A bf16x3 operator's solve refined in update mode with the sampled
    certificate, on the card: float64 W there, K1b, K2b, K7 and K8 all
    launched, and the claim within the tolerance."""
    from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.preconditioners import NystromConfig
    from rlaopt_tpu_torch.solvers import PCGConfig

    rng = np.random.default_rng(13)
    X = torch.from_numpy(rng.standard_normal((3000, 8)).astype(np.float32)).to(cuda_device)
    y = torch.tanh(X.sum(1))
    K = RBFLinOp(X, X, KernelConfig(lengthscale=8**0.5), compute_dtype="bf16x3")
    cfg = PCGConfig(max_iters=40, rtol=1e-8, precond_config=NystromConfig(rank=100, rho=0.3))
    kernel_cuda.reset_launch_counts()
    W64, log = LinSys(K, y, reg=0.3).solve(
        cfg, torch.zeros((3000, 1), device=cuda_device), key=0,
        f64_refine_rounds=3, f64_refine_device="accel",
        f64_refine_residual="update", f64_refine_certify="sampled",
    )
    counts = kernel_cuda.launch_counts()
    assert W64.dtype == torch.float64 and W64.is_cuda
    assert log["f64_refine"]["rel_res_f64"][-1][0] <= 1e-8
    for name in ("gram_matmat_tier", "gram_matvec_symmetric_tier",
                 "gram_matvec_symmetric_f64", "gram_matmat_f64"):
        assert counts[name] > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 16, 17, 500])
def test_cuda_laplace_matches_plain(cuda_device, k, monkeypatch):
    """K3 (its tile up to 16 columns, the wide kernel past that; with the
    default runs of the m axis and in one pass over m) and K3c against the
    float64 plain version at a ragged shape, d = 50 (three full 16-feature
    stages and a ragged one), scalar and ARD lengthscales: K3 2e-5, K3c
    1e-10 of max|ref|, as K1 and K1c."""
    X1, X2, V = _data(14, 1000, 777, 50, k)
    X1, X2, V = (torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V))
    ard = torch.linspace(6.0, 10.0, 50, device=cuda_device)
    for ls in (8.0, ard):
        ref = kernel_plain.gram_matmat_f64("laplace", X1, X2, V, ls, 0.9)
        got = kernel_cuda.gram_matmat("laplace", X1, X2, V, ls, 0.9)
        with monkeypatch.context() as mp:
            mp.setattr(kernel_cuda, "tile_splits", lambda *a: 1)
            one = kernel_cuda.gram_matmat("laplace", X1, X2, V, ls, 0.9)
        ls64 = ls.double() if torch.is_tensor(ls) else ls
        hi, lo = kernel_cuda.gram_matmat_comp("laplace", X1, X2, V, ls64, 0.9)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= 2e-5
        assert _rel(one, ref) <= 2e-5
        assert _rel(hi.double() + lo.double(), ref) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_cuda_laplace_symmetric_matches_plain(cuda_device, k):
    """K5 (the triangle form of K3's tile) against the float64 plain
    version: 2e-5, as K2 (fp32 atomics)."""
    rng = np.random.default_rng(15)
    X = torch.from_numpy(rng.standard_normal((1300, 28)).astype(np.float32)).to(cuda_device)
    V = torch.from_numpy(rng.standard_normal((1300, k)).astype(np.float32)).to(cuda_device)
    ref = kernel_plain.gram_matmat_f64("laplace", X, X, V, 32.0, 1.1)
    got = kernel_cuda.gram_matvec_symmetric("laplace", X, V, 32.0, 1.1)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 10, 16])
@pytest.mark.parametrize("n, d", [(1000, 3), (1300, 28), (257, 50), (128, 28)])
def test_cuda_k5_triangle_tile_matches_float64(cuda_device, n, d, k):
    """K5 at ragged and whole numbers of 128-point tiles, d = 3, 28 and 50
    (a last feature chunk of 18), every KC it takes, scalar and ARD
    lengthscales: 2e-5 of the float64 plain version; given the operand an
    operator keeps, the same product to the float atomics' order (1e-6)."""
    rng = np.random.default_rng(n + d + k)
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda_device)
    V = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(cuda_device)
    for ls in (2 * d / np.pi**0.5, torch.linspace(0.6, 1.4, d, device=cuda_device) * d):
        ref = kernel_plain.gram_matmat_f64("laplace", X, X, V, ls, 0.9)
        got = kernel_cuda.gram_matvec_symmetric("laplace", X, V, ls, 0.9)
        kept = kernel_cuda.gram_matvec_symmetric("laplace", X, V, ls, 0.9,
                                                 kernel_cuda.tile_operand(X, ls))
        torch.cuda.synchronize()
        assert _rel(got, ref) <= 2e-5
        assert _rel(kept, got.double()) <= 1e-6


@pytest.mark.cuda
def test_cuda_k5_takes_the_operators_operand(cuda_device):
    """``LaplaceLinOp`` on one data set applies K5 on the operand it keeps
    (built once), within the float atomics' order of a direct call; a wrong
    operand raises."""
    from rlaopt_tpu_torch.kernels import KernelConfig, LaplaceLinOp

    rng = np.random.default_rng(51)
    X = torch.from_numpy(rng.standard_normal((900, 28)).astype(np.float32)).to(cuda_device)
    V = torch.from_numpy(rng.standard_normal((900, 3)).astype(np.float32)).to(cuda_device)
    K = LaplaceLinOp(X, X, KernelConfig(lengthscale=32.0, const_scaling=1.1))
    kernel_cuda.reset_launch_counts()
    got = [K @ V for _ in range(2)]
    assert kernel_cuda.launch_counts()["gram_matvec_symmetric"] == 2
    assert K._points[0].tile is K._points[1].tile is not None
    want = kernel_cuda.gram_matvec_symmetric("laplace", X, V, 32.0, 1.1)
    torch.cuda.synchronize()
    for g in got:
        assert _rel(g, want.double()) <= 1e-6
    with pytest.raises(ValueError, match="tile's operand"):
        kernel_cuda.gram_matvec_symmetric("laplace", X, V, 32.0, 1.1,
                                          kernel_cuda.tile_operand(X[:500], 32.0))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rbf", "laplace"])
def test_cuda_column_splits(cuda_device, kind, monkeypatch):
    """A few rows against many points: the register tile's forward form (K1
    and K3) cuts m into runs (tile_splits) and sums their partials in a
    fixed order. Both the split and the one-pass product against float64:
    2e-5; the split one gives the same bits twice."""
    rng = np.random.default_rng(16)
    X1 = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32)).to(cuda_device)
    X2 = torch.from_numpy(rng.standard_normal((200_000, 8)).astype(np.float32)).to(cuda_device)
    V = torch.from_numpy(rng.standard_normal((200_000, 2)).astype(np.float32)).to(cuda_device)
    assert kernel_cuda.tile_splits(300, 200_000, 2, 132) > 1
    ls = 3.0 if kind == "rbf" else 9.0
    fn = lambda: kernel_cuda.gram_matmat(kind, X1, X2, V, ls)  # noqa: E731
    ref = kernel_plain.gram_matmat_f64(kind, X1, X2, V, ls)
    split, again = fn(), fn()
    monkeypatch.setattr(kernel_cuda, "tile_splits", lambda *a: 1)
    one = fn()
    torch.cuda.synchronize()
    assert torch.equal(split, again)
    assert _rel(split, ref) <= 2e-5
    assert _rel(one, ref) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 9, 16])
@pytest.mark.parametrize("n,m,d", [(1000, 777, 3), (1000, 777, 28), (300, 1300, 50),
                                   (129, 4000, 17)])
def test_cuda_k3_tile_matches_plain(cuda_device, n, m, d, k):
    """K3's tile (``gram_matmat("laplace", ...)`` up to 16 columns) at ragged shapes (n and m not
    multiples of 128, d with a ragged last chunk) at every right-hand-side
    count of its instantiations, scalar and ARD lengthscales, against the
    float64 plain version: 2e-5 of max|ref|; the same bits twice."""
    X1, X2, V = (torch.from_numpy(a).to(cuda_device) for a in _data(n + m + d + k, n, m, d, k))
    for ls in (2 * d / np.pi**0.5, torch.linspace(0.6, 1.4, d, device=cuda_device) * d):
        ref = kernel_plain.gram_matmat_f64("laplace", X1, X2, V, ls, 0.9)
        kernel_cuda.reset_launch_counts()
        got, again = (kernel_cuda.gram_matmat("laplace", X1, X2, V, ls, 0.9) for _ in range(2))
        torch.cuda.synchronize()
        assert kernel_cuda.launch_counts()["gram_matmat"] == 2
        assert torch.equal(got, again)
        assert _rel(got, ref) <= 2e-5


@pytest.mark.cuda
def test_cuda_k3_tile_takes_an_operators_operands(cuda_device):
    """K3's tile given its operands built beforehand (as a Laplace operator
    keeps them) gives the same bits as building them per call; an operand
    of other points' shape raises. A row oracle of ``LaplaceLinOp`` gives
    the same bits as the call on its rows."""
    from rlaopt_tpu_torch.kernels import KernelConfig, LaplaceLinOp

    X1, X2, V = (torch.from_numpy(a).to(cuda_device) for a in _data(41, 300, 1300, 50, 3))
    ls = 7.5
    ops = (kernel_cuda.tile_operand(X1, ls), kernel_cuda.tile_operand(X2, ls))
    want = kernel_cuda.gram_matmat("laplace", X1, X2, V, ls, 0.9)
    assert torch.equal(kernel_cuda.gram_matmat("laplace", X1, X2, V, ls, 0.9, *ops), want)
    assert torch.equal(kernel_cuda.gram_matmat("laplace", X1, X2, V, ls, 0.9, ops[0]), want)
    with pytest.raises(ValueError, match="operand"):
        kernel_cuda.gram_matmat("laplace", X1, X2, V, ls, 0.9, *ops[::-1])
    K = LaplaceLinOp(X2, X2, KernelConfig(lengthscale=ls, const_scaling=0.9))
    blk = torch.arange(0, 1300, 7, device=cuda_device)
    W = V[:, :1]
    for _ in range(2):
        got = K.row_oracle(blk) @ W
        torch.cuda.synchronize()
        assert torch.equal(got, kernel_cuda.gram_matmat("laplace", X2[blk], X2, W, ls, 0.9))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 9, 16, 17, 64, 65, 200])
@pytest.mark.parametrize("n,m,d", [(1000, 777, 3), (300, 1300, 50), (129, 4000, 28)])
@pytest.mark.parametrize("kind", SQDIST_KINDS)
def test_cuda_k1_tile_and_wide_match_float64(cuda_device, kind, n, m, d, k):
    """K1 on the register tile up to 16 columns and past 16 on the 3xTF32
    kernel ``wide_route`` names (the ``mma.sync`` kernel at 17, the
    warpgroup form from 33), at ragged shapes (n, m not multiples of 128,
    a last feature chunk of 3, 18 and 28 features), scalar and ARD
    lengthscales, every family: 2e-5 of max|ref| against the float64 plain
    version; the same bits twice."""
    X1, X2, V = (torch.from_numpy(a).to(cuda_device) for a in _data(n + m + k, n, m, d, k))
    for ls in (d**0.5, torch.linspace(0.5, 1.5, d, device=cuda_device) * d**0.5):
        ref = kernel_plain.gram_matmat_f64(kind, X1, X2, V, ls, 0.9)
        got, again = (kernel_cuda.gram_matmat(kind, X1, X2, V, ls, 0.9) for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert _rel(got, ref) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 10, 16])
@pytest.mark.parametrize("n,d", [(1000, 3), (1300, 28), (257, 50), (128, 28)])
@pytest.mark.parametrize("kind", SQDIST_KINDS)
def test_cuda_k2_triangle_tile_matches_float64(cuda_device, kind, n, d, k):
    """K2, the register tile's triangle form, at ragged and whole numbers of
    128-point tiles, every KC it takes, scalar and ARD lengthscales: 2e-5
    of the float64 plain version (Matérn-1/2's diagonal: the squared
    distance of a point with itself is 0 exactly in the direct sum);
    given the operand an operator keeps, the same product to the float
    atomics' order (1e-6)."""
    rng = np.random.default_rng(n + d + k)
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda_device)
    V = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(cuda_device)
    for ls in (d**0.5, torch.linspace(0.5, 1.5, d, device=cuda_device) * d**0.5):
        ref = kernel_plain.gram_matmat_f64(kind, X, X, V, ls, 0.9)
        got = kernel_cuda.gram_matvec_symmetric(kind, X, V, ls, 0.9)
        kept = kernel_cuda.gram_matvec_symmetric(kind, X, V, ls, 0.9,
                                                 kernel_cuda.tile_operand(X, ls))
        torch.cuda.synchronize()
        assert _rel(got, ref) <= 2e-5
        assert _rel(kept, got.double()) <= 1e-6


@pytest.mark.cuda
def test_cuda_k1_k2_take_the_operators_operand(cuda_device):
    """``RBFLinOp`` on one data set keeps the tile's operand (built once)
    and applies K2 (k = 3) and the wide K1 (k = 20) on it, within the float
    atomics' order of direct calls (K1 bit for bit); a row oracle gives
    the bits of the call on its rows."""
    from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp

    rng = np.random.default_rng(52)
    X = torch.from_numpy(rng.standard_normal((900, 28)).astype(np.float32)).to(cuda_device)
    V = torch.from_numpy(rng.standard_normal((900, 20)).astype(np.float32)).to(cuda_device)
    K = RBFLinOp(X, X, KernelConfig(lengthscale=5.3, const_scaling=1.1))
    kernel_cuda.reset_launch_counts()
    sym, wide = K @ V[:, :3], K @ V
    counts = kernel_cuda.launch_counts()
    assert counts["gram_matvec_symmetric"] == 1 and counts["gram_matmat"] == 1
    assert K._points[0].tile is K._points[1].tile is not None
    torch.cuda.synchronize()
    assert _rel(sym, kernel_cuda.gram_matvec_symmetric("rbf", X, V[:, :3], 5.3, 1.1).double()) <= 1e-6
    assert torch.equal(wide, kernel_cuda.gram_matmat("rbf", X, X, V, 5.3, 1.1))
    blk = torch.arange(0, 900, 7, device=cuda_device)
    assert torch.equal(K.row_oracle(blk) @ V[:, :1],
                       kernel_cuda.gram_matmat("rbf", X[blk], X, V[:, :1], 5.3, 1.1))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 16, 17])
@pytest.mark.parametrize("n,d", [(1000, 3), (129, 50), (700, 28)])
def test_cuda_triangle_k3c_matches_float64(cuda_device, n, d, k):
    """The triangle K3c (``gram_matvec_symmetric_comp`` on Laplace) against
    the float64 plain version, scalar and ARD lengthscales: hi + lo within
    1e-10 of max|ref|, as the general K3c."""
    X, _, V = (torch.from_numpy(a).to(cuda_device) for a in _data(n + d + k, n, n, d, k))
    for ls in (1.3, torch.linspace(6.0, 10.0, d, device=cuda_device, dtype=torch.float64)):
        ref = kernel_plain.gram_matmat_f64("laplace", X, X, V, ls, 0.9)
        hi, lo = kernel_cuda.gram_matvec_symmetric_comp("laplace", X, V, ls, 0.9)
        torch.cuda.synchronize()
        assert _rel(hi.double() + lo.double(), ref) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 10, 16, 17, 40])
@pytest.mark.parametrize("n,m,d", [(1000, 777, 3), (100, 1300, 28), (300, 5000, 50)])
@pytest.mark.parametrize("kind", SQDIST_KINDS + ("laplace",))
def test_cuda_comp_forward_form_matches_float64(cuda_device, kind, n, m, d, k):
    """The float64 tile's forward form: the general K1c (K3c for Laplace)
    and K8 against the float64 plain version at ragged shapes (n, m not
    multiples of 128, one row tile of 100, d not a multiple of 16; 300 x
    5,000 in runs of X2's tiles), scalar and ARD lengthscales, k up to 16
    in one slice and past it in two or three: within 1e-10 of max|ref|,
    the same bits twice."""
    X1, X2, V = (torch.from_numpy(a).to(cuda_device) for a in _data(n + k + d, n, m, d, k))
    for ls in (1.3 * d**0.5, torch.linspace(0.6, 1.8, d, dtype=torch.float64,
                                             device=cuda_device) * d**0.5):
        ref = kernel_plain.gram_matmat_f64(kind, X1, X2, V, ls, 0.9)
        args = (kind, X1, X2, V, ls, 0.9)
        hi, lo = kernel_cuda.gram_matmat_comp(*args)
        hi2, lo2 = kernel_cuda.gram_matmat_comp(*args)
        f64 = kernel_cuda.gram_matmat_f64(kind, X1, X2, V.double(), ls, 0.9)
        f64_2 = kernel_cuda.gram_matmat_f64(kind, X1, X2, V.double(), ls, 0.9)
        torch.cuda.synchronize()
        assert hi.dtype == lo.dtype == torch.float32 and f64.dtype == torch.float64
        assert _rel(hi.double() + lo.double(), ref) <= 1e-10 and _rel(f64, ref) <= 1e-10
        assert torch.equal(hi, hi2) and torch.equal(lo, lo2) and torch.equal(f64, f64_2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 10, 17])
@pytest.mark.parametrize("n1,n2,d", [(1000, 777, 3), (100, 1300, 28), (2000, 1500, 50)])
@pytest.mark.parametrize("kind", SQDIST_KINDS + ("laplace",))
def test_cuda_comp_pair_forms_match_float64(cuda_device, kind, n1, n2, d, k):
    """The certified pairs (``gram_pair_comp`` with float32 V,
    ``gram_pair_f64`` with float64 V): out1 against the plain float64
    product on (X1, X2, V2), out2 on (X2, X1, V1), within 1e-10 of max|ref|
    each, at ragged shapes, an ARD lengthscale, k of 1 to 17 (1, 2 or 4
    columns a slice)."""
    rng = np.random.default_rng(n1 + n2 + k)
    X1, X2 = (torch.from_numpy(rng.standard_normal((r, d)).astype(np.float32)).to(cuda_device)
              for r in (n1, n2))
    V2, V1 = (torch.from_numpy(rng.standard_normal((r, k)).astype(np.float32)).to(cuda_device)
              for r in (n2, n1))
    ls = torch.linspace(0.6, 1.8, d, dtype=torch.float64, device=cuda_device) * d**0.5
    r1 = kernel_plain.gram_matmat_f64(kind, X1, X2, V2, ls, 0.9)
    r2 = kernel_plain.gram_matmat_f64(kind, X2, X1, V1, ls, 0.9)
    for pair, a, b in ((kernel_cuda.gram_pair_comp, V2, V1),
                       (kernel_cuda.gram_pair_f64, V2.double(), V1.double())):
        o1, o2 = pair(kind, X1, X2, a, b, ls, 0.9)
        torch.cuda.synchronize()
        assert o1.dtype == o2.dtype == torch.float64
        assert o1.shape == (n1, k) and o2.shape == (n2, k)
        assert _rel(o1, r1) <= 1e-10 and _rel(o2, r2) <= 1e-10


@pytest.mark.cuda
def test_cuda_probes_match_plain(cuda_device):
    """The ceiling probes against their plain versions: the L1 probe
    (float32 and float64) and the elementwise chain to the bit (the same
    operations in the same order), the exp chain and sums within 1e-5 of
    max|ref| (``__expf`` against ``torch.exp``); each launch counted."""
    from rlaopt_tpu_torch.ops import probes

    g = torch.Generator(device=cuda_device).manual_seed(0)
    probes.reset_launch_counts()
    for dt in (torch.float32, torch.float64):
        X = torch.randn((2, 3, 128, 64), generator=g, device=cuda_device, dtype=dt)
        Y = torch.randn((2, 3, 64, 256), generator=g, device=cuda_device, dtype=dt)
        assert torch.equal(probes.probe_l1(X, Y), probes.probe_l1_plain(X, Y))
    X, Y = (torch.randn((256, 1000), generator=g, device=cuda_device) for _ in range(2))
    assert torch.equal(probes.probe_elem(X, Y), probes.probe_elem_plain(X, Y))
    assert _rel(probes.probe_exp_chain(X, Y), probes.probe_exp_chain_plain(X, Y).double()) <= 1e-5
    U, U2 = (torch.rand((256, 1000), generator=g, device=cuda_device) for _ in range(2))
    for step in ("exp", "epilogue"):
        got = probes.probe_vmem_chain(U, U2, step)
        assert _rel(got, probes.probe_vmem_chain_plain(U, U2, step).double()) <= 1e-5
    assert probes.launch_counts() == {"probe_l1": 2, "probe_elem": 1, "probe_exp_chain": 1,
                                      "probe_vmem_chain": 2}
    with pytest.raises(RuntimeError, match="multiples of 128"):
        probes.probe_l1(X[None, None, :100, :64], Y[None, None, :64, :256])


def _ragged_csr(seed=21, n_rows=3000, n_cols=700):
    """Rows of 0 to 40 entries, every seventh empty, every 500th of 300 to
    1,200 (longer than a block), each row's first column repeated once."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 41, n_rows)
    lengths[::7] = 0
    lengths[3::500] = rng.integers(300, 1201, len(lengths[3::500]))
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    indices = rng.integers(0, n_cols, indptr[-1]).astype(np.int32)
    starts = indptr[:-1][lengths >= 2]
    indices[starts + 1] = indices[starts]
    values = rng.standard_normal(indptr[-1])
    return values, indices, indptr, n_cols


def _csr_on(device, values, indices, indptr, dtype):
    return (torch.from_numpy(values).to(device, dtype), torch.from_numpy(indptr).to(device),
            torch.from_numpy(indices).to(device))


# The schedules of #9 at k <= 16: lanes a row (a whole warp, or 2 to 16
# lanes of one), or a block of 256 threads a row.
CSR_SCHEDULES = {"warp": 32, "block": 256, "lanes2": 2, "lanes4": 4, "lanes8": 8,
                 "lanes16": 16}


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["auto", *CSR_SCHEDULES])
@pytest.mark.parametrize("k", [1, 3, 10, 40, 300])
def test_cuda_csr_matches_plain(cuda_device, k, schedule, monkeypatch):
    """#9 on a ragged CSR (empty rows, repeated columns, rows longer than a
    block) in every schedule of k ≤ 16: float64 against the float64 plain
    version to 1e-12, float32 to 5e-5 of it (sums of up to 1,200 terms),
    and the same bits from two launches."""
    values, indices, indptr, n_cols = _ragged_csr()
    n_rows = len(indptr) - 1
    if schedule != "auto":
        monkeypatch.setattr(kernel_cuda, "spmm_lanes", lambda *a: CSR_SCHEDULES[schedule])
    X = torch.from_numpy(np.random.default_rng(22).standard_normal((n_cols, k)))
    v64, p, c = _csr_on(cuda_device, values, indices, indptr, torch.float64)
    ref = tops._plain(v64, p, c, X.to(cuda_device), n_rows, False)
    fn = kernel_cuda.csr_spmv if k == 1 else kernel_cuda.csr_spmm
    for dtype, bound in ((torch.float64, 1e-12), (torch.float32, 5e-5)):
        args = (v64.to(dtype), p, c, X.to(cuda_device, dtype), n_rows)
        got, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert _rel(got, ref) <= bound
        assert torch.all(got[torch.from_numpy(np.diff(indptr) == 0).to(cuda_device)] == 0)


def _ragged_rows_csr(seed=23, n_cols=5000):
    """Rows of 0, 1, 15, 16, 17, 33, 300 and 20,000 entries, 40 of each in a
    shuffled order, each row's first column repeated."""
    rng = np.random.default_rng(seed)
    lengths = np.tile(np.array([0, 1, 15, 16, 17, 33, 300, 20000]), 40)
    rng.shuffle(lengths)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    indices = rng.integers(0, n_cols, indptr[-1]).astype(np.int32)
    starts = indptr[:-1][lengths >= 2]
    indices[starts + 1] = indices[starts]
    return rng.standard_normal(indptr[-1]), indices, indptr, n_cols


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("schedule", ["auto", *CSR_SCHEDULES])
@pytest.mark.parametrize("k", [1, 3, 16])
def test_cuda_csr_short_rows_every_length(cuda_device, k, schedule, offset, monkeypatch):
    """#9 on rows of 0 to 20,000 entries in one operand, in every schedule
    of k ≤ 16, with 16-byte aligned buffers (the chunked 16-byte loads) and
    buffers one element off (the same chunks read entry by entry): float64
    to 1e-12 and float32 to 5e-5 of the float64 plain version (a 20,000-term
    row), the same bits from two launches, empty rows 0."""
    values, indices, indptr, n_cols = _ragged_rows_csr()
    n_rows = len(indptr) - 1
    if schedule != "auto":
        monkeypatch.setattr(kernel_cuda, "spmm_lanes", lambda *a: CSR_SCHEDULES[schedule])
    X = torch.from_numpy(np.random.default_rng(24).standard_normal((n_cols, k)))
    v64, p, c = _csr_on(cuda_device, values, indices, indptr, torch.float64)
    ref = tops._plain(v64, p, c, X.to(cuda_device), n_rows, False)
    fn = kernel_cuda.csr_spmv if k == 1 else kernel_cuda.csr_spmm
    empty = torch.from_numpy(np.diff(indptr) == 0).to(cuda_device)
    for dtype, bound in ((torch.float64, 1e-12), (torch.float32, 5e-5)):
        v = torch.cat([v64.new_zeros(offset), v64]).to(dtype)[offset:]
        cc = torch.cat([c.new_zeros(offset), c])[offset:]
        args = (v, p, cc, X.to(cuda_device, dtype), n_rows)
        got, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert _rel(got, ref) <= bound
        assert torch.all(got[empty] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("segment", [256, 512, 2048])
@pytest.mark.parametrize("segmented", [True, False], ids=["segmented", "whole"])
@pytest.mark.parametrize("k", [1, 3, 10, 300])
@pytest.mark.parametrize("operand", ["ragged", "ragged rows"])
def test_cuda_csr_segmented_matches_plain(cuda_device, operand, k, segmented, segment,
                                          monkeypatch):
    """#9 on both ragged operands with their long rows cut into segments of
    256 to 2,048 entries (the plan built for that length), and with every
    row whole: float64 to 1e-12 and float32 to 5e-5 of the float64 plain
    version, the same bits from two launches, empty rows 0; past 16
    columns also with the columns taken in chunks of 128."""
    values, indices, indptr, n_cols = (_ragged_csr() if operand == "ragged"
                                       else _ragged_rows_csr())
    n_rows = len(indptr) - 1
    monkeypatch.setattr(kernel_cuda, "csr_segmented", lambda plan: segmented)
    X = torch.from_numpy(np.random.default_rng(25).standard_normal((n_cols, k)))
    v64, p, c = _csr_on(cuda_device, values, indices, indptr, torch.float64)
    plan = kernel_cuda.csr_plan(p, segment)
    ref = tops._plain(v64, p, c, X.to(cuda_device), n_rows, False)
    fn = kernel_cuda.csr_spmv if k == 1 else kernel_cuda.csr_spmm
    empty = torch.from_numpy(np.diff(indptr) == 0).to(cuda_device)
    caps = [kernel_cuda.CSR_PART_BYTES] + ([plan.n_segs * 128 * 8] if k > 16 else [])
    for cap in caps:
        monkeypatch.setattr(kernel_cuda, "CSR_PART_BYTES", cap)
        for dtype, bound in ((torch.float64, 1e-12), (torch.float32, 5e-5)):
            args = (v64.to(dtype), p, c, X.to(cuda_device, dtype), n_rows, plan)
            got, again = fn(*args), fn(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            assert _rel(got, ref) <= bound
            assert torch.all(got[empty] == 0)


@pytest.mark.cuda
def test_cuda_sparse_operator_keeps_its_plans(cuda_device, monkeypatch):
    """``sparse_aslinop`` on the card builds both CSRs' plans once, at
    construction: no product after it builds one, and its products are the
    wrapper's on the same plans, bit for bit."""
    values, indices, indptr, n_cols = _ragged_rows_csr()
    A = SparseCSRTensor(values.astype(np.float32), indices, indptr,
                        (len(indptr) - 1, n_cols), device=cuda_device)
    from rlaopt_tpu_torch.sparse import sparse_aslinop

    op = sparse_aslinop(A)

    def refuse(*a, **kw):
        raise AssertionError("an apply built a plan")

    monkeypatch.setattr(kernel_cuda, "csr_plan", refuse)
    X = torch.randn((n_cols, 300), device=cuda_device)
    Y = torch.randn((A.shape[0], 10), device=cuda_device)
    got, got_t = op @ X, op.T @ Y
    fv, fi, fp = A._csr_buffers()
    av, ai, ap = A.T._csr_buffers()
    torch.cuda.synchronize()
    assert torch.equal(got, kernel_cuda.csr_spmm(fv, fp, fi, X, A.shape[0], A._csr_plan()))
    assert torch.equal(got_t, kernel_cuda.csr_spmm(av, ap, ai, Y, n_cols, A.T._csr_plan()))


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["bf16x3", "bfloat16"])
@pytest.mark.parametrize("kind", SQDIST_KINDS)
@pytest.mark.parametrize("k", [1, 3, 10, 16])
@pytest.mark.parametrize("n, d", [(1000, 28), (1024, 28), (130, 3), (700, 100)],
                         ids=["ragged", "multiple-of-64", "small", "chunked-depth"])
def test_cuda_k2b_matches_its_tier(cuda_device, cd, kind, k, n, d):
    """K2b (the register-epilogue triangle kernel) against the plain
    version of its tier at ragged and whole numbers of 64-row tiles, and at
    d = 100 (depth 112, staged in chunks of 16 features), with the bounds of
    :func:`test_cuda_tiers_match_their_plain_versions`: 1e-5 where both
    contract in float32, two bf16 steps where the one-pass tier's mirror
    re-rounds (k ≥ 3), Matérn-1/2's diagonal rows at 1e-3 and the rows off
    it at the regular bound."""
    X, _, V = _data(13, n, n, d, k)
    X, V = torch.from_numpy(X).to(cuda_device), torch.from_numpy(V).to(cuda_device)
    A = tier_operand(X / d**0.5, cd)

    def bound(V, ref):
        return _reround_bound(V, ref, 0.8) if cd == "bfloat16" and k >= 3 else 1e-5

    got = kernel_cuda.gram_matvec_symmetric_tier(kind, A, V, 0.8)
    ref = kernel_plain.gram_matvec_symmetric_tier(kind, A, V, 0.8)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= (1e-3 if kind == "matern12" else bound(V, ref))
    rows = torch.arange(n, device=cuda_device) % 2 == 0
    Vz = torch.where(rows[:, None], 0.0, V)
    got = kernel_cuda.gram_matvec_symmetric_tier(kind, A, Vz, 0.8)[rows]
    ref = kernel_plain.gram_matvec_symmetric_tier(kind, A, Vz, 0.8)[rows]
    torch.cuda.synchronize()
    assert _rel(got, ref) <= bound(Vz, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", [None, "bf16x3"])
def test_cuda_impl_routes(cuda_device, tier):
    """``impl="auto"`` and ``"pallas"`` take the kernels on CUDA tensors,
    ``"xla"`` the plain versions there (no launch), with the same values."""
    from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp

    X = torch.randn((500, 6), device=cuda_device)
    V = torch.randn((500, 2), device=cuda_device)
    cfg = KernelConfig(lengthscale=1.7)
    out = {}
    for impl in ("auto", "pallas", "xla"):
        kernel_cuda.reset_launch_counts()
        out[impl] = RBFLinOp(X, X, cfg, impl=impl, compute_dtype=tier) @ V
        torch.cuda.synchronize()
        launched = sum(kernel_cuda.launch_counts().values())
        assert launched == (0 if impl == "xla" else 1), impl
    assert _rel(out["auto"], out["xla"].double()) <= 2e-5
    assert torch.equal(out["auto"], out["pallas"]) or _rel(out["auto"], out["pallas"].double()) <= 1e-6


@pytest.mark.cuda
def test_cuda_csr_routing_and_refusals(cuda_device, monkeypatch):
    """CUDA tensors go to the kernel and never to the plain version (CSR
    and CSC); what the kernel cannot take raises."""

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    values, indices, indptr, n_cols = _ragged_csr(23, 400, 90)
    n_rows = len(indptr) - 1
    v, p, c = _csr_on(cuda_device, values, indices, indptr, torch.float32)
    x = torch.randn(n_cols, device=cuda_device)
    y = torch.randn(n_rows, device=cuda_device)
    ref_x = tops.csr_matvec(v, p, c, x, n_rows)
    ref_y = tops.csc_matvec(v, p, c, y, n_cols)
    monkeypatch.setattr(tops, "_plain", refuse)
    kernel_cuda.reset_launch_counts()
    A = SparseCSRTensor(values.astype(np.float32), indices, indptr, (n_rows, n_cols),
                        device=cuda_device)
    assert torch.equal(A @ x, ref_x)
    assert torch.equal(A.T @ y, ref_y)
    assert torch.equal(tops.csr_matmat(v, p, c, x[:, None], n_rows)[:, 0], ref_x)
    assert kernel_cuda.launch_counts()["csr_spmv"] == 3
    tops.csr_matmat(v, p, c, torch.randn(n_cols, 4, device=cuda_device), n_rows)
    assert kernel_cuda.launch_counts()["csr_spmm"] == 1
    with pytest.raises(NotImplementedError, match="int32 indices"):
        kernel_cuda.csr_spmv(v, p, c.long(), x, n_rows)
    with pytest.raises(NotImplementedError, match="same type"):
        kernel_cuda.csr_spmv(v, p, c, x.double(), n_rows)
    with pytest.raises(ValueError, match="tensors on"):
        kernel_cuda.csr_spmv(v, p, c, x.cpu(), n_rows)


@pytest.mark.cuda
def test_cuda_lstsq_sparse_matches_the_cpu(cuda_device):
    """``LstSq(SparseCSRTensor(A, device=card), b)`` with LSQR and SkPre (an
    injected factor) gives the CPU solve's residuals in float64."""
    values, indices, indptr, n_cols = _ragged_csr(24, 3000, 60)
    n_rows = len(indptr) - 1
    rng = np.random.default_rng(25)
    b = rng.standard_normal(n_rows)
    dense = np.zeros((n_rows, n_cols))
    np.add.at(dense, (np.repeat(np.arange(n_rows), np.diff(indptr)), indices), values)
    Y = rng.standard_normal((240, n_rows)) @ dense / 240**0.5
    L = np.linalg.cholesky(Y.T @ Y)
    rels = []
    for dev in ("cpu", cuda_device):
        A = SparseCSRTensor(values, indices, indptr, (n_rows, n_cols), device=dev)
        cfg = LSQRConfig(max_iters=20, rtol=1e-13,
                         precond_config=SkPreConfig(sketch_size=240, rho=0.0))
        _, log = LstSq(A, torch.from_numpy(b).to(dev)).solve(
            cfg, torch.zeros((n_cols, 1), dtype=torch.float64, device=dev), callback_freq=5,
            preconditioner=interop.skpre_preconditioner(L, device=dev))
        rels.append(np.array([log[i]["metrics"]["internal_metrics"]["rel_res"].cpu().numpy()
                              for i in sorted(log)]))
    assert rels[0].shape == rels[1].shape
    assert np.all(np.abs(rels[0] - rels[1]) <= 1e-9 * rels[0] + 1e-11)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SQDIST_KINDS + ("laplace",))
@pytest.mark.parametrize("k", [1, 3, 16])
def test_cuda_pair_matches_plain(cuda_device, kind, k):
    """K4 (K6 for Laplace), the register tile's pair form, against the
    float64 plain pair at a ragged rectangle (n1 = 1000, n2 = 777, d = 3):
    both outputs within 2e-5 of max|ref|, K2's and K5's contract."""
    X1, X2, V2 = _data(13, 1000, 777, 3, k)
    V1 = np.random.default_rng(14).standard_normal((1000, k)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V2, V1)]
    o1, o2 = kernel_cuda.gram_pair(kind, *args, 1.3, 0.9)
    r1, r2 = kernel_plain.gram_pair(kind, *(a.double() for a in args), 1.3, 0.9)
    torch.cuda.synchronize()
    assert o1.shape == (1000, k) and o2.shape == (777, k)
    assert _rel(o1, r1) <= 2e-5 and _rel(o2, r2) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SQDIST_KINDS + ("laplace",))
@pytest.mark.parametrize("k", [2, 10])
@pytest.mark.parametrize("n1,n2", [(530, 2900), (3000, 2500)])
def test_cuda_tile_pair_matches_plain(cuda_device, kind, k, n1, n2):
    """The register tile's pair form (K4, K6) at the HIGGS width (d = 28, a
    ragged last chunk), n1 ≠ n2 and neither a multiple of 128, in one run
    and in several (``tile_splits``), V1 and V2 drawn apart: out1 against
    the float64 plain K1/K3 on (X1, X2, V2), out2 on (X2, X1, V1), 2e-5 of
    max|ref|; on operands built beforehand (the half-ring's kept ones) the
    same within that bound (float atomics: the last bits may move)."""
    X1, X2, V2 = _data(19, n1, n2, 28, k)
    V1 = np.random.default_rng(20).standard_normal((n1, k)).astype(np.float32)
    X1, X2, V2, V1 = (torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V2, V1))
    ls = 2 * 28 / np.pi**0.5 if kind == "laplace" else 28**0.5
    o1, o2 = kernel_cuda.gram_pair(kind, X1, X2, V2, V1, ls, 0.9)
    ops = (kernel_cuda.tile_operand(X1, ls), kernel_cuda.tile_operand(X2, ls))
    k1, k2 = kernel_cuda.gram_pair(kind, X1, X2, V2, V1, ls, 0.9, *ops)
    r1 = kernel_plain.gram_matmat_f64(kind, X1, X2, V2, ls, 0.9)
    r2 = kernel_plain.gram_matmat_f64(kind, X2, X1, V1, ls, 0.9)
    torch.cuda.synchronize()
    for got, ref in ((o1, r1), (o2, r2), (k1, r1), (k2, r2)):
        assert _rel(got, ref) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["warpgroup", "wide"])
@pytest.mark.parametrize("k", [17, 33, 64, 65, 168, 169, 500])
@pytest.mark.parametrize("d", [3, 70])
@pytest.mark.parametrize("kind", ["rbf", "matern32", "laplace"])
def test_cuda_k1_both_wide_kernels_match_float64(cuda_device, monkeypatch, kind, d, k, route):
    """Past 16 columns both kernels, each forced through ``wide_route``:
    the warpgroup form (every block width: 64, 128 and 168 columns) and the
    ``mma.sync`` kernel, at a ragged shape against float64, 2e-5 of
    max|ref|, the same bits twice; the launches counted on that route."""
    monkeypatch.setattr(kernel_cuda, "wide_route", lambda k, dp: route)
    X1, X2, V = (torch.from_numpy(a).to(cuda_device) for a in _data(k + d, 300, 2100, d, k))
    ls = torch.linspace(0.6, 1.4, d, device=cuda_device) * d**0.5
    kernel_cuda.reset_launch_counts()
    got, again = (kernel_cuda.gram_matmat(kind, X1, X2, V, ls, 0.9) for _ in range(2))
    ref = kernel_plain.gram_matmat_f64(kind, X1, X2, V, ls, 0.9)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel(got, ref) <= 2e-5
    assert kernel_cuda.gram_matmat.routes[route] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("k", [17, 32, 64, 200])
@pytest.mark.parametrize("d", [3, 28, 70])
def test_cuda_laplace_wide_matches_plain(cuda_device, k, d):
    """K3 past 16 columns (K1's 3xTF32 kernels with the L1 step) at a ragged
    shape against float64: 2e-5 of max|ref|, scalar and ARD lengthscales;
    no atomics: the same bits twice, and on the operands built beforehand
    as on those built in the call."""
    X1, X2, V = _data(21, 1000, 777, d, k)
    X1, X2, V = (torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V))
    scalar = 2 * d / np.pi**0.5
    for ls in (scalar, torch.linspace(0.6, 1.4, d, device=cuda_device) * scalar):
        got = kernel_cuda.gram_matmat("laplace", X1, X2, V, ls, 0.9)
        ops = (kernel_cuda.tile_operand(X1, ls), kernel_cuda.tile_operand(X2, ls))
        again = kernel_cuda.gram_matmat("laplace", X1, X2, V, ls, 0.9, *ops)
        ref = kernel_plain.gram_matmat_f64("laplace", X1, X2, V, ls, 0.9)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= 2e-5
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["bf16x3", "bfloat16"])
@pytest.mark.parametrize("kind", SQDIST_KINDS)
@pytest.mark.parametrize("k", [1, 2, 3, 16])
def test_cuda_pair_tier_matches_plain(cuda_device, cd, kind, k):
    """K4b (the pair form of K2b's strip) at ragged n1 ≠ n2 with V1 ≠ V2
    against the plain version of its tier: 1e-5 of max|ref| where
    both contract in float32 (the forward product, and the mirror at
    k ≤ 2); the one-pass tier's mirror at k ≥ 3 re-rounds kernel values to
    bf16 (:func:`_reround_bound`). Two distinct point sets hold no
    coincident points, so Matérn-1/2 has no cusp here."""
    X1, X2, V2 = _data(15, 700, 530, 28, k)
    V1 = np.random.default_rng(16).standard_normal((700, k)).astype(np.float32)
    X1, X2, V2, V1 = (torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V2, V1))
    A, B = tier_operand(X1 / 5.3, cd), tier_operand(X2 / 5.3, cd)
    o1, o2 = kernel_cuda.gram_pair_tier(kind, A, B, V2, V1, 0.8)
    r1, r2 = kernel_plain.gram_pair_tier(kind, A, B, V2, V1, 0.8)
    torch.cuda.synchronize()
    assert _rel(o1, r1) <= 1e-5
    reround = cd == "bfloat16" and k >= 3
    assert _rel(o2, r2) <= (_reround_bound(V1, r2, 0.8) if reround else 1e-5)


@pytest.mark.cuda
def test_cuda_pair_refusals(cuda_device):
    X = torch.randn((300, 4), device=cuda_device)
    V = torch.randn((300, 17), device=cuda_device)
    with pytest.raises(ValueError, match="k <= 16"):
        kernel_cuda.gram_pair("rbf", X, X, V, V, 1.0)
    parts = tier_operand(X, "bf16x3")
    with pytest.raises(NotImplementedError, match="Laplace family has no tier"):
        kernel_cuda.gram_pair_tier("laplace", parts, parts, V[:, :2], V[:, :2], 1.0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernel_cuda.gram_pair("laplace", X.cpu(), X.cpu(), V[:, :2].cpu(), V[:, :2].cpu(), 1.0)
    with pytest.raises(ValueError, match="differ in k"):
        kernel_cuda.gram_pair("rbf", X, X, V[:, :2], V[:, :3], 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,P,cd", [("rbf", 4, None), ("laplace", 3, None),
                                       ("rbf", 4, "bf16x3"), ("matern32", 5, None)])
def test_cuda_half_ring_launches_and_matches(cuda_device, kind, P, cd):
    """The half-ring on P positions of one card: P triangle launches and
    P(P − 1)/2 pair launches per matvec (the even-P antipodal step taken by
    half the positions), the product within the kernels' bound of the
    single-device float64 one (bf16x3: the tier's 2e-5 against float64)."""
    from rlaopt_tpu_torch.kernels import KernelConfig, ShardedKernelLinOp
    from rlaopt_tpu_torch.parallel import make_mesh

    X, _, V = _data(17, 2001, 1, 6, 1)
    X = torch.from_numpy(X).to(cuda_device)
    V = torch.from_numpy(np.random.default_rng(18).standard_normal((2001, 2)).astype(np.float32))
    V = V.to(cuda_device)
    cfg = KernelConfig(lengthscale=2.0, const_scaling=0.7)
    A = ShardedKernelLinOp(X, X, cfg, kind, mesh=make_mesh(devices=[cuda_device] * P),
                           memory_mode="ring", compute_dtype=cd)
    kernel_cuda.reset_launch_counts()
    got = A @ V
    torch.cuda.synchronize()
    used = kernel_cuda.launch_counts()
    tri, pair = {
        ("rbf", None): ("gram_matvec_symmetric", "gram_pair"),
        ("laplace", None): ("gram_matvec_symmetric", "gram_pair"),
        ("rbf", "bf16x3"): ("gram_matvec_symmetric_tier", "gram_pair_tier"),
        ("matern32", None): ("gram_matvec_symmetric", "gram_pair"),
    }[(kind, cd)]
    assert used[tri] == P and used[pair] == P * (P - 1) // 2
    assert sum(used.values()) == P + P * (P - 1) // 2
    ref = kernel_plain.gram_matmat_f64(kind, X, X, V.double(), 2.0, 0.7)
    assert _rel(got, ref) <= 2e-5


@pytest.mark.cuda
def test_cuda_entry_points_default_to_the_card(cuda_device):
    """Called as a JAX caller calls them, with no device, the embeddings,
    the Hadamard matrix and the interop converters make their tensors on
    the card."""
    from rlaopt_tpu_torch.ops import hadamard_matrix
    from rlaopt_tpu_torch.sketches import embeddings as emb

    made = [
        emb.gauss_embedding(0, 4, 6, torch.float32),
        emb.ortho_embedding(0, 4, 6, torch.float32),
        emb.sparse_sign_embedding(0, 4, 6, torch.float32),
        emb.srht_params(torch.Generator().manual_seed(0), 4, 6)[0],
        emb.left_embedding("sparse", torch.Generator().manual_seed(0), 4, 6, torch.float32),
        emb.right_embedding("ortho", torch.Generator().manual_seed(0), 4, 6, torch.float32),
        hadamard_matrix(4),
        interop.pcg_state(*[np.ones(3)] * 5, True).W,
    ]
    assert all(t.device.type == "cuda" for t in made)
