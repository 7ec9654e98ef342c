"""The hand-written CUDA Gram kernels against their plain PyTorch versions
(float64) on a card. Marked ``cuda``: they skip without one. This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain

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
        "gram_matmat": 1, "gram_matmat_comp": 1, "gram_matvec_symmetric": 0,
        "gram_matmat_tier": 0, "gram_matvec_symmetric_tier": 0,
        "gram_matmat_f64": 0, "gram_matvec_symmetric_f64": 0,
    }
    with pytest.raises(ValueError, match="k <= 16"):
        kernel_cuda.gram_matvec_symmetric("rbf", X, V, 1.0)
    with pytest.raises(NotImplementedError, match="takes torch.float32"):
        kernel_cuda.gram_matmat("rbf", X.double(), X.double(), V.double(), 1.0)
    with pytest.raises(NotImplementedError, match="_laplace_matmat"):
        kernel_cuda.gram_matmat("laplace", X, X, V, 1.0)
    assert kernel_cuda.launch_counts()["gram_matvec_symmetric"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["bf16x3", "bfloat16"])
@pytest.mark.parametrize("kind", SQDIST_KINDS)
@pytest.mark.parametrize("k", [1, 3, 16, 70])
def test_cuda_tiers_match_their_plain_versions(cuda_device, cd, kind, k):
    """K1b and K2b against the plain version of their tier (float32 on the
    card): 1e-5 of max|ref| where both contract in float32; where the
    one-pass tier re-rounds kernel values to bf16 (k > 16, and K2b's
    mirror at k >= 3), two bf16 steps of a product in a row
    (:func:`_reround_bound`). K2b on Matérn-1/2: its diagonal values are
    the square root of a cancelled float sum (measured 7.8e-5 on an H100),
    so the whole product is held to 1e-3, and the rows whose own row of V
    is zero, which hold no diagonal value, to the regular bound."""
    from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand

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
