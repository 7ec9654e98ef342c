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
        "gram_matmat": 1, "gram_matmat_comp": 1, "gram_matvec_symmetric": 0,
        "gram_matmat_tier": 0, "gram_matvec_symmetric_tier": 0,
        "gram_matmat_f64": 0, "gram_matvec_symmetric_f64": 0,
        "laplace_matmat": 0, "laplace_matmat_comp": 0, "laplace_matvec_symmetric": 0,
        "gram_pair": 0, "gram_pair_tier": 0, "laplace_pair": 0,
        "csr_spmv": 0, "csr_spmm": 0,
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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 16, 17, 500])
def test_cuda_laplace_matches_plain(cuda_device, k, monkeypatch):
    """K3 (with the default column splits and in one pass over m) and K3c
    against the float64 plain version at a ragged shape, d = 50 (three full
    16-feature stages and a ragged one), scalar and ARD lengthscales: K3
    2e-5, K3c 1e-10 of max|ref|, as K1 and K1c."""
    X1, X2, V = _data(14, 1000, 777, 50, k)
    X1, X2, V = (torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V))
    ard = torch.linspace(6.0, 10.0, 50, device=cuda_device)
    for ls in (8.0, ard):
        ref = kernel_plain.gram_matmat_f64("laplace", X1, X2, V, ls, 0.9)
        got = kernel_cuda.laplace_matmat(X1, X2, V, ls, 0.9)
        with monkeypatch.context() as mp:
            mp.setattr(kernel_cuda, "column_splits", lambda *a: 1)
            one = kernel_cuda.laplace_matmat(X1, X2, V, ls, 0.9)
        ls64 = ls.double() if torch.is_tensor(ls) else ls
        hi, lo = kernel_cuda.laplace_matmat_comp(X1, X2, V, ls64, 0.9)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= 2e-5
        assert _rel(one, ref) <= 2e-5
        assert _rel(hi.double() + lo.double(), ref) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_cuda_laplace_symmetric_matches_plain(cuda_device, k):
    """K5 against the float64 plain version: 2e-5, as K2 (fp32 atomics)."""
    rng = np.random.default_rng(15)
    X = torch.from_numpy(rng.standard_normal((1300, 28)).astype(np.float32)).to(cuda_device)
    V = torch.from_numpy(rng.standard_normal((1300, k)).astype(np.float32)).to(cuda_device)
    ref = kernel_plain.gram_matmat_f64("laplace", X, X, V, 32.0, 1.1)
    got = kernel_cuda.laplace_matvec_symmetric(X, V, 32.0, 1.1)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rbf", "laplace"])
def test_cuda_column_splits(cuda_device, kind, monkeypatch):
    """A few rows against many points: the narrow kernel cuts m into runs
    (column_splits) and sums their partials in a fixed order. Both the
    split and the one-pass product against float64: 2e-5; the split one
    gives the same bits twice."""
    rng = np.random.default_rng(16)
    X1 = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32)).to(cuda_device)
    X2 = torch.from_numpy(rng.standard_normal((200_000, 8)).astype(np.float32)).to(cuda_device)
    V = torch.from_numpy(rng.standard_normal((200_000, 2)).astype(np.float32)).to(cuda_device)
    assert kernel_cuda.column_splits(300, 200_000, 2, cuda_device) > 1
    ls = 3.0 if kind == "rbf" else 9.0
    if kind == "rbf":
        fn = lambda: kernel_cuda.gram_matmat("rbf", X1, X2, V, ls)  # noqa: E731
    else:
        fn = lambda: kernel_cuda.laplace_matmat(X1, X2, V, ls)  # noqa: E731
    ref = kernel_plain.gram_matmat_f64(kind, X1, X2, V, ls)
    split, again = fn(), fn()
    monkeypatch.setattr(kernel_cuda, "column_splits", lambda *a: 1)
    one = fn()
    torch.cuda.synchronize()
    assert torch.equal(split, again)
    assert _rel(split, ref) <= 2e-5
    assert _rel(one, ref) <= 2e-5


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
    from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand

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
    """K4 (K6 for Laplace) against the float64 plain pair at a ragged
    rectangle (n1 = 1000, n2 = 777, d = 3): both outputs within 2e-5 of
    max|ref|, K2's and K5's contract."""
    X1, X2, V2 = _data(13, 1000, 777, 3, k)
    V1 = np.random.default_rng(14).standard_normal((1000, k)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V2, V1)]
    if kind == "laplace":
        o1, o2 = kernel_cuda.laplace_pair(*args, 1.3, 0.9)
    else:
        o1, o2 = kernel_cuda.gram_pair(kind, *args, 1.3, 0.9)
    r1, r2 = kernel_plain.gram_pair(kind, *(a.double() for a in args), 1.3, 0.9)
    torch.cuda.synchronize()
    assert o1.shape == (1000, k) and o2.shape == (777, k)
    assert _rel(o1, r1) <= 2e-5 and _rel(o2, r2) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["bf16x3", "bfloat16"])
@pytest.mark.parametrize("kind", SQDIST_KINDS)
@pytest.mark.parametrize("k", [1, 3, 16])
def test_cuda_pair_tier_matches_plain(cuda_device, cd, kind, k):
    """K4b against the plain version of its tier: 1e-5 of max|ref| where
    both contract in float32 (the forward product, and the mirror at
    k ≤ 2); the one-pass tier's mirror at k ≥ 3 re-rounds kernel values to
    bf16 (:func:`_reround_bound`). Two distinct point sets hold no
    coincident points, so Matérn-1/2 has no cusp here."""
    from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand

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
    with pytest.raises(NotImplementedError, match="laplace"):
        kernel_cuda.gram_pair("laplace", X, X, V[:, :2], V[:, :2], 1.0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernel_cuda.laplace_pair(X.cpu(), X.cpu(), V[:, :2].cpu(), V[:, :2].cpu(), 1.0)
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
        ("laplace", None): ("laplace_matvec_symmetric", "laplace_pair"),
        ("rbf", "bf16x3"): ("gram_matvec_symmetric_tier", "gram_pair_tier"),
        ("matern32", None): ("gram_matvec_symmetric", "gram_pair"),
    }[(kind, cd)]
    assert used[tri] == P and used[pair] == P * (P - 1) // 2
    assert sum(used.values()) == P + P * (P - 1) // 2
    ref = kernel_plain.gram_matmat_f64(kind, X, X, V.double(), 2.0, 0.7)
    assert _rel(got, ref) <= 2e-5
