"""The port's sparse tensors, CSR/CSC products and sparse operators against
the JAX package on the CPU, on the same numpy buffers (float64, 1e-12
relative): the JAX XLA products, its lane-aligned Pallas kernel (#9, in
interpret mode, as ``tests/sparse/test_laned.py`` runs it) and scipy. Also:
the transposed-CSR cache, the default device, the CPU routing, the sparse-
sign embedding's single allocation, and a source guard (no module of the
port mentions torch's sparse tensors or imports JAX or the JAX package)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rlaopt_tpu.sparse import SparseCSRTensor as JSparseCSRTensor
from rlaopt_tpu.sparse import ops as jops
from rlaopt_tpu.sparse import sparse_aslinop as j_sparse_aslinop
from rlaopt_tpu.sparse.laned import csr_to_laned, laned_matmat, laned_matvec
from rlaopt_tpu_torch import interop
from rlaopt_tpu_torch.models import LinSys
from rlaopt_tpu_torch.ops import kernel_cuda
from rlaopt_tpu_torch.preconditioners import NystromConfig
from rlaopt_tpu_torch.sketches import sparse_sign_embedding
from rlaopt_tpu_torch.solvers import PCGConfig
from rlaopt_tpu_torch.sparse import SparseCSRTensor, _Layout, _SparseTensor, sparse_aslinop
from rlaopt_tpu_torch.sparse import ops as tops

M, N, K = 37, 29, 3
TOL = 1e-12
REPO = Path(__file__).resolve().parent.parent


def _csr(seed=0, m=M, n=N):
    """A random CSR with empty rows (every fifth), a repeated column in row
    1 and rows of up to 8 entries; float64 values."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 9, m)
    lengths[::5] = 0
    lengths[1] = max(lengths[1], 3)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    indices = rng.integers(0, n, indptr[-1]).astype(np.int32)
    indices[indptr[1] + 1] = indices[indptr[1]]
    values = rng.standard_normal(indptr[-1])
    return values, indices, indptr


def _scipy(values, indices, indptr, shape=(M, N)):
    return sp.csr_matrix((values, indices, indptr), shape=shape)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _operand(rows, ndim, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(rows if ndim == 1 else (rows, K))


@pytest.mark.parametrize("ndim", [1, 2])
@pytest.mark.parametrize("layout", ["csr", "csc"])
def test_csr_csc_products_match_jax_laned_and_scipy(layout, ndim):
    """The plain CSR and CSC products against JAX ``ops`` (impl="xla"), the
    lane-aligned kernel (``laned_matvec`` / ``laned_matmat``) and scipy. The
    CSC case reads the same buffers as the CSC of Aᵀ."""
    values, indices, indptr = _csr()
    A = _scipy(values, indices, indptr)
    t = [torch.from_numpy(a) for a in (values, indptr.astype(np.int64), indices)]
    j = [jnp.asarray(a) for a in (values, indptr, indices)]
    if layout == "csr":
        x, n_out, mat = _operand(N, ndim), M, A
        fn, jfn = (
            (tops.csr_matvec, jops.csr_matvec) if ndim == 1 else (tops.csr_matmat, jops.csr_matmat)
        )
    else:
        x, n_out, mat = _operand(M, ndim), N, A.T.tocsr()
        fn, jfn = (
            (tops.csc_matvec, jops.csc_matvec) if ndim == 1 else (tops.csc_matmat, jops.csc_matmat)
        )
    got = fn(*t, torch.from_numpy(x), n_out).numpy()
    laned = csr_to_laned(mat.data, mat.indptr, mat.indices, mat.shape[1])
    if ndim == 1:
        j_laned = laned_matvec(laned, jnp.asarray(x), n_out, interpret=True)
    else:
        j_laned = laned_matmat(laned, jnp.asarray(x), n_out, interpret=True)
    assert got.shape == (n_out,) if ndim == 1 else (n_out, K)
    assert _rel(got, jfn(*j, jnp.asarray(x), n_out, impl="xla")) <= TOL
    assert _rel(got, j_laned) <= TOL
    assert _rel(got, mat @ x) <= TOL


@pytest.mark.parametrize("ndim", [1, 2])
def test_tensor_products_match_jax(ndim):
    """``A @ x``, ``A.T @ y`` and ``y @ A`` of the tensor against the JAX
    package's tensor; 2-D left operands are (k, m)."""
    values, indices, indptr = _csr(2)
    A = _scipy(values, indices, indptr)
    tA = SparseCSRTensor(A, device="cpu")
    jA = JSparseCSRTensor(A)
    x, y = _operand(N, ndim, 3), _operand(M, ndim, 4)
    yl = y if ndim == 1 else y.T
    assert _rel((tA @ torch.from_numpy(x)).numpy(), jA @ jnp.asarray(x)) <= TOL
    assert _rel((tA.T @ torch.from_numpy(y)).numpy(), jA.T @ jnp.asarray(y)) <= TOL
    assert _rel((torch.from_numpy(yl) @ tA).numpy(), jnp.asarray(yl) @ jA) <= TOL
    assert _rel((tA.T.T @ torch.from_numpy(x)).numpy(), A @ x) <= TOL


def test_gather_rows_and_slicing_match_jax():
    values, indices, indptr = _csr(5)
    A = _scipy(values, indices, indptr)
    sel = np.array([4, 0, 1, 1, 36, 10, 5])
    got = tops.gather_rows(
        torch.from_numpy(values), torch.from_numpy(indptr.astype(np.int64)),
        torch.from_numpy(indices), sel,
    )
    ref = jops.gather_rows(jnp.asarray(values), jnp.asarray(indptr), jnp.asarray(indices), sel)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    tA, jA = SparseCSRTensor(A, device="cpu"), JSparseCSRTensor(A)
    for idx in (slice(2, 30, 3), 7, [3, -1, 0], torch.tensor([8, 8, 2])):
        jidx = idx.numpy() if isinstance(idx, torch.Tensor) else idx
        t_rows, j_rows = tA[idx], jA[jidx]
        assert t_rows.shape == j_rows.shape
        np.testing.assert_array_equal(t_rows.todense().numpy(), np.asarray(j_rows.todense()))
    with pytest.raises(NotImplementedError, match="CSR layout"):
        tA.T[0]
    with pytest.raises(IndexError, match="out of bounds"):
        tA[[M]]


def test_scipy_round_trip_todense_astype():
    values, indices, indptr = _csr(6)
    A = _scipy(values, indices, indptr)
    tA = SparseCSRTensor(A, device="cpu")
    assert tA.indices.dtype == torch.int32 and tA.indptr.dtype == torch.int64
    assert tA.nnz == A.nnz and tA.shape == A.shape and tA.dtype == torch.float64
    back = tA.to_scipy()
    assert (back != A).nnz == 0
    np.testing.assert_array_equal(tA.todense().numpy(), A.toarray())
    np.testing.assert_array_equal(tA.T.todense().numpy(), A.toarray().T)
    assert (tA.T.to_scipy() != A.T).nnz == 0
    f32 = tA.astype(torch.float32)
    assert f32.dtype == torch.float32 and f32.indices is tA.indices
    raw = SparseCSRTensor(values, indices, indptr, A.shape, device="cpu")
    np.testing.assert_array_equal(raw.todense().numpy(), A.toarray())
    csc = interop.sparse_tensor(values, indices, indptr, (N, M), layout="csc", device="cpu")
    np.testing.assert_array_equal(csc.todense().numpy(), A.toarray().T)
    from_csc = _SparseTensor.from_scipy(A.tocsc(), device="cpu")
    assert from_csc.layout == _Layout.CSC and from_csc.shape == A.shape
    np.testing.assert_array_equal(from_csc.todense().numpy(), A.toarray())


def test_matmul_errors_match_jax():
    A = _scipy(*_csr(7))
    tA, jA = SparseCSRTensor(A, device="cpu"), JSparseCSRTensor(A)
    for bad in (np.zeros((N, 2, 2)), np.zeros(N + 1), np.zeros((2, M + 1)), np.zeros(M + 1)):
        left = bad.ndim == 2 and bad.shape[0] == 2 or bad.shape == (M + 1,)
        with pytest.raises(ValueError) as t_err:
            (torch.from_numpy(bad) @ tA) if left else (tA @ torch.from_numpy(bad))
        with pytest.raises(ValueError) as j_err:
            (jnp.asarray(bad) @ jA) if left else (jA @ jnp.asarray(bad))
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(TypeError, match="requires either a scipy CSR matrix"):
        SparseCSRTensor(np.zeros(3), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        SparseCSRTensor(np.ones(1), np.array([N]), np.array([0, 1]), (1, N), device="cpu")
    for indptr in ([0, 2, 1, 2], [1, 1, 1, 2], [0, 1, 1, 1]):
        with pytest.raises(ValueError, match="indptr must rise"):
            SparseCSRTensor(np.ones(2), np.array([0, 1]), np.array(indptr), (3, N),
                            device="cpu")


@pytest.mark.parametrize("ndim", [1, 2])
def test_sparse_aslinop_matches_jax_laned(ndim):
    """Forward and adjoint of the operator (two CSR copies) against the JAX
    operator on the lane-aligned kernel, ``impl="laned"``."""
    A = _scipy(*_csr(8))
    op = sparse_aslinop(SparseCSRTensor(A, device="cpu"))
    jop = j_sparse_aslinop(JSparseCSRTensor(A), impl="laned")
    x, y = _operand(N, ndim, 9), _operand(M, ndim, 10)
    yl = y if ndim == 1 else y.T
    assert op.shape == (M, N) and op.dtype == torch.float64
    assert _rel((op @ torch.from_numpy(x)).numpy(), jop @ jnp.asarray(x)) <= TOL
    assert _rel((torch.from_numpy(yl) @ op).numpy(), jnp.asarray(yl) @ jop) <= TOL
    assert _rel((op.T @ torch.from_numpy(y)).numpy(), A.T @ y) <= TOL
    dense = sparse_aslinop(SparseCSRTensor(A, device="cpu"), impl="dense")
    assert _rel((dense @ torch.from_numpy(x)).numpy(), A @ x) <= TOL


@pytest.mark.parametrize("impl", ["ell", "laned", "bogus"])
def test_tpu_layouts_raise(impl):
    A = SparseCSRTensor(_scipy(*_csr()), device="cpu")
    match = "TPU layout" if impl != "bogus" else "impl must be"
    with pytest.raises(ValueError, match=match):
        sparse_aslinop(A, impl=impl)


def test_transposed_csr_built_once(monkeypatch):
    """``A @ x``, then ``A.T @ y``, ``y @ A`` and the operator over A share
    one transposed CSR, built at the first adjoint product."""
    built = []
    real = tops.csr_transpose

    def counting(*args):
        built.append(args[-1])
        return real(*args)

    monkeypatch.setattr(tops, "csr_transpose", counting)
    values, indices, indptr = _csr(11)
    A = _scipy(values, indices, indptr)
    tA = SparseCSRTensor(A, device="cpu")
    x, y = torch.from_numpy(_operand(N, 1)), torch.from_numpy(_operand(M, 1))
    tA @ x
    assert built == []
    tA.T @ y
    y @ tA
    tA.T @ y[:, None]
    op = sparse_aslinop(tA)
    op.T @ y
    assert built == [N]
    assert _rel((op.T @ y).numpy(), A.T @ y.numpy()) <= TOL


def test_csr_transpose_matches_scipy():
    values, indices, indptr = _csr(12)
    A = _scipy(values, indices, indptr)
    tv, ti, tp = tops.csr_transpose(
        torch.from_numpy(values), torch.from_numpy(indptr.astype(np.int64)),
        torch.from_numpy(indices), N,
    )
    At = A.T.tocsr()
    assert ti.dtype == torch.int32 and tp.dtype == torch.int64
    np.testing.assert_array_equal(tp.numpy(), At.indptr)
    np.testing.assert_array_equal(ti.numpy(), At.indices)
    np.testing.assert_array_equal(tv.numpy(), At.data)


def test_plain_version_streams_in_blocks(monkeypatch):
    """The plain product in blocks of a few nonzeros gives the unblocked
    result to rounding."""
    values, indices, indptr = _csr(13)
    t = [torch.from_numpy(a) for a in (values, indptr.astype(np.int64), indices)]
    X = torch.from_numpy(_operand(N, 2, 14))
    whole = tops.csr_matmat(*t, X, M)
    monkeypatch.setattr(tops, "PLAIN_BLOCK_BYTES", 5 * K * 8)
    assert _rel(tops.csr_matmat(*t, X, M).numpy(), whole.numpy()) <= TOL
    assert _rel(tops.csc_matmat(*t, torch.from_numpy(_operand(M, 2)), N).numpy(),
                _scipy(values, indices, indptr).T @ _operand(M, 2)) <= TOL


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SparseCSRTensor(_scipy(*_csr()))
    assert SparseCSRTensor(_scipy(*_csr()), device="cpu").device.type == "cpu"


def test_from_scipy_defaults_to_the_card(monkeypatch):
    """``from_scipy`` places the tensor as ``SparseCSRTensor`` does: on the
    card unless the caller asks for the host, raising without a card; what
    is not a scipy matrix raises the JAX package's TypeError first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = _scipy(*_csr())
    for cls in (SparseCSRTensor, _SparseTensor):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls.from_scipy(A)
        with pytest.raises(TypeError, match="scipy sparse matrix"):
            cls.from_scipy(A.toarray())
        on_host = cls.from_scipy(A.tocsc(), device="cpu")
        assert on_host.device.type == "cpu" and on_host.layout == _Layout.CSC


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the CUDA wrappers; a CUDA-less call to
    them raises instead of falling back."""

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel")

    A = _scipy(*_csr(15))
    tA = SparseCSRTensor(A, device="cpu")
    x = torch.from_numpy(_operand(N, 2))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernel_cuda.csr_spmm(tA.values, tA.indptr, tA.indices, x, M)
    monkeypatch.setattr(kernel_cuda, "csr_spmv", refuse)
    monkeypatch.setattr(kernel_cuda, "csr_spmm", refuse)
    assert _rel((tA @ x).numpy(), A @ x.numpy()) <= TOL
    assert _rel((tA.T @ torch.ones(M, dtype=torch.float64)).numpy(), A.T @ np.ones(M)) <= TOL


def test_linsys_wraps_a_sparse_tensor():
    """``LinSys`` takes a sparse tensor as the JAX package's does
    (``_wrap_sparse``): PCG on a sparse SPD matrix."""
    n = 60
    rng = np.random.default_rng(16)
    S = sp.random(n, n, density=0.2, format="csr", random_state=16)
    G = (S @ S.T + sp.eye(n)).tocsr()
    b = rng.standard_normal(n)
    sys_ = LinSys(SparseCSRTensor(G, device="cpu"), torch.from_numpy(b), reg=1e-8)
    cfg = PCGConfig(max_iters=200, rtol=1e-11, precond_config=NystromConfig(rank=20, rho=1e-8))
    W, _ = sys_.solve(cfg, torch.zeros((n, 1), dtype=torch.float64), key=0)
    ref = np.linalg.solve(G.toarray() + 1e-8 * np.eye(n), b)
    np.testing.assert_allclose(W[:, 0].numpy(), ref, atol=1e-8)


@pytest.mark.parametrize("s", [3, 20])
def test_sparse_sign_embedding_scaled_before_the_scatter(s):
    """Scaling the ±1 values by ζ^-1/2 before the scatter gives the bits of
    the former scatter-then-scale formula (one (s, d) matrix, not two)."""
    d = 50
    got = sparse_sign_embedding(torch.Generator().manual_seed(17), s, d, device="cpu")
    g = torch.Generator().manual_seed(17)
    zeta = 8 if s >= 8 else s
    z = 2.0 * torch.randint(0, 2, (zeta, d), generator=g).to(torch.float32) - 1.0
    rows = torch.randint(0, s, (zeta, d), generator=g)
    Omega = torch.zeros((s, d))
    Omega[rows, torch.arange(d).expand(zeta, d)] = z
    assert torch.equal(got, Omega * zeta**-0.5)


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|rlaopt_tpu)(\s|\.|$)", re.M)
# torch's sparse namespace, not this package's ``rlaopt_tpu_torch.sparse``
_TORCH_SPARSE = re.compile(r"(?<![\w.])torch\.sparse")


def test_port_never_mentions_torch_sparse_or_imports_jax():
    """cuSPARSE stays a yardstick of ``chip_smoke.py``: no module of the port
    mentions torch's sparse tensors, and none imports JAX or the JAX
    package (``chip_smoke.py`` imports neither either)."""
    sources = sorted((REPO / "rlaopt_tpu_torch").rglob("*.py"))
    assert len(sources) > 40
    for path in sources:
        text = path.read_text()
        assert _TORCH_SPARSE.search(text) is None, path
        assert _IMPORT.search(text) is None, path
    assert _IMPORT.search((REPO / "chip_smoke.py").read_text()) is None


# Mean row length (entries) -> lanes a row of #9's short-row schedule at k ≤
# 16: the power of two in [2, 32] nearest above a quarter of the mean (about
# four entries a lane), a block of 256 threads from 256 entries on.
LANES_BY_MEAN = [(0, 2), (1, 2), (8, 2), (9, 4), (16, 4), (17, 8), (32, 8), (33, 16),
                 (64, 16), (65, 32), (128, 32), (255, 32), (256, 256), (16384, 256)]


@pytest.mark.parametrize("mean, lanes", LANES_BY_MEAN)
def test_csr_lanes_follow_the_mean_row_length(mean, lanes):
    n_rows = 1000
    assert kernel_cuda.spmm_lanes(n_rows, mean * n_rows, 1) == lanes
    assert kernel_cuda.spmm_lanes(n_rows, mean * n_rows, 16) == lanes


def test_csr_lanes_of_path_s_and_the_wide_schedule():
    """Path S's forward CSR (2^20 rows of 16) takes 4 lanes a row, its
    adjoint (1,024 rows of 16,384) a block a row; past 16 columns the wide
    schedule's warp per (row, column tile) does not read the value."""
    assert kernel_cuda.spmm_lanes(1 << 20, 16 << 20, 1) == 4
    assert kernel_cuda.spmm_lanes(1024, 16 << 20, 10) == kernel_cuda.CSR_BLOCK_ROW
    assert kernel_cuda.spmm_lanes(1 << 20, 16 << 20, 17) == 32
    assert kernel_cuda.spmm_lanes(0, 0, 1) == 2
