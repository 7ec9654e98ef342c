"""The sharded operators of the port on meshes of CPU positions, against the
JAX package on its 8-device CPU mesh (``tests/conftest.py``) and against the
port's single-device float64 operators, on the same numpy inputs.

A mesh of P CPU positions (``make_mesh(devices=["cpu"] * P)``) runs every
schedule the card runs with P positions of one device, in process, for any
P: the JAX package can run only its full 8-device platform in process
(``tests/parallel/test_sharded.py:370``). Float64 results are held to
1e-10 of max|ref| (the orders of the sums differ by shard), the iterates of
a solve to 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlaopt_tpu_torch.kernels.sharded as t_sharded
from rlaopt_tpu.kernels import KernelConfig as JKernelConfig
from rlaopt_tpu.kernels import ShardedRBFLinOp as JShardedRBFLinOp
from rlaopt_tpu.models import LinSys as JLinSys
from rlaopt_tpu.parallel import make_mesh as j_make_mesh
from rlaopt_tpu.preconditioners import NystromConfig as JNystromConfig
from rlaopt_tpu.preconditioners import nystrom as j_nys
from rlaopt_tpu.solvers import PCGConfig as JPCGConfig
from rlaopt_tpu_torch import interop
from rlaopt_tpu_torch.kernels import (
    DistributedRBFLinOp,
    KernelConfig,
    LaplaceLinOp,
    Matern32LinOp,
    RBFLinOp,
    ShardedLaplaceLinOp,
    ShardedMatern32LinOp,
    ShardedRBFLinOp,
)
from rlaopt_tpu_torch.linops import (
    DistributedSymmetricLinOp,
    ShardedLinOp,
    TwoSidedLinOp,
    aslinop,
)
from rlaopt_tpu_torch.models import LinSys
from rlaopt_tpu_torch.parallel import (
    make_mesh,
    make_mesh_2d,
    ppermute,
    psum,
)
from rlaopt_tpu_torch.preconditioners import Nystrom, NystromConfig
from rlaopt_tpu_torch.solvers import PCGConfig
from rlaopt_tpu_torch.sparse import SparseCSRTensor, sparse_shard_rows

F64 = 1e-10
CFG = dict(const_scaling=1.1, lengthscale=0.8)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the products here are a few hundred points
    wide, where starting a thread pool per call costs more than the work
    (a 260 x 260 Gram tile took 10x longer on 8 threads than on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpu_mesh(P):
    return make_mesh(devices=["cpu"] * P)


def _points(n, d=4, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(dtype)


@pytest.fixture
def pair_calls(monkeypatch):
    """Counts of the sharded operator's pair and triangle products."""
    calls = {"pair": 0, "triangle": 0}
    real_pair, real_mm = t_sharded.kernel_pair, t_sharded.kernel_matmat

    def pair(*a, **kw):
        calls["pair"] += 1
        return real_pair(*a, **kw)

    def mm(*a, symmetric=False, **kw):
        calls["triangle"] += bool(symmetric)
        return real_mm(*a, symmetric=symmetric, **kw)

    monkeypatch.setattr(t_sharded, "kernel_pair", pair)
    monkeypatch.setattr(t_sharded, "kernel_matmat", mm)
    return calls


# -- the mesh ----------------------------------------------------------------
def test_mesh_collectives_and_errors():
    mesh = make_mesh_2d(2, 3, devices=["cpu"] * 6)
    assert mesh.shape == {"dcn": 2, "i": 3} and mesh.size == 6
    parts = [torch.tensor([float(p)]) for p in range(6)]
    # the fast axis rotates within a row, the slow one moves whole rows
    assert [int(t) for t in ppermute(parts, mesh, "i")] == [2, 0, 1, 5, 3, 4]
    assert [int(t) for t in ppermute(parts, mesh, "dcn")] == [3, 4, 5, 0, 1, 2]
    assert [int(t) for t in ppermute(parts, mesh, "i", -1)] == [1, 2, 0, 4, 5, 3]
    assert float(psum(parts, torch.device("cpu"))) == 15.0
    with pytest.raises(ValueError, match="requested 9 devices but only 6 exist"):
        make_mesh(9, devices=["cpu"] * 6)
    assert make_mesh(4, devices=["cpu"] * 6).size == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


# -- ShardedLinOp ------------------------------------------------------------
@pytest.mark.parametrize("mode", ["row", "column"])
@pytest.mark.parametrize("n,m", [(64, 40), (61, 37)])  # even and ragged over 8
def test_sharded_dense_semantics(mode, n, m):
    rng = np.random.default_rng(n)
    M = torch.from_numpy(rng.standard_normal((n, m)))
    A = ShardedLinOp.from_dense(M, _cpu_mesh(8), mode=mode)
    x, X = torch.from_numpy(rng.standard_normal(m)), torch.from_numpy(rng.standard_normal((m, 3)))
    y, Y = torch.from_numpy(rng.standard_normal(n)), torch.from_numpy(rng.standard_normal((4, n)))
    assert A.padded_shape == ((64, m) if mode == "row" else (n, 40))
    for got, ref in ((A @ x, M @ x), (A @ X, M @ X), (y @ A, y @ M), (Y @ A, Y @ M),
                     (A.T @ y, M.T @ y), (x @ A.T, x @ M.T)):
        assert got.shape == ref.shape and _rel(got, ref) <= F64
    assert A.T.shape == (m, n) and A.T.mode != A.mode


@pytest.mark.parametrize("mode", ["row", "column"])
def test_ragged_local_ops_match_dense(mode):
    """Eight unequal per-position chunks (the reference's ``torch.chunk``
    ergonomics) reproduce the dense product through ``gather_idx``."""
    sizes = [7, 3, 9, 5, 8, 2, 6, 4]
    n = sum(sizes)
    shape = (n, 24) if mode == "row" else (24, n)
    M = torch.from_numpy(np.random.default_rng(1).standard_normal(shape))
    chunks = torch.split(M, sizes, dim=0 if mode == "row" else 1)
    A = ShardedLinOp.from_local_ops([aslinop(c) for c in chunks], _cpu_mesh(8), mode=mode)
    assert A.shape == M.shape and A.gather_idx is not None
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(M.shape[1]))
    X = torch.from_numpy(rng.standard_normal((M.shape[1], 3)))
    y = torch.from_numpy(rng.standard_normal(M.shape[0]))
    Y = torch.from_numpy(rng.standard_normal((4, M.shape[0])))
    for got, ref in ((A @ x, M @ x), (A @ X, M @ X), (y @ A, y @ M), (Y @ A, Y @ M),
                     (A.T @ y, M.T @ y), (x @ A.T, x @ M.T)):
        assert _rel(got, ref) <= F64
    with pytest.raises(ValueError, match="one local op per device"):
        ShardedLinOp.from_local_ops([aslinop(c) for c in chunks[:3]], _cpu_mesh(8))


def test_symmetric_alias_and_local_ops_without_adjoint():
    G = torch.from_numpy(np.random.default_rng(3).standard_normal((32, 32)))
    A = DistributedSymmetricLinOp.from_dense(G + G.T, _cpu_mesh(8), mode="row")
    assert A.T is A
    A.shutdown()
    from rlaopt_tpu_torch.linops import LinOp

    ops = [LinOp((4, 5), lambda x, M=M: M @ x) for M in torch.ones((2, 4, 5)).double()]
    B = ShardedLinOp.from_local_ops(ops, _cpu_mesh(2))
    assert torch.equal(B @ torch.ones(5).double(), torch.full((8,), 5.0).double())
    with pytest.raises(TypeError, match="no rmatvec"):
        torch.ones(8).double() @ B


# -- ShardedKernelLinOp ------------------------------------------------------
def _jax_op(X1, X2, mode, mesh=None):
    j1 = jnp.asarray(X1)
    j2 = j1 if X2 is None else jnp.asarray(X2)
    return JShardedRBFLinOp(j1, j2, JKernelConfig(**CFG), mesh=mesh or j_make_mesh(),
                            memory_mode=mode)


@pytest.mark.parametrize("mode", ["replicated", "ring"])
def test_kernel_op_matches_jax_two_data_sets(mode):
    """Distinct data sets (n = 41, m = 29, ragged over 8 positions): the
    row-slab and psum of replicated mode, the general ring's forward and
    adjoint sweeps, against the JAX operator on its 8 devices."""
    X1, X2 = _points(41, seed=1), _points(29, seed=2)
    V = np.random.default_rng(3).standard_normal((29, 3))
    A = ShardedRBFLinOp(torch.from_numpy(X1), torch.from_numpy(X2), KernelConfig(**CFG),
                        mesh=_cpu_mesh(8), memory_mode=mode)
    J = _jax_op(X1, X2, mode)
    assert A.padded_shape == tuple(J.padded_shape) == (48, 32)
    assert _rel(A @ torch.from_numpy(V), J @ jnp.asarray(V)) <= F64
    single = RBFLinOp(torch.from_numpy(X1), torch.from_numpy(X2), KernelConfig(**CFG))
    Y = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 41)))
    assert _rel(Y @ A, Y @ single) <= F64
    assert _rel(A.T @ Y.T, single.T @ Y.T) <= F64
    assert DistributedRBFLinOp is ShardedRBFLinOp


@pytest.mark.parametrize("P", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("n", [64, 43])  # exact and ragged shards
def test_half_ring_matches_single_device(P, n, pair_calls):
    """One data set in ring mode: each unordered shard pair once through
    the pair product (P(P − 1)/2 of them, the even-P antipodal step taken
    by half the positions), each diagonal block through the triangle, one
    rotation home; forward, adjoint, 1-D and 2-D against the single-device
    float64 operator."""
    X = torch.from_numpy(_points(n))
    V = torch.from_numpy(np.random.default_rng(5).standard_normal((n, 3)))
    A = ShardedRBFLinOp(X, X, KernelConfig(**CFG), mesh=_cpu_mesh(P), memory_mode="ring")
    ref = RBFLinOp(X, X, KernelConfig(**CFG)) @ V
    got = A @ V
    assert pair_calls == {"pair": P * (P - 1) // 2, "triangle": P}
    assert _rel(got, ref) <= F64
    assert _rel(A @ V[:, 0], ref[:, 0]) <= F64
    assert _rel(V.T @ A, ref.T) <= F64
    assert _rel(A.T @ V, ref) <= F64


def test_half_ring_matches_jax_and_laplace():
    """The half-ring on 8 positions against the JAX operator's (which takes
    it on its 8 devices), and the Laplace family's half-ring (K5 and K6 on
    a card) at odd P against its single-device operator."""
    X = _points(43, seed=6)
    V = np.random.default_rng(7).standard_normal((43, 3))
    Xt = torch.from_numpy(X)
    A = ShardedRBFLinOp(Xt, Xt, KernelConfig(**CFG), mesh=_cpu_mesh(8), memory_mode="ring")
    assert _rel(A @ torch.from_numpy(V), _jax_op(X, None, "ring") @ jnp.asarray(V)) <= F64
    L = ShardedLaplaceLinOp(Xt, Xt, KernelConfig(**CFG), mesh=_cpu_mesh(3), memory_mode="ring")
    ref = LaplaceLinOp(Xt, Xt, KernelConfig(**CFG)) @ torch.from_numpy(V)
    assert _rel(L @ torch.from_numpy(V), ref) <= F64


def test_distinct_data_keeps_general_ring(pair_calls):
    """Symmetry is object identity: equal but distinct data sets keep the
    general ring (no pair product)."""
    X = torch.from_numpy(_points(40, d=3))
    A = ShardedRBFLinOp(X, X.clone(), KernelConfig(lengthscale=1.0), mesh=_cpu_mesh(4),
                        memory_mode="ring")
    v = torch.linspace(0, 1, 40, dtype=torch.float64)
    ref = RBFLinOp(X, X, KernelConfig(lengthscale=1.0)) @ v
    assert _rel(A @ v, ref) <= F64
    assert pair_calls == {"pair": 0, "triangle": 0}


def test_2d_mesh_ring_is_hierarchical():
    """A tuple axis over a 2 x 3 mesh: the hierarchical ring (the fast axis
    every step, the slow one per inner cycle) for one data set and two."""
    mesh = make_mesh_2d(2, 3, devices=["cpu"] * 6)
    X = torch.from_numpy(_points(43, seed=8))
    V = torch.from_numpy(np.random.default_rng(9).standard_normal((43, 2)))
    ref = RBFLinOp(X, X, KernelConfig(**CFG)) @ V
    for X2 in (X, X.clone()):
        A = ShardedRBFLinOp(X, X2, KernelConfig(**CFG), mesh=mesh, axis=("dcn", "i"),
                            memory_mode="ring")
        assert _rel(A @ V, ref) <= F64 and _rel(V.T @ A, ref.T) <= F64
    with pytest.raises(ValueError, match="explicit mesh"):
        ShardedRBFLinOp(X, X, KernelConfig(**CFG), axis=("dcn", "i"))


def test_oracles_and_oracle_only_mode():
    X = torch.from_numpy(_points(40, d=3, seed=10))
    cfg = KernelConfig(lengthscale=1.2)
    A = ShardedMatern32LinOp(X, X, cfg, mesh=_cpu_mesh(3))
    single = Matern32LinOp(X, X, cfg)
    blk = torch.tensor([2, 9, 17, 33, 39])
    W = torch.from_numpy(np.random.default_rng(11).standard_normal((40, 2)))
    row = A.row_oracle(blk)
    assert row.shape == (5, 40)
    assert _rel(row @ W, single.row_oracle(blk) @ W) <= F64
    assert _rel(W[:5].T @ row, W[:5].T @ single.row_oracle(blk)) <= F64
    assert _rel(A.blk_oracle(blk) @ W[:5], single.blk_oracle(blk) @ W[:5]) <= F64
    B = ShardedRBFLinOp(X, X, cfg, mesh=_cpu_mesh(3), use_full_kernel=False)
    with pytest.raises(RuntimeError, match="use_full_kernel=False"):
        B @ W
    assert _rel(B.row_oracle(blk) @ W, RBFLinOp(X, X, cfg).row_oracle(blk) @ W) <= F64


@pytest.mark.parametrize("mode", ["replicated", "ring"])
def test_matmat_compensated_and_value64(mode):
    """float32 points ragged over 8 positions: the compensated pair (TwoSum
    across the ring's visits) and the float64 ring (value64) against the
    float64 product; 1-D operands round-trip."""
    X = torch.from_numpy(_points(50, d=3, seed=12, dtype=np.float32))
    V = torch.from_numpy(np.random.default_rng(13).standard_normal((50, 2)).astype(np.float32))
    cfg = KernelConfig(const_scaling=1.3, lengthscale=0.9)
    A = ShardedRBFLinOp(X, X, cfg, mesh=_cpu_mesh(8), memory_mode=mode)
    want = RBFLinOp(X.double(), X.double(), cfg) @ V.double()
    hi, lo = A.matmat_compensated(V)
    assert hi.shape == lo.shape == (50, 2) and hi.dtype == torch.float32
    assert _rel(hi.double() + lo.double(), want) <= F64
    h1, _ = A.matmat_compensated(V[:, 0])
    assert h1.shape == (50,) and _rel(h1, hi[:, 0]) <= 1e-7
    vh, vl = A.matmat_value64(V)
    assert _rel(vh.double() + vl.double(), want) <= 1e-14
    assert _rel(A.matmat_f64(V[:, 0]), want[:, 0]) <= 1e-14


def test_sparse_shard_rows():
    import scipy.sparse as sp

    M = sp.random(61, 37, density=0.2, format="csr", random_state=4, dtype=np.float64)
    S = SparseCSRTensor(M, device="cpu")
    A = sparse_shard_rows(S, _cpu_mesh(3))  # chunks of 21, 21, 19 rows
    D = torch.from_numpy(M.toarray())
    rng = np.random.default_rng(14)
    x, X = torch.from_numpy(rng.standard_normal(37)), torch.from_numpy(rng.standard_normal((37, 3)))
    y = torch.from_numpy(rng.standard_normal(61))
    for got, ref in ((A @ x, D @ x), (A @ X, D @ X), (y @ A, y @ D), (A.T @ y, D.T @ y)):
        assert _rel(got, ref) <= 1e-12
    with pytest.raises(ValueError, match="empty shards"):
        sparse_shard_rows(SparseCSRTensor(M[:2], device="cpu"), _cpu_mesh(3))
    with pytest.raises(ValueError, match="CSR layout"):
        sparse_shard_rows(S.T, _cpu_mesh(3))


# -- solves ------------------------------------------------------------------
def test_sharded_refinement_matches_single_device():
    """A float32 KRR solve with two float64 refinement rounds on the
    device's route (``"accel"``) reaches the same float64-grade solution
    sharded (replicated on 8 positions, and the half-ring on 4) as on one
    device, through the sharded branches: the compensated metrics, the
    float64 ring, the update-mode sampled certificate's column-distributed
    rows."""
    n, d = 260, 4
    rng = np.random.default_rng(15)
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32))
    reg, cfg = 1e-3, KernelConfig(lengthscale=float(d) ** 0.5)
    pcg = PCGConfig(max_iters=200, rtol=1e-6, precond_config=NystromConfig(rank=64, rho=reg))
    sols = {}
    for name, A, residual in (
        ("single", RBFLinOp(X, X, cfg), "evaluate"),
        ("replicated", ShardedRBFLinOp(X, X, cfg, mesh=_cpu_mesh(8)), "evaluate"),
        ("ring", ShardedRBFLinOp(X, X, cfg, mesh=_cpu_mesh(4), memory_mode="ring"), "update"),
    ):
        W64, log = LinSys(A, B, reg=reg).solve(
            pcg, torch.zeros_like(B), key=0, f64_refine_rounds=2,
            f64_refine_device="accel", f64_refine_residual=residual,
        )
        assert W64.dtype == torch.float64
        assert max(log["f64_refine"]["rel_res_f64"][-1]) < 1e-6, (name, log["f64_refine"])
        sols[name] = W64
    for name in ("replicated", "ring"):
        assert _rel(sols[name], sols["single"]) < 1e-6


def test_config5_pcg_matches_jax_f64(monkeypatch):
    """Config 5's solve at a small size (``benchmarks/run.py::
    config5_sharded_krr``: the replicated sharded RBF operator at ℓ = √d,
    reg 1e-4·n, Nyström-PCG) in float64 with the same injected sketch, the
    JAX operator on its 8 devices, the port's on 8 CPU positions: every
    logged rel_res and W to 1e-8."""
    n, d, rank, reg = 256, 8, 32, 1e-4 * 256
    rng = np.random.default_rng(16)
    X = rng.standard_normal((n, d))
    y = np.tanh(X @ rng.standard_normal(d)) + 0.1 * rng.standard_normal(n)
    Omega = np.linalg.qr(rng.standard_normal((n, rank)))[0]
    monkeypatch.setattr(j_nys, "right_embedding", lambda *a, **k: jnp.asarray(Omega))
    Xj = jnp.asarray(X)
    jK = JShardedRBFLinOp(Xj, Xj, JKernelConfig(lengthscale=d**0.5), mesh=j_make_mesh())
    jW, jlog = JLinSys(jK, jnp.asarray(y), reg).solve(
        JPCGConfig(max_iters=20, rtol=1e-12,
                   precond_config=JNystromConfig(rank=rank, rho=reg)),
        jnp.zeros((n, 1)), callback_freq=10, key=0,
    )
    Xt = torch.from_numpy(X)
    K = ShardedRBFLinOp(Xt, Xt, KernelConfig(lengthscale=d**0.5), mesh=_cpu_mesh(8))
    cfg = PCGConfig(max_iters=20, rtol=1e-12, precond_config=NystromConfig(rank=rank, rho=reg))
    P = Nystrom(cfg.precond_config)
    P._update(K, Omega=torch.from_numpy(Omega))
    P._update_damping(baseline_rho=reg)
    tW, tlog = LinSys(K, torch.from_numpy(y), reg).solve(
        cfg, torch.zeros((n, 1), dtype=torch.float64), callback_freq=10, key=0,
        preconditioner=P,
    )
    assert sorted(tlog) == sorted(jlog) == [0, 10, 20]
    for i in jlog:
        np.testing.assert_allclose(
            tlog[i]["metrics"]["internal_metrics"]["rel_res"].numpy(),
            np.asarray(jlog[i]["metrics"]["internal_metrics"]["rel_res"]),
            rtol=1e-8, atol=1e-8,
        )
    assert _rel(tW, jW) <= 1e-8


def test_interop_sharded_operator_from_jax_payload():
    """The port's operator rebuilt from a JAX ring operator's payload."""
    X = _points(37, seed=17)
    J = _jax_op(X, None, "ring")
    A = interop.sharded_kernel_operator(
        np.asarray(J.A1), np.asarray(J._data["ls"]), J._scale, J.kind, J.memory_mode,
        J.mesh.devices.size, device="cpu",
    )
    assert A.memory_mode == "ring" and A.mesh.size == 8 and A.shape == (37, 37)
    v = np.random.default_rng(18).standard_normal(37)
    ref = RBFLinOp(torch.from_numpy(X), torch.from_numpy(X), KernelConfig(**CFG))
    assert _rel(A @ torch.from_numpy(v), ref @ torch.from_numpy(v)) <= F64
    assert isinstance(A, TwoSidedLinOp)
