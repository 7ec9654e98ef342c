"""The port's multi-process runtime against the JAX package, on the CPU.

Two fresh interpreters join through ``initialize_multihost`` with gloo
collectives and 4 CPU positions each (run as ``python
tests/test_torch_multihost.py worker <rank> <world> <port> <dir>``, once per
module, each under its own timeout). They compute, on the same numpy inputs
as the JAX package's sharded operators on the conftest's 8 devices:

* on the 2 × 4 ``("dcn", "i")`` mesh: the replicated and the hierarchical
  ring's matvec and adjoint, ``row_oracle`` and ``blk_oracle``
  (``tests/parallel/test_multihost.py:57-97``), ``from_dense`` in both
  modes, a Nyström-PCG solve (rank 16, 40 iterations,
  ``test_pcg_solve_2d``) and SAP steps;
* on a 1-D mesh of 8 positions over both processes: the symmetric
  half-ring's matvec, ``matmat_compensated``, ``matmat_f64`` and
  ``row_matmat_f64``, ``A1``, and ``sparse_shard_rows``' ragged local
  operators.

Each result is held to the JAX package (the tolerances of
``test_multihost.py``, or of the float64 tests of the port) or to the
dense float64 product, to the port's one-process mesh of the same shape
(bitwise: the same schedule adds the same partials in the same order),
and between the two ranks (bitwise). The runtime's pieces (the bytes an
entry crosses as, meshes over processes, the transport's choice, joining
without a cluster) are tested in this process.
"""

import os
import sys
import tempfile
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.kernels import KernelConfig as JKernelConfig
from rlaopt_tpu.kernels import ShardedRBFLinOp as JShardedRBFLinOp
from rlaopt_tpu.models import LinSys as JLinSys
from rlaopt_tpu.parallel import distributed as j_distributed
from rlaopt_tpu.parallel import make_mesh as j_make_mesh
from rlaopt_tpu.parallel import make_mesh_2d as j_make_mesh_2d
from rlaopt_tpu.preconditioners import NewtonConfig as JNewtonConfig
from rlaopt_tpu.preconditioners import NystromConfig as JNystromConfig
from rlaopt_tpu.preconditioners import nystrom as j_nys
from rlaopt_tpu.solvers import PCGConfig as JPCGConfig
from rlaopt_tpu.solvers import SAP as JSAP
from rlaopt_tpu.solvers import SAPAccelConfig as JSAPAccelConfig
from rlaopt_tpu_torch import parallel as t_parallel
from rlaopt_tpu_torch.kernels import KernelConfig, ShardedRBFLinOp
from rlaopt_tpu_torch.linops import ShardedLinOp
from rlaopt_tpu_torch.models import LinSys
from rlaopt_tpu_torch.parallel import (
    Mesh,
    initialize_multihost,
    make_mesh,
    make_mesh_2d,
    run_multiprocess_dryrun,
)
from rlaopt_tpu_torch.parallel.distributed import _free_port, run_children
from rlaopt_tpu_torch.preconditioners import NewtonConfig, Nystrom, NystromConfig
from rlaopt_tpu_torch.solvers import SAP, PCGConfig, SAPAccelConfig
from rlaopt_tpu_torch.sparse import SparseCSRTensor, sparse_shard_rows

AXES = ("dcn", "i")
WORLD, LOCAL = 2, 4
CHILD_TIMEOUT = 120
DTYPES = ("float32", "float64")
TOL = {"float32": 1e-4, "float64": 1e-8}  # tests/conftest.py's TOLERANCES
MODES = ("replicated", "ring")
CFG2 = dict(const_scaling=1.5, lengthscale=0.8)  # test_multihost.py's kernel config
CFG = dict(const_scaling=1.1, lengthscale=0.8)
BLK = [2, 7, 11, 30]
PCG_N, REG, RANK = 48, 1e-2, 16
SAP_BLK, SAP_STEPS = 8, 6


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _points(n, d, seed, dtype="float64"):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(dtype)


def _pcg_problem():
    rng = np.random.default_rng(20)
    X, B = rng.standard_normal((PCG_N, 3)), rng.standard_normal((PCG_N, 2))
    Omega = np.linalg.qr(rng.standard_normal((PCG_N, RANK)))[0]
    return X, B, Omega


ROWS = [0, 7, 21, 42, 49]


def _dense_problem():
    """A 61 × 37 matrix (ragged over 8 positions) and operands."""
    rng = np.random.default_rng(22)
    return rng.standard_normal((61, 37)), rng.standard_normal(37), rng.standard_normal(61)


def _sparse_matrix():
    import scipy.sparse as sp

    return sp.random(61, 37, density=0.2, format="csr", random_state=23, dtype=np.float64)


def _sap_schedule():
    rng = np.random.default_rng(21)
    return np.stack([rng.choice(PCG_N, SAP_BLK, replace=False) for _ in range(SAP_STEPS)])


def _compute(mesh2d: Mesh, mesh1d: Mesh) -> dict:
    """Every product and solve of the module on the port's meshes: the 2 ×
    4 mesh ``mesh2d`` and the 1-D mesh of 8 positions ``mesh1d``, of one
    process or spanning two. One intra-op thread (the CPU's matmul bits
    then do not depend on the thread count)."""
    t = torch.from_numpy
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for dt in DTYPES:
            X1, X2 = _points(41, 4, 1, dt), _points(29, 4, 2, dt)
            v, y = np.linspace(-1, 1, 29).astype(dt), np.ones(41, dt)
            for mode in MODES:
                A = ShardedRBFLinOp(t(X1), t(X2), KernelConfig(**CFG2), mesh=mesh2d, axis=AXES,
                                    memory_mode=mode)
                out[f"{dt}/{mode}/mv"] = (A @ t(v)).numpy()
                out[f"{dt}/{mode}/adj"] = (t(y) @ A).numpy()
                out[f"{dt}/{mode}/T"] = (A.T @ t(y)).numpy()
            X = _points(33, 3, 3, dt)
            A = ShardedRBFLinOp(t(X), t(X), KernelConfig(lengthscale=1.1), mesh=mesh2d, axis=AXES)
            blk = torch.tensor(BLK)
            out[f"{dt}/row"] = (A.row_oracle(blk) @ torch.ones(33, dtype=A.dtype)).numpy()
            out[f"{dt}/row_adj"] = (torch.ones(4, dtype=A.dtype) @ A.row_oracle(blk)).numpy()
            out[f"{dt}/blk"] = (A.blk_oracle(blk) @ torch.ones(4, dtype=A.dtype)).numpy()

        X = t(_points(43, 4, 6))
        V = t(np.random.default_rng(7).standard_normal((43, 3)))
        A = ShardedRBFLinOp(X, X, KernelConfig(**CFG), mesh=mesh1d, memory_mode="ring")
        out["half/mv"] = (A @ V).numpy()
        out["half/adj"] = (V.T @ A).numpy()
        Xc = t(_points(50, 3, 12, "float32"))
        Vc = t(np.random.default_rng(13).standard_normal((50, 2)).astype(np.float32))
        A = ShardedRBFLinOp(Xc, Xc, KernelConfig(const_scaling=1.3, lengthscale=0.9),
                            mesh=mesh1d, memory_mode="ring")
        hi, lo = A.matmat_compensated(Vc)
        out["half/comp_hi"], out["half/comp_lo"] = hi.numpy(), lo.numpy()
        out["half/f64"] = A.matmat_f64(Vc).numpy()
        out["half/row_f64"] = A.row_matmat_f64(torch.tensor(ROWS), Vc).numpy()
        out["half/A1"] = A.A1.numpy()

        M, x, yd = _dense_problem()
        for mode in ("row", "column"):
            D = ShardedLinOp.from_dense(t(M), mesh2d, mode=mode, axis=AXES)
            out[f"dense/{mode}/mv"] = (D @ t(x)).numpy()
            out[f"dense/{mode}/adj"] = (t(yd) @ D).numpy()
        S = sparse_shard_rows(SparseCSRTensor(_sparse_matrix(), device="cpu"), mesh1d)
        out["sparse/mv"] = (S @ t(x)).numpy()
        out["sparse/adj"] = (t(yd) @ S).numpy()

        Xp, Bp, Omega = _pcg_problem()
        K = ShardedRBFLinOp(t(Xp), t(Xp), KernelConfig(lengthscale=1.0), mesh=mesh2d, axis=AXES)
        cfg = PCGConfig(max_iters=40, rtol=1e-6, precond_config=NystromConfig(rank=RANK, rho=REG))
        P = Nystrom(cfg.precond_config)
        P._update(K, Omega=t(Omega))
        P._update_damping(baseline_rho=REG)
        W, log = LinSys(K, t(Bp), REG).solve(cfg, torch.zeros((PCG_N, 2), dtype=torch.float64),
                                             callback_freq=10, key=0, preconditioner=P)
        out["pcg/W"] = W.numpy()
        for i in log:
            if isinstance(i, int):
                out[f"pcg/rel_res/{i}"] = log[i]["metrics"]["internal_metrics"]["rel_res"].numpy()
        sys_ = LinSys(K, t(Bp), REG, K.row_oracle, K.blk_oracle)
        nu = PCG_N / SAP_BLK
        sap = SAP(sys_, torch.zeros((PCG_N, 2), dtype=torch.float64), NewtonConfig(rho=REG),
                  blk_sz=SAP_BLK, accel=True, accel_config=SAPAccelConfig(mu=0.2 / nu, nu=nu),
                  power_iters=10, key=0, _block_schedule=_sap_schedule())
        sap._run_chunk(SAP_STEPS)
        out["sap/W"] = sap.state.W.numpy()
    finally:
        torch.set_num_threads(threads)
    return out


def _worker(rank: int, world: int, port: int, out_dir: str):
    """A child: join, compute on the meshes that span both processes, save."""
    initialize_multihost(f"127.0.0.1:{port}", world, rank, local_device_ids=["cpu"] * LOCAL,
                         timeout=CHILD_TIMEOUT)
    mesh2d, mesh1d = make_mesh_2d(), make_mesh()
    assert mesh2d.shape == {"dcn": world, "i": LOCAL} and mesh1d.size == world * LOCAL
    assert mesh2d.local_positions == tuple(range(rank * LOCAL, (rank + 1) * LOCAL))
    out = _compute(mesh2d, mesh1d)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    t = mesh2d.transport
    print(f"rank {rank}: transport {t.name}, {t.calls} collectives, {t.seconds:.3f} s, "
          f"{t.bytes} bytes", flush=True)
    t_parallel.shutdown_multihost()


@pytest.fixture(scope="module")
def ranks():
    """The two children's results, by rank."""
    with tempfile.TemporaryDirectory() as out_dir:
        port = _free_port()
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
        env["OMP_NUM_THREADS"] = "1"
        run_children([[__file__, "worker", str(r), str(WORLD), str(port), out_dir]
                      for r in range(WORLD)], CHILD_TIMEOUT, env)
        results = []
        for r in range(WORLD):
            with np.load(Path(out_dir) / f"rank{r}.npz") as f:
                results.append(dict(f))
    return results


@pytest.fixture(scope="module")
def one_process():
    """The same computations on one process's 2 × 4 and 8-position meshes."""
    return _compute(make_mesh_2d(2, 4, devices=["cpu"] * 8), make_mesh(devices=["cpu"] * 8))


def _same_bits(ranks, one_process, keys):
    for key in keys:
        for r, res in enumerate(ranks):
            assert res[key].dtype == one_process[key].dtype, key
            np.testing.assert_array_equal(res[key], one_process[key], err_msg=f"rank {r} {key}")


# -- (b) the 2 × 4 mesh over two processes ------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", DTYPES)
def test_2d_matvec_and_adjoint_across_processes(ranks, one_process, dt, mode):
    """Replicated row slabs (adjoint: a psum over dcn and i) and the
    hierarchical ring (the fast axis inside a process, the slow one across),
    against JAX's 2 × 4 mesh within ``1e3 · tol``
    (``test_multihost.py::test_sharded_kernel_2d``)."""
    X1, X2 = _points(41, 4, 1, dt), _points(29, 4, 2, dt)
    J = JShardedRBFLinOp(jnp.asarray(X1), jnp.asarray(X2), JKernelConfig(**CFG2),
                         mesh=j_make_mesh_2d(n_dcn=2, n_ici=4), axis=AXES, memory_mode=mode)
    v, y = np.linspace(-1, 1, 29).astype(dt), np.ones(41, dt)
    rt = 1e3 * TOL[dt]
    res = ranks[0]
    np.testing.assert_allclose(res[f"{dt}/{mode}/mv"], np.asarray(J @ jnp.asarray(v)),
                               rtol=rt, atol=rt)
    np.testing.assert_allclose(res[f"{dt}/{mode}/adj"], np.asarray(jnp.asarray(y) @ J),
                               rtol=rt, atol=rt)
    np.testing.assert_allclose(res[f"{dt}/{mode}/T"], np.asarray(J.T @ jnp.asarray(y)),
                               rtol=rt, atol=rt)
    _same_bits(ranks, one_process, [f"{dt}/{mode}/{op}" for op in ("mv", "adj", "T")])


@pytest.mark.parametrize("dt", DTYPES)
def test_2d_oracles_across_processes(ranks, one_process, dt):
    """``row_oracle`` (column-distributed: one psum across processes) and
    ``blk_oracle`` (the block's rows gathered from their owners) against
    JAX's (``test_multihost.py::test_oracles_2d``)."""
    X = _points(33, 3, 3, dt)
    J = JShardedRBFLinOp(jnp.asarray(X), jnp.asarray(X), JKernelConfig(lengthscale=1.1),
                         mesh=j_make_mesh_2d(n_dcn=2, n_ici=4), axis=AXES)
    blk = jnp.asarray(BLK)
    rt = 1e3 * TOL[dt]
    res = ranks[0]
    np.testing.assert_allclose(res[f"{dt}/row"], np.asarray(J.row_oracle(blk) @ jnp.ones(33, dt)),
                               rtol=rt, atol=rt)
    np.testing.assert_allclose(res[f"{dt}/row_adj"],
                               np.asarray(jnp.ones(4, dt) @ J.row_oracle(blk)), rtol=rt, atol=rt)
    np.testing.assert_allclose(res[f"{dt}/blk"], np.asarray(J.blk_oracle(blk) @ jnp.ones(4, dt)),
                               rtol=rt, atol=rt)
    _same_bits(ranks, one_process, [f"{dt}/{op}" for op in ("row", "row_adj", "blk")])


# -- (c) the half-ring of 8 positions over two processes ----------------------
def test_half_ring_across_processes(ranks, one_process):
    """One data set on a 1-D ring of 8 positions, 4 in each process: each
    pair's carried shard (points, chunk, mirror accumulator) crosses the
    process boundary where the rotation does; against JAX's half-ring on its
    8 devices, float64 to 1e-10 of max|ref|."""
    X = _points(43, 4, 6)
    V = np.random.default_rng(7).standard_normal((43, 3))
    J = JShardedRBFLinOp(jnp.asarray(X), jnp.asarray(X), JKernelConfig(**CFG), mesh=j_make_mesh(),
                         memory_mode="ring")
    ref = np.asarray(J @ jnp.asarray(V))
    assert _rel(ranks[0]["half/mv"], ref) <= 1e-10
    assert _rel(ranks[0]["half/adj"], ref.T) <= 1e-10
    _same_bits(ranks, one_process, ["half/mv", "half/adj"])


def test_certified_half_ring_across_processes(ranks, one_process):
    """``matmat_compensated`` and ``matmat_f64`` on the half-ring across two
    processes, against the float64 product (1e-10 and 1e-12 of max|ref|)
    and the JAX package's compensated and value64 products (1e-6: on
    XLA:CPU they land 2.4e-7 and 5.2e-8 from the float64 product here)."""
    Xc = _points(50, 3, 12, "float32")
    Vc = np.random.default_rng(13).standard_normal((50, 2)).astype(np.float32)
    J = JShardedRBFLinOp(jnp.asarray(Xc), jnp.asarray(Xc),
                         JKernelConfig(const_scaling=1.3, lengthscale=0.9), mesh=j_make_mesh(),
                         memory_mode="ring")
    jh, jl = J.matmat_compensated(jnp.asarray(Vc))
    vh, vl = J.matmat_value64(jnp.asarray(Vc))
    X64 = Xc.astype(np.float64) / 0.9
    sq = (X64 ** 2).sum(1)
    want = 1.3 * np.exp(-0.5 * np.maximum(sq[:, None] + sq[None] - 2 * X64 @ X64.T, 0)) @ Vc
    res = ranks[0]
    comp = res["half/comp_hi"].astype(np.float64) + res["half/comp_lo"]
    assert _rel(comp, want) <= 1e-10
    assert _rel(comp, np.asarray(jh, np.float64) + np.asarray(jl)) <= 1e-6
    assert _rel(res["half/f64"], want) <= 1e-12
    assert _rel(res["half/f64"], np.asarray(vh, np.float64) + np.asarray(vl)) <= 1e-6
    _same_bits(ranks, one_process, ["half/comp_hi", "half/comp_lo", "half/f64"])


def test_row_oracle_f64_and_points_across_processes(ranks, one_process):
    """``row_matmat_f64`` (the rows gathered from their owners, K8 at each
    position, one psum across processes) against the float64 product's rows
    (1e-12), and ``A1`` gathered whole on every rank."""
    Xc = _points(50, 3, 12, "float32")
    Vc = np.random.default_rng(13).standard_normal((50, 2)).astype(np.float32)
    X64 = Xc.astype(np.float64) / 0.9
    sq = (X64 ** 2).sum(1)
    want = 1.3 * np.exp(-0.5 * np.maximum(sq[:, None] + sq[None] - 2 * X64 @ X64.T, 0)) @ Vc
    assert _rel(ranks[0]["half/row_f64"], want[ROWS]) <= 1e-12
    np.testing.assert_array_equal(ranks[0]["half/A1"], Xc)
    _same_bits(ranks, one_process, ["half/row_f64", "half/A1"])


def test_dense_and_ragged_local_ops_across_processes(ranks, one_process):
    """``from_dense`` in row and column mode on the 2 × 4 mesh, and
    ``sparse_shard_rows`` (ragged local operators: chunks of 8 rows and one
    of 5, their shapes gathered across processes) on the 8-position mesh,
    against the dense products (1e-12; ``test_multihost.py::
    test_sharded_dense_linop_2d``'s shape)."""
    M, x, y = _dense_problem()
    Ms = _sparse_matrix().toarray()
    res = ranks[0]
    for mode in ("row", "column"):
        assert _rel(res[f"dense/{mode}/mv"], M @ x) <= 1e-12
        assert _rel(res[f"dense/{mode}/adj"], y @ M) <= 1e-12
    assert _rel(res["sparse/mv"], Ms @ x) <= 1e-12
    assert _rel(res["sparse/adj"], y @ Ms) <= 1e-12
    _same_bits(ranks, one_process, [f"dense/{m}/{op}" for m in ("row", "column")
                                    for op in ("mv", "adj")] + ["sparse/mv", "sparse/adj"])


# -- (d) solves across two processes ------------------------------------------
def test_pcg_solve_across_processes(ranks, one_process, monkeypatch):
    """Nyström-PCG (rank 16, 40 iterations, rtol 1e-6) on the 2 × 4 mesh
    over two processes with the JAX package's sketch injected, float64,
    against JAX's 2-D solve: W to 1e-8; the logged rel_res to 1e-8 at 0 and
    10, within 10% at 20 (48 points: the residual of an almost exhausted
    Krylov space carries the round-off of the sums' order, 7% apart here),
    both below 1e-5 at the end (``test_pcg_solve_2d``). W and every
    rel_res bitwise on both ranks and as in one process."""
    X, B, Omega = _pcg_problem()
    monkeypatch.setattr(j_nys, "right_embedding", lambda *a, **k: jnp.asarray(Omega))
    J = JShardedRBFLinOp(jnp.asarray(X), jnp.asarray(X), JKernelConfig(lengthscale=1.0),
                         mesh=j_make_mesh_2d(n_dcn=2, n_ici=4), axis=AXES)
    jW, jlog = JLinSys(J, jnp.asarray(B), REG).solve(
        JPCGConfig(max_iters=40, rtol=1e-6, precond_config=JNystromConfig(rank=RANK, rho=REG)),
        jnp.zeros((PCG_N, 2)), callback_freq=10, key=0,
    )
    res = ranks[0]
    keys = sorted(int(k.split("/")[-1]) for k in res if k.startswith("pcg/rel_res/"))
    assert keys == sorted(i for i in jlog if isinstance(i, int))
    want = {i: np.asarray(jlog[i]["metrics"]["internal_metrics"]["rel_res"]) for i in keys}
    for i in (0, 10):
        np.testing.assert_allclose(res[f"pcg/rel_res/{i}"], want[i], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(res["pcg/rel_res/20"], want[20], rtol=0.1)
    assert max(res[f"pcg/rel_res/{keys[-1]}"].max(), want[keys[-1]].max()) < 1e-5
    assert _rel(res["pcg/W"], jW) <= 1e-8
    _same_bits(ranks, one_process, ["pcg/W"] + [f"pcg/rel_res/{i}" for i in keys])


def test_sap_steps_across_processes(ranks, one_process):
    """Accelerated SAP with Newton blocks on the sharded row and block
    oracles, the same block schedule in both packages: W after 6 steps to
    1e-10 of JAX's, bitwise on both ranks and as in one process."""
    X, B, _ = _pcg_problem()
    J = JShardedRBFLinOp(jnp.asarray(X), jnp.asarray(X), JKernelConfig(lengthscale=1.0),
                         mesh=j_make_mesh_2d(n_dcn=2, n_ici=4), axis=AXES)
    nu = PCG_N / SAP_BLK
    js = JSAP(JLinSys(J, jnp.asarray(B), REG, J.row_oracle, J.blk_oracle), jnp.zeros((PCG_N, 2)),
              JNewtonConfig(rho=REG), blk_sz=SAP_BLK, accel=True,
              accel_config=JSAPAccelConfig(mu=0.2 / nu, nu=nu), power_iters=10, key=0,
              _block_schedule=_sap_schedule())
    js._run_chunk(SAP_STEPS)
    assert _rel(ranks[0]["sap/W"], js.state.W) <= 1e-10
    assert not np.allclose(ranks[0]["sap/W"], 0.0)
    _same_bits(ranks, one_process, ["sap/W"])


# -- (a) the dryrun, (e) joining, (f) one process -----------------------------
def test_run_multiprocess_dryrun_on_cpu_positions():
    """Two fresh interpreters × 4 CPU positions: the 2-D products in both
    memory modes, a PCG step and a SAP step, W bitwise on both ranks."""
    run_multiprocess_dryrun(n_procs=2, n_local=4, timeout=CHILD_TIMEOUT, device="cpu")


def test_initialize_multihost_without_a_cluster(monkeypatch):
    """No argument and no torchrun environment: a warning, one process. An
    explicit incomplete call raises at once (before any socket waits) and
    leaves no process group."""
    import torch.distributed as dist

    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.warns(UserWarning, match="single-process"):
        initialize_multihost()
    assert t_parallel.process_count() == 1 and t_parallel.process_index() == 0
    for kwargs in ({"num_processes": 2, "process_id": 0},
                   {"coordinator_address": "127.0.0.1:1", "process_id": 0},
                   {"coordinator_address": "127.0.0.1:1", "num_processes": 2, "process_id": 2}):
        with pytest.raises(ValueError):
            initialize_multihost(**kwargs)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(ValueError, match="unset"):
        initialize_multihost()
    assert not dist.is_initialized()


def test_one_process_mesh_is_all_local():
    """A mesh of one process: every position local, home its first, no
    transport; the exports and parameters of the JAX package's."""
    import inspect

    mesh = make_mesh_2d(2, 3, devices=["cpu"] * 6)
    assert mesh.local_positions == tuple(range(6)) and mesh.transport is None
    assert all(mesh.is_local(p) for p in range(6)) and mesh.home == torch.device("cpu")
    assert mesh.map(lambda p: p) == list(range(6))
    for name in j_distributed.__all__:
        jparams = list(inspect.signature(getattr(j_distributed, name)).parameters)
        tparams = list(inspect.signature(getattr(t_parallel, name)).parameters)
        assert tparams[: len(jparams)] == jparams, name
    assert inspect.signature(run_multiprocess_dryrun).parameters["device"].default is None
    with pytest.raises(ValueError, match="owns as many"):
        Mesh(["cpu"] * 3, ("i",), owners=[0, 0, 1],
             transport=t_parallel.Transport("gloo", 0, 2))


# -- the pieces, in one process ------------------------------------------------
def test_entries_cross_as_aligned_bytes():
    """An entry (a ``PointSet`` with bf16 tier parts, one with the tile's
    operand, a tuple, a dict, None, tensors of mixed widths) packs into one
    byte buffer, each tensor at an aligned offset, and unpacks from its
    template to the same bits; a value that is not a tensor cannot cross."""
    from rlaopt_tpu_torch.ops.kernel_cuda import tile_operand
    from rlaopt_tpu_torch.ops.kernel_dispatch import PointSet
    from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand
    from rlaopt_tpu_torch.parallel import mesh as t_mesh

    X = torch.from_numpy(_points(5, 3, 30, "float32"))
    entry = ((PointSet(X, tier_operand(X, "bf16x3")), None,
              PointSet(X, tile=tile_operand(X, 2.0))),
             {"v": torch.arange(3, dtype=torch.float64), "i": torch.tensor([7])},
             torch.ones(1, dtype=torch.bool))
    buf = t_mesh._pack(entry, torch.device("cpu"))
    assert buf.dtype == torch.uint8 and buf.numel() == t_mesh._nbytes(entry)
    assert buf.numel() % t_mesh._ALIGN == 0
    got = t_mesh._unpack(buf.clone(), entry, torch.device("cpu"))
    want, back = t_mesh._leaves(entry), t_mesh._leaves(got)
    assert len(back) == len(want) == 9 and got[0][1] is None
    assert got[0][0].tile is None and got[0][2].tier is None
    for a, b in zip(back, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    with pytest.raises(TypeError, match="cannot cross"):
        t_mesh._pack((X, 3), torch.device("cpu"))


@pytest.mark.parametrize("rank", [0, 1])
def test_meshes_over_processes(monkeypatch, rank):
    """With a runtime of 2 processes × 3 CPU positions (no collective is
    needed to build a mesh): ``make_mesh_2d()`` is 2 × 3, process r owning
    row r; ``make_mesh()`` the 6 positions in a row; ``shard_rows`` places
    this process's blocks only; a grid that leaves positions out raises."""
    from rlaopt_tpu_torch.parallel import distributed as t_distributed
    from rlaopt_tpu_torch.parallel import shard_rows

    transport = t_parallel.Transport("gloo", rank, 2)
    monkeypatch.setattr(t_distributed, "_runtime",
                        t_distributed._Runtime(transport, [torch.device("cpu")] * 3))
    assert t_parallel.process_index() == rank and t_parallel.process_count() == 2
    mesh = make_mesh_2d()
    assert mesh.shape == {"dcn": 2, "i": 3} and mesh.owners == (0, 0, 0, 1, 1, 1)
    assert mesh.local_positions == tuple(range(3 * rank, 3 * rank + 3))
    assert mesh.transport is transport and mesh.home == torch.device("cpu")
    flat = make_mesh()
    assert flat.shape == {"i": 6} and flat.local_positions == mesh.local_positions
    assert make_mesh_2d(1, 6).shape == {"dcn": 1, "i": 6}
    x = torch.arange(12.0)[:, None]
    placed = shard_rows(x, mesh, axis=("dcn", "i"))
    for p in range(6):
        if mesh.is_local(p):
            assert torch.equal(placed[p], x[2 * p:2 * p + 2])
        else:
            assert placed[p] is None
    with pytest.raises(ValueError, match="spans all their 6 positions"):
        make_mesh_2d(2, 2)
    with pytest.raises(ValueError, match="spans all their 6 positions"):
        make_mesh(4)


@pytest.mark.parametrize("layout,want", [
    ((("h", ["a"]), ("h", ["b"])), "nccl"),          # a card each
    ((("h", ["a", "a"]), ("h", ["a", "a"])), "gloo"),  # one card, two processes
    ((("h", ["a"]), ("g", ["a"])), "nccl"),          # same UUID string, two hosts
    ((("h", [None]), ("h", [None])), "gloo"),        # CPU positions
])
def test_transport_follows_the_layout(monkeypatch, layout, want):
    """NCCL only where every position is on a card that no other process
    holds; gloo (staged through the host) otherwise."""
    import torch.distributed as dist

    from rlaopt_tpu_torch.parallel.distributed import _choose_transport

    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    assert _choose_transport(list(layout)) == want


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    warnings.simplefilter("ignore")
    _worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
