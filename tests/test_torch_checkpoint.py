"""Checkpoint and resume in the port, on the CPU: the JAX package's own
tests (``tests/solvers/test_checkpoint.py``) run in the port; a resumed
PCG, SAP (plain and accelerated) or LSQR solve equal bit for bit to the
uninterrupted one; and PCG checkpoints crossing between the packages in
the JAX package's ``.npz`` layout (its orbax path switched off)."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.models import LinSys as JLinSys
from rlaopt_tpu.preconditioners import NystromConfig as JNystromConfig
from rlaopt_tpu.preconditioners import nystrom as j_nys
from rlaopt_tpu.solvers import PCGConfig as JPCGConfig
from rlaopt_tpu.utils import checkpoint as j_ckpt
from rlaopt_tpu.utils.checkpoint import SolveCheckpointer as JSolveCheckpointer
from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
from rlaopt_tpu_torch.models import LinSys, LstSq
from rlaopt_tpu_torch.preconditioners import Nystrom, NystromConfig, SkPreConfig
from rlaopt_tpu_torch.solvers import LSQRConfig, PCGConfig, SAPAccelConfig, SAPConfig
from rlaopt_tpu_torch.solvers.pcg import PCGState
from rlaopt_tpu_torch.solvers.sap import SAPState
from rlaopt_tpu_torch.utils.checkpoint import SolveCheckpointer

RANK = 60


def _spd(n=80, k=2, seed=0):
    """JAX's fixture in numpy: A = Q diag(logspace(0, -4)) Qᵀ, B normal."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.logspace(0, -4, n)) @ Q.T
    A = (A + A.T) / 2
    return A, rng.standard_normal((n, k)), rng.standard_normal((n, RANK))


def _rel_res(entry):
    return np.asarray(entry["metrics"]["internal_metrics"]["rel_res"], np.float64)


# -- the checkpointer ----------------------------------------------------------
def test_checkpointer_roundtrip(tmp_path):
    """JAX's ``test_checkpointer_roundtrip`` in the port."""
    ck = SolveCheckpointer(str(tmp_path / "ck"))
    payload = {
        "state": {"W": torch.arange(6.0).reshape(3, 2)},
        "mask": torch.tensor([True, False]),
    }
    ck.save(10, payload)
    ck.save(20, payload)
    assert ck.latest_step() == 20
    restored, step = ck.restore(like=payload)
    assert step == 20
    assert torch.equal(restored["state"]["W"], payload["state"]["W"])
    assert torch.equal(restored["mask"], payload["mask"])
    assert restored["mask"].dtype == torch.bool
    again, step10 = ck.restore(10, like=payload)
    assert step10 == 10 and torch.equal(again["state"]["W"], payload["state"]["W"])


def test_restore_requires_like_and_a_checkpoint(tmp_path):
    ck = SolveCheckpointer(str(tmp_path / "empty"))
    assert ck.latest_step() is None and ck.restore_aux() is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ck.restore(like={"W": torch.zeros(1)})
    ck.save(3, {"W": torch.zeros(1)})
    with pytest.raises(ValueError, match="like"):
        ck.restore()
    assert ck.restore_aux(3) is None


def test_restore_casts_to_like_dtype_and_device(tmp_path):
    """Each leaf takes ``like``'s dtype and device (the meta device stands
    in for the card here); a Python int leaf (SAP's ``t``) comes back an
    int."""
    ck = SolveCheckpointer(str(tmp_path))
    W = torch.linspace(0, 1, 6, dtype=torch.float64).reshape(3, 2)
    state = SAPState(W=W, V=W * 2, Y=W * 3, t=7)
    ck.save(5, {"state": state, "mask": torch.tensor([True, True])},
            aux={"log": {0: {"x": torch.ones(2)}}, "cum_time": 1.5})
    like32 = SAPState(W=W.float(), V=W.float(), Y=W.float(), t=0)
    got, _ = ck.restore(like={"state": like32, "mask": torch.tensor([False, False])})
    assert isinstance(got["state"], SAPState)
    assert got["state"].W.dtype == torch.float32 and got["state"].t == 7
    assert isinstance(got["state"].t, int)
    assert torch.equal(got["state"].V, (W * 2).float())
    meta = SAPState(W=torch.empty(3, 2, device="meta", dtype=torch.float64), V=W, Y=W, t=0)
    got, _ = ck.restore(like={"state": meta, "mask": torch.tensor([False, False])})
    assert got["state"].W.device.type == "meta" and got["state"].V.device.type == "cpu"
    aux = ck.restore_aux()
    assert aux == {"log": {"0": {"x": [1.0, 1.0]}}, "cum_time": 1.5}


class _Pair(NamedTuple):
    b: object
    a: object


def test_leaf_order_is_jax_flatten_order(tmp_path):
    """Dict keys sorted, NamedTuple fields in declaration order, lists and
    tuples in order: the port's file holds its leaves where the JAX
    package's does, for the same payload."""
    arrays = [np.full(2, float(i)) for i in range(6)]
    tree = {"z": _Pair(b=arrays[0], a=arrays[1]), "a": [arrays[2], (arrays[3], None)],
            "m": {"y": arrays[4], "x": arrays[5]}}
    tck = SolveCheckpointer(str(tmp_path / "t"))
    tck.save(1, jax.tree_util.tree_map(torch.from_numpy, tree))
    jck = JSolveCheckpointer(str(tmp_path / "j"))
    jck._ocp = None
    jck.save(1, tree)
    tfile = np.load(tmp_path / "t" / "step_00000001.npz")
    jfile = np.load(tmp_path / "j" / "step_00000001.npz")
    assert tfile.files == jfile.files
    for name in jfile.files:
        assert np.array_equal(tfile[name], jfile[name])


# -- JAX's solve test, in the port ---------------------------------------------
def test_solve_checkpoint_and_resume(tmp_path):
    """JAX's ``test_solve_checkpoint_and_resume``: 8 PCG iterations with a
    checkpoint each round, then a resume that continues from iteration 8,
    its log holding the restored history and its clock continuing."""
    A, B, _ = _spd()
    A, B = torch.from_numpy(A), torch.from_numpy(B)
    reg = 1e-6
    ckdir = str(tmp_path / "solve_ck")
    cfg = PCGConfig(max_iters=8, rtol=1e-14, precond_config=NystromConfig(rank=RANK, rho=reg))
    sys1 = LinSys(A, B, reg=reg)
    _, log1 = sys1.solve(cfg, torch.zeros_like(B), callback_freq=2, key=0,
                         checkpoint_dir=ckdir, checkpoint_freq=1)
    ck = SolveCheckpointer(ckdir)
    assert ck.latest_step() == 8
    cfg2 = PCGConfig(max_iters=60, rtol=1e-8, precond_config=NystromConfig(rank=RANK, rho=reg))
    sys2 = LinSys(A, B, reg=reg)
    _, log2 = sys2.solve(cfg2, torch.zeros_like(B), callback_freq=2, key=0,
                         checkpoint_dir=ckdir, resume=True)
    assert min(log2.keys()) == 0
    assert 8 in log2 and max(log2.keys()) > 8
    assert all(isinstance(i, int) for i in log2)
    assert log2[8]["cum_time"] >= log1[8]["cum_time"]
    it = max(log2.keys())
    assert float(np.max(_rel_res(log2[it]))) < 1e-7


# -- a resumed solve is the uninterrupted one, bit for bit ----------------------
def _kernel_system(n=96, k=2, oracles=False, seed=3):
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.standard_normal((n, 4)))
    B = torch.from_numpy(rng.standard_normal((n, k)))
    K = RBFLinOp(X, X, KernelConfig(lengthscale=1.5))
    extra = (K.row_oracle, K.blk_oracle) if oracles else ()
    return lambda: LinSys(K, B, 0.05, *extra), B


def _lstsq_system():
    rng = np.random.default_rng(4)
    A = torch.from_numpy(rng.standard_normal((200, 24)) * np.logspace(0, -2, 24))
    B = torch.from_numpy(rng.standard_normal((200, 2)))
    return lambda: LstSq(A, B), torch.zeros((24, 2), dtype=torch.float64)


def _case(name):
    """(make the system, W_init, config of ``iters`` iterations)."""
    if name == "lsqr":
        make, W0 = _lstsq_system()
        return make, W0, lambda iters: LSQRConfig(
            max_iters=iters, rtol=1e-14, precond_config=SkPreConfig(sketch_size=96, rho=0.0))
    if name == "pcg":
        make, B = _kernel_system()
        return make, torch.zeros_like(B), lambda iters: PCGConfig(
            max_iters=iters, rtol=1e-14, precond_config=NystromConfig(rank=16, rho=0.05))
    make, B = _kernel_system(oracles=True)
    accel = name == "sap_accel"
    return make, torch.zeros_like(B), lambda iters: SAPConfig(
        max_iters=iters, rtol=1e-14, blk_sz=24, accel=accel, power_iters=5,
        accel_config=SAPAccelConfig(mu=0.05, nu=4.0) if accel else None,
        precond_config=NystromConfig(rank=8, rho=0.05))


@pytest.mark.parametrize("freq", [1, 2])
@pytest.mark.parametrize("name", ["pcg", "sap", "sap_accel", "lsqr"])
def test_resumed_solve_is_the_uninterrupted_one(name, freq, tmp_path):
    """10 iterations, a checkpoint each ``freq`` rounds of 5 (and at the
    end), then a resume to 20: W and the logged rel_res at 20 equal to the
    bits those of one uninterrupted 20-iteration solve; the log's keys are
    every boundary, all of them iteration numbers."""
    make, W0, cfg = _case(name)
    W_full, log_full = make().solve(cfg(20), W0.clone(), callback_freq=5, key=0)
    ckdir = str(tmp_path / name)
    make().solve(cfg(10), W0.clone(), callback_freq=5, key=0, checkpoint_dir=ckdir,
                 checkpoint_freq=freq)
    assert SolveCheckpointer(ckdir).latest_step() == 10
    W_res, log_res = make().solve(cfg(20), W0.clone(), callback_freq=5, key=0,
                                  checkpoint_dir=ckdir, resume=True)
    assert torch.equal(W_res, W_full)
    assert sorted(log_res) == sorted(log_full) == [0, 5, 10, 15, 20]
    assert np.array_equal(_rel_res(log_res[20]), _rel_res(log_full[20]))
    assert np.allclose(_rel_res(log_res[5]), _rel_res(log_full[5]), rtol=0, atol=0)
    assert SolveCheckpointer(ckdir).latest_step() == 20


def test_checkpoint_freq_counts_rounds(tmp_path):
    """``checkpoint_freq`` rounds between saves, and one at convergence."""
    make, W0, cfg = _case("pcg")
    ckdir = tmp_path / "freq"
    make().solve(cfg(20), W0, callback_freq=2, key=0, checkpoint_dir=str(ckdir),
                 checkpoint_freq=3)
    steps = sorted(int(p.name[5:13]) for p in ckdir.glob("*.npz"))
    assert steps == [6, 12, 18]
    conv = tmp_path / "conv"
    loose = PCGConfig(max_iters=40, rtol=1e-2, precond_config=NystromConfig(rank=16, rho=0.05))
    _, log = make().solve(loose, W0, callback_freq=1, key=0, checkpoint_dir=str(conv),
                          checkpoint_freq=100)
    assert [int(p.name[5:13]) for p in conv.glob("*.npz")] == [max(log)]


# -- PCG checkpoints cross between the packages ----------------------------------
@pytest.fixture
def jax_npz(monkeypatch):
    """The JAX package's checkpointer on its ``.npz`` path."""
    init = JSolveCheckpointer.__init__

    def npz_init(self, directory):
        init(self, directory)
        self._ocp = None

    monkeypatch.setattr(JSolveCheckpointer, "__init__", npz_init)
    assert j_ckpt.SolveCheckpointer is JSolveCheckpointer


def _pcg_pair(monkeypatch):
    """The same PCG solve in both packages: dense SPD A, the same injected
    Nyström sketch."""
    A, B, Omega = _spd()
    reg = 1e-6
    monkeypatch.setattr(j_nys, "right_embedding", lambda *a, **k: jnp.asarray(Omega))
    jsys = lambda: JLinSys(jnp.asarray(A), jnp.asarray(B), reg=reg)  # noqa: E731
    At = torch.from_numpy(A)
    P = Nystrom(NystromConfig(rank=RANK, rho=reg))
    P._update(At, Omega=torch.from_numpy(Omega))
    P._update_damping(baseline_rho=reg)
    tsys = lambda: LinSys(At, torch.from_numpy(B), reg=reg)  # noqa: E731

    def jsolve(iters, **kw):
        cfg = JPCGConfig(max_iters=iters, rtol=1e-14,
                         precond_config=JNystromConfig(rank=RANK, rho=reg))
        return jsys().solve(cfg, jnp.zeros(B.shape), callback_freq=2, key=0, **kw)

    def tsolve(iters, **kw):
        cfg = PCGConfig(max_iters=iters, rtol=1e-14,
                        precond_config=NystromConfig(rank=RANK, rho=reg))
        return tsys().solve(cfg, torch.zeros(B.shape, dtype=torch.float64), callback_freq=2,
                            key=0, preconditioner=P, **kw)

    return jsolve, tsolve


def _same_leaves(tmp_path, step):
    t = np.load(tmp_path / "t" / f"step_{step:08d}.npz")
    j = np.load(tmp_path / "j" / f"step_{step:08d}.npz")
    assert t.files == j.files == [f"leaf_{i}" for i in range(7)]
    return t, j


def test_jax_pcg_checkpoint_resumes_in_the_port(monkeypatch, jax_npz, tmp_path):
    """The JAX package writes 8 iterations of PCG (``.npz``); the port
    restores it with its own ``like`` and continues to 16. W at 16 against
    the JAX package's uninterrupted solve: 1e-10 of max|W| (float64
    round-off of two summation orders over 16 steps); the log from the JAX
    sidecar. rel_res is ‖r‖/‖b‖, held to 1e-9 of ‖b‖: at cond(A) ~ 1e6 the
    residual is a small difference of large terms (``test_torch_slice``)."""
    jsolve, tsolve = _pcg_pair(monkeypatch)
    jdir = str(tmp_path / "j")
    jsolve(8, checkpoint_dir=jdir, checkpoint_freq=1)
    like = {"state": PCGState(*(torch.zeros(1, dtype=torch.float64) for _ in range(5)),
                              ok=torch.zeros(2, dtype=torch.bool)),
            "mask": torch.zeros(2, dtype=torch.bool)}
    payload, step = SolveCheckpointer(jdir).restore(like=like)
    assert step == 8 and payload["state"].W.shape == (80, 2)
    assert payload["state"].ok.dtype == torch.bool
    tW, tlog = tsolve(16, checkpoint_dir=jdir, resume=True)
    jW, jlog = jsolve(16, checkpoint_dir=str(tmp_path / "j2"))
    assert sorted(tlog) == sorted(i for i in jlog if isinstance(i, int))
    jW = np.asarray(jW)
    assert np.abs(tW.numpy() - jW).max() <= 1e-10 * np.abs(jW).max()
    for i in (2, 8, 16):
        np.testing.assert_allclose(_rel_res(tlog[i]), _rel_res(jlog[i]), rtol=1e-8, atol=1e-9)


def test_port_pcg_checkpoint_resumes_in_jax(monkeypatch, jax_npz, tmp_path):
    """The reverse: the port writes 8 iterations, the JAX package resumes
    from its file to 16 (1e-10 of max|W| against the port's resume). Both
    packages' files at step 8 hold the same leaves in the same order, each
    to 1e-8 of its max|.|: Z = P⁻¹R and the directions carry the
    preconditioned system's conditioning (~1e6) times float64 round-off."""
    jsolve, tsolve = _pcg_pair(monkeypatch)
    tsolve(8, checkpoint_dir=str(tmp_path / "t"), checkpoint_freq=1)
    jsolve(8, checkpoint_dir=str(tmp_path / "j"), checkpoint_freq=1)
    t, j = _same_leaves(tmp_path, 8)
    for name in t.files:
        a, b = t[name].astype(np.float64), j[name].astype(np.float64)
        assert np.abs(a - b).max() <= 1e-8 * max(np.abs(b).max(), 1.0), name
    jW, _ = jsolve(16, checkpoint_dir=str(tmp_path / "t"), resume=True)
    tW, _ = tsolve(16, checkpoint_dir=str(tmp_path / "t"), resume=True)
    jW = np.asarray(jW)
    assert np.abs(tW.numpy() - jW).max() <= 1e-10 * np.abs(jW).max()
