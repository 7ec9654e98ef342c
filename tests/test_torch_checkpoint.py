"""Checkpoint and resume in the port, on the CPU: the JAX package's own
tests (``tests/solvers/test_checkpoint.py``) run in the port; a resumed
PCG, SAP (plain and accelerated) or LSQR solve equal bit for bit to the
uninterrupted one; and PCG and SAP checkpoints crossing between the
packages in the JAX package's ``.npz`` layout (its orbax path switched
off)."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.models import LinSys as JLinSys
from rlaopt_tpu.preconditioners import NystromConfig as JNystromConfig
from rlaopt_tpu.preconditioners import nystrom as j_nys
from rlaopt_tpu.kernels import KernelConfig as JKernelConfig
from rlaopt_tpu.kernels import RBFLinOp as JRBFLinOp
from rlaopt_tpu.sketches.embeddings import right_embedding as j_right_embedding
from rlaopt_tpu.solvers import PCGConfig as JPCGConfig
from rlaopt_tpu.solvers import SAP as JSAP
from rlaopt_tpu.solvers import SAPAccelConfig as JSAPAccelConfig
from rlaopt_tpu.solvers import SAPConfig as JSAPConfig
from rlaopt_tpu.solvers import factory as j_factory
from rlaopt_tpu.solvers.sap import SAPState as JSAPState
from rlaopt_tpu.utils import checkpoint as j_ckpt
from rlaopt_tpu.utils.checkpoint import SolveCheckpointer as JSolveCheckpointer
from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
from rlaopt_tpu_torch.models import LinSys, LstSq
from rlaopt_tpu_torch.preconditioners import Nystrom, NystromConfig, SkPreConfig
from rlaopt_tpu_torch.solvers import LSQRConfig, PCGConfig, SAP, SAPAccelConfig, SAPConfig
from rlaopt_tpu_torch.solvers import factory as t_factory
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
    key = torch.tensor([0, 9], dtype=torch.int64)
    state = SAPState(W=W, V=W * 2, Y=W * 3, key=key, t=7)
    ck.save(5, {"state": state, "mask": torch.tensor([True, True])},
            aux={"log": {0: {"x": torch.ones(2)}}, "cum_time": 1.5})
    like32 = SAPState(W=W.float(), V=W.float(), Y=W.float(), key=key * 0, t=0)
    got, _ = ck.restore(like={"state": like32, "mask": torch.tensor([False, False])})
    assert isinstance(got["state"], SAPState)
    assert got["state"].W.dtype == torch.float32 and got["state"].t == 7
    assert isinstance(got["state"].t, int)
    assert torch.equal(got["state"].V, (W * 2).float())
    assert torch.equal(got["state"].key, key)
    meta = SAPState(W=torch.empty(3, 2, device="meta", dtype=torch.float64), V=W, Y=W,
                    key=key, t=0)
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


# -- SAP checkpoints cross between the packages ----------------------------------
SAP_N, SAP_BLK, SAP_RANK, SAP_REG = 96, 24, 8, 0.05


def _jax_sap_draws(steps):
    """The JAX solver's (sketch, power-iteration start) of steps 0 … steps−1
    from ``PRNGKey(0)``: ``split(state.key, 4)`` each step."""
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(steps):
        key, _k_blk, k_prec, k_pow = jax.random.split(key, 4)
        Omega = j_right_embedding("ortho", k_prec, SAP_RANK, SAP_BLK, jnp.float64)
        v0 = jax.random.normal(k_pow, (SAP_BLK,), dtype=jnp.float64)
        draws.append((torch.from_numpy(np.array(Omega)), torch.from_numpy(np.array(v0))))
    return draws


def _sap_pair(monkeypatch, port_draws):
    """Accelerated SAP with Nyström blocks on the same RBF system in both
    packages, the same block schedule in both; the port's step t takes
    ``port_draws(t)``."""
    rng = np.random.default_rng(41)
    X, B = rng.standard_normal((SAP_N, 4)), rng.standard_normal((SAP_N, 2))
    sched = np.stack([rng.choice(SAP_N, SAP_BLK, replace=False) for _ in range(20)])
    monkeypatch.setattr(j_factory, "SAP",
                        lambda *a, **kw: JSAP(*a, _block_schedule=sched, **kw))
    monkeypatch.setattr(t_factory, "SAP", lambda *a, **kw: SAP(
        *a, _block_schedule=sched, _draws=port_draws, **kw))
    jK = JRBFLinOp(jnp.asarray(X), jnp.asarray(X), JKernelConfig(lengthscale=1.5))
    tK = RBFLinOp(torch.from_numpy(X), torch.from_numpy(X), KernelConfig(lengthscale=1.5))

    def jsolve(iters, **kw):
        cfg = JSAPConfig(max_iters=iters, rtol=1e-14, blk_sz=SAP_BLK, power_iters=5,
                         accel_config=JSAPAccelConfig(mu=0.05, nu=4.0),
                         precond_config=JNystromConfig(rank=SAP_RANK, rho=SAP_REG))
        sys_ = JLinSys(jK, jnp.asarray(B), SAP_REG, jK.row_oracle, jK.blk_oracle)
        return sys_.solve(cfg, jnp.zeros(B.shape), callback_freq=5, key=0, metrics="true",
                          **kw)

    def tsolve(iters, **kw):
        cfg = SAPConfig(max_iters=iters, rtol=1e-14, blk_sz=SAP_BLK, power_iters=5,
                        accel_config=SAPAccelConfig(mu=0.05, nu=4.0),
                        precond_config=NystromConfig(rank=SAP_RANK, rho=SAP_REG))
        sys_ = LinSys(tK, torch.from_numpy(B), SAP_REG, tK.row_oracle, tK.blk_oracle)
        return sys_.solve(cfg, torch.zeros(B.shape, dtype=torch.float64), callback_freq=5,
                          key=0, metrics="true", **kw)

    return jsolve, tsolve


def _sap_like(pkg):
    if pkg == "jax":
        z = jnp.zeros(1)
        return {"state": JSAPState(z, z, z, jnp.zeros(2, jnp.uint32), jnp.asarray(0)),
                "mask": jnp.zeros(2, bool)}
    z = torch.zeros(1, dtype=torch.float64)
    return {"state": SAPState(z, z, z, torch.zeros(2, dtype=torch.int64), 0),
            "mask": torch.zeros(2, dtype=torch.bool)}


def test_jax_sap_checkpoint_resumes_in_the_port(monkeypatch, jax_npz, tmp_path):
    """The JAX package writes 10 accelerated SAP iterations; the port reads
    back W, V, Y, the key and t exactly, resumes from its file and runs 5
    more, with the block schedule and JAX's draws of steps 10–14 pinned (the
    key streams differ by design). W, V and Y at 15 against JAX's
    uninterrupted solve: 1e-10 of max|·|, ``test_torch_sap``'s tolerance."""
    draws = _jax_sap_draws(15)
    jsolve, tsolve = _sap_pair(monkeypatch, lambda t: draws[t])
    jdir = str(tmp_path / "j")
    jsolve(10, checkpoint_dir=jdir, checkpoint_freq=1)
    jpay, _ = JSolveCheckpointer(jdir).restore(like=_sap_like("jax"))
    tpay, step = SolveCheckpointer(jdir).restore(like=_sap_like("torch"))
    assert step == 10 and tpay["state"].t == int(jpay["state"].t) == 10
    for name in ("W", "V", "Y", "key"):
        assert np.array_equal(getattr(tpay["state"], name).numpy(),
                              np.asarray(getattr(jpay["state"], name))), name
    assert np.array_equal(tpay["mask"].numpy(), np.asarray(jpay["mask"]))
    assert not torch.equal(tpay["state"].V, tpay["state"].W)

    states = {}
    real_train = LinSys._train

    def keep_state(self, logger, termination_fn, solver, *a, **kw):
        out = real_train(self, logger, termination_fn, solver, *a, **kw)
        states["port"] = solver.state
        return out

    monkeypatch.setattr(LinSys, "_train", keep_state)
    tW, tlog = tsolve(15, checkpoint_dir=jdir, resume=True)
    jstates = {}
    real_jtrain = JLinSys._train

    def keep_jstate(self, logger, termination_fn, solver, *a, **kw):
        out = real_jtrain(self, logger, termination_fn, solver, *a, **kw)
        jstates["jax"] = solver.state
        return out

    monkeypatch.setattr(JLinSys, "_train", keep_jstate)
    jW, jlog = jsolve(15, checkpoint_dir=str(tmp_path / "j2"))
    assert sorted(tlog) == sorted(i for i in jlog if isinstance(i, int)) == [0, 5, 10, 15]
    assert states["port"].t == 15
    for name in ("W", "V", "Y"):
        got = getattr(states["port"], name).numpy()
        ref = np.asarray(getattr(jstates["jax"], name))
        assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max(), name


def test_port_sap_checkpoint_resumes_in_jax(monkeypatch, jax_npz, tmp_path):
    """The reverse: the port writes 10 iterations (JAX's draws of steps 0–9
    pinned), the JAX package reads back W, V, Y and t exactly and resumes
    from the port's key ``[0, 0]``, which is ``PRNGKey(0)``: its steps
    10–14 draw what its steps 0–4 drew, and the port's uninterrupted solve
    is given those. W at 15: 1e-10 of max|W|."""
    draws = _jax_sap_draws(10)
    jsolve, tsolve = _sap_pair(monkeypatch, lambda t: draws[t % 10])
    tdir = str(tmp_path / "t")
    tsolve(10, checkpoint_dir=tdir, checkpoint_freq=1)
    tpay, _ = SolveCheckpointer(tdir).restore(like=_sap_like("torch"))
    jpay, step = JSolveCheckpointer(tdir).restore(like=_sap_like("jax"))
    assert step == 10 and int(jpay["state"].t) == tpay["state"].t == 10
    for name in ("W", "V", "Y"):
        assert np.array_equal(np.asarray(getattr(jpay["state"], name)),
                              getattr(tpay["state"], name).numpy()), name
    assert np.array_equal(np.asarray(jpay["state"].key), np.asarray(jax.random.PRNGKey(0)))
    jW, jlog = jsolve(15, checkpoint_dir=tdir, resume=True)
    tW, tlog = tsolve(15)
    assert sorted(i for i in jlog if isinstance(i, int)) == sorted(tlog) == [0, 5, 10, 15]
    jW = np.asarray(jW)
    assert np.abs(tW.numpy() - jW).max() <= 1e-10 * np.abs(jW).max()
