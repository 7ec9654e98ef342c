"""The port's first slice, whole, against the JAX package on the CPU:
``LinSys(RBFLinOp(X, X), y, reg).solve(PCGConfig(... Nyström ...))`` with the
same data and the same injected sketch in both packages; and the third
slice's Nyström-PCG path on ``LaplaceLinOp``."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.kernels import KernelConfig as JKernelConfig
from rlaopt_tpu.kernels import LaplaceLinOp as JLaplaceLinOp
from rlaopt_tpu.kernels import RBFLinOp as JRBFLinOp
from rlaopt_tpu.models import LinSys as JLinSys
from rlaopt_tpu.preconditioners import NystromConfig as JNystromConfig
from rlaopt_tpu.preconditioners import nystrom as j_nys
from rlaopt_tpu.solvers import PCGConfig as JPCGConfig
from rlaopt_tpu_torch.kernels import KernelConfig, LaplaceLinOp, RBFLinOp
from rlaopt_tpu_torch.models import LinSys
from rlaopt_tpu_torch.preconditioners import Nystrom, NystromConfig
from rlaopt_tpu_torch.solvers import PCGConfig

N, D, RANK, ITERS = 512, 8, 32, 30
REG = 1e-4 * N
LS = D**0.5
# Laplace: the mean L1 distance of D standard-normal features, 2D/√π
LS_LAPLACE = 2 * D / np.pi**0.5
OPS = {"rbf": (JRBFLinOp, RBFLinOp, LS), "laplace": (JLaplaceLinOp, LaplaceLinOp, LS_LAPLACE)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(dtype):
    """The shape-matched HIGGS recipe at a small size."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(dtype)
    w = rng.standard_normal(D).astype(dtype)
    y = (np.tanh(X @ w) + 0.1 * rng.standard_normal(N)).astype(dtype)
    Omega = np.linalg.qr(rng.standard_normal((N, RANK)))[0].astype(dtype)
    return X, y, Omega


def _solve_both(dtype, monkeypatch, metrics="auto", rtol=1e-12, iters=ITERS,
                freq=10, kind="rbf"):
    """One solve in each package; ``metrics="sampled"`` adds row oracles."""
    X, y, Omega = _data(dtype)
    jcls, tcls, ls = OPS[kind]
    monkeypatch.setattr(
        j_nys, "right_embedding", lambda *a, **k: jnp.asarray(Omega)
    )
    Xj = jnp.asarray(X)
    jK = jcls(Xj, Xj, JKernelConfig(lengthscale=ls))
    joracles = (jK.row_oracle, jK.blk_oracle) if metrics == "sampled" else (None, None)
    jsys = JLinSys(jK, jnp.asarray(y), REG, *joracles)
    jcfg = JPCGConfig(
        max_iters=iters, rtol=rtol,
        precond_config=JNystromConfig(rank=RANK, rho=REG),
    )
    jW, jlog = jsys.solve(
        jcfg, jnp.zeros((N, 1), X.dtype), callback_freq=freq, key=0,
        metrics=metrics,
    )

    Xt = torch.from_numpy(X)
    K = tcls(Xt, Xt, KernelConfig(lengthscale=ls))
    tcfg = PCGConfig(
        max_iters=iters, rtol=rtol,
        precond_config=NystromConfig(rank=RANK, rho=REG),
    )
    P = Nystrom(tcfg.precond_config)
    P._update(K, Omega=torch.from_numpy(Omega))
    P._update_damping(baseline_rho=REG)
    toracles = (K.row_oracle, K.blk_oracle) if metrics == "sampled" else (None, None)
    tsys = LinSys(K, torch.from_numpy(y), REG, *toracles)
    tW, tlog = tsys.solve(
        tcfg, torch.zeros((N, 1), dtype=Xt.dtype), callback_freq=freq, key=0,
        preconditioner=P, metrics=metrics,
    )
    return (jW, jlog, jsys), (tW, tlog, tsys)


def _rel_res(log):
    return {
        i: np.asarray(e["metrics"]["internal_metrics"]["rel_res"], np.float64)
        for i, e in log.items()
    }


def test_slice_matches_jax_f64(monkeypatch):
    (jW, jlog, _), (tW, tlog, tsys) = _solve_both(np.float64, monkeypatch)
    assert sorted(tlog) == sorted(jlog) == [0, 10, 20, 30]
    jr, tr = _rel_res(jlog), _rel_res(tlog)
    # rel_res is ‖r‖/‖y‖: held to 1e-8 of ‖y‖. Deep in the solve r is a small
    # difference of large terms, so its own relative agreement is the
    # iterates' (~1e-11 here) times ‖K‖‖W‖/‖r‖, not f64 round-off: a 1e-15
    # relative perturbation of y moves the JAX package's own rel_res at
    # iteration 30 by 4.5e-7 relative.
    for i in jr:
        np.testing.assert_allclose(tr[i], jr[i], rtol=1e-8, atol=1e-8)
    assert tr[30][0] < 1e-3 * tr[0][0]
    jW = np.asarray(jW)
    assert np.abs(tW.numpy() - jW).max() <= 1e-8 * np.abs(jW).max()
    assert tsys.stalled is False
    assert set(tsys.phase_walls) == {"solver_init", "train"}


def test_slice_laplace_matches_jax_f64(monkeypatch):
    """The third slice's path B at a small size: Nyström-PCG on the Laplace
    operator (the K5 matvec, the K3 sketch and K3c residuals on a card),
    rel_res at every boundary and W to 1e-8, as the RBF slice."""
    (jW, jlog, _), (tW, tlog, tsys) = _solve_both(np.float64, monkeypatch, kind="laplace")
    assert sorted(tlog) == sorted(jlog) == [0, 10, 20, 30]
    jr, tr = _rel_res(jlog), _rel_res(tlog)
    for i in jr:
        np.testing.assert_allclose(tr[i], jr[i], rtol=1e-8, atol=1e-8)
    assert tr[30][0] < 1e-2 * tr[0][0]
    jW = np.asarray(jW)
    assert np.abs(tW.numpy() - jW).max() <= 1e-8 * np.abs(jW).max()


def test_slice_matches_jax_f32(monkeypatch):
    """f32 trajectories part near the accuracy floor (summation order, and
    the port's compensated true residual against the JAX package's plain
    one off-TPU), so only the first boundary after iterating is held, and
    at 1e-4 relative; iteration 0 is the exact rel_res 1."""
    (jW, jlog, _), (tW, tlog, _) = _solve_both(np.float32, monkeypatch)
    jr, tr = _rel_res(jlog), _rel_res(tlog)
    assert tr[0][0] == jr[0][0] == 1.0
    np.testing.assert_allclose(tr[10], jr[10], rtol=1e-4)
    assert tW.dtype == torch.float32
    assert np.all(np.isfinite(tW.numpy()))


def _source(entry):
    return entry["metrics"]["internal_metrics"].get("source")


@pytest.mark.parametrize("metrics", ["recurrence", "sampled"])
def test_estimated_metrics_match_jax_f64(monkeypatch, metrics):
    """Boundaries read the estimator until it claims convergence; the claim
    is confirmed on a true residual, which ends the solve at the same
    boundary in both packages. Past iteration 30 the f64 trajectories part
    by percents: a 1e-15 perturbation of y moves the JAX package's own
    rel_res by 6% at iteration 40, so only iterations ≤ 30 are compared."""
    (_, jlog, jsys), (_, tlog, tsys) = _solve_both(
        np.float64, monkeypatch, metrics=metrics, rtol=1e-6, iters=60, freq=5
    )
    assert sorted(tlog) == sorted(jlog) == list(range(0, 50, 5))
    for i in tlog:
        want = None if i == 45 else metrics
        assert _source(tlog[i]) == _source(jlog[i]) == want, i
    jr, tr = _rel_res(jlog), _rel_res(tlog)
    for i in range(0, 35, 5):
        np.testing.assert_allclose(tr[i], jr[i], rtol=1e-8, atol=1e-8)
    assert tr[45][0] <= 1e-6 and jr[45][0] <= 1e-6
    assert tsys.stalled is False


def test_stall_certificate_f32_matches_jax(monkeypatch):
    """At an unreachable rtol the f32 solve flattens at the operator floor;
    both packages certify the stall on confirmed true residuals and stop
    early. The port reports it in ``model.stalled`` and the last metrics,
    and keeps the log's keys iteration numbers (the JAX package adds a
    ``"stalled"`` key). f32 trajectories part, so the stopping iterations
    need not be equal."""
    (_, jlog, jsys), (_, tlog, tsys) = _solve_both(
        np.float32, monkeypatch, metrics="recurrence", rtol=1e-9, iters=300,
        freq=5,
    )
    assert jsys._stalled and jlog["stalled"] is True
    assert tsys.stalled is True
    assert all(isinstance(i, int) for i in tlog)
    last = max(tlog)
    assert last < 300
    final = tlog[last]["metrics"]["internal_metrics"]
    assert final["stalled"] is True and "source" not in final
    assert final["rel_res"][0] > 1e-9


def test_port_import_leaves_jax_out():
    code = "import sys, rlaopt_tpu_torch; sys.exit('jax' in sys.modules)"
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_no_port_source_imports_jax_or_the_jax_package():
    """Every module of the port and ``chip_smoke.py``, read as text: no
    ``import jax``/``from jax`` and no import of ``rlaopt_tpu`` (the JAX
    package), at any indentation."""
    import re
    from pathlib import Path

    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|rlaopt_tpu)(\.|\s|$)", re.M)
    files = sorted(Path(REPO, "rlaopt_tpu_torch").rglob("*.py")) + [Path(REPO, "chip_smoke.py")]
    assert len(files) > 40
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_not_yet_ported_paths_raise(monkeypatch, tmp_path):
    """The wandb mirror and checkpoints, once refused here, are ported:
    they raise only what the JAX package raises (no ``wandb_init_kwargs``:
    ValueError; ``wandb`` not importable: ImportError), and a checkpointed
    solve writes its steps."""
    X, y, _ = _data(np.float64)
    Xt = torch.from_numpy(X)
    sys_ = LinSys(RBFLinOp(Xt, Xt, KernelConfig(lengthscale=LS)), torch.from_numpy(y), REG)
    cfg = PCGConfig(max_iters=2, precond_config=NystromConfig(rank=4, rho=REG))
    W0 = torch.zeros((N, 1), dtype=Xt.dtype)
    with pytest.raises(ValueError, match="wandb_init_kwargs"):
        sys_.solve(cfg, W0, log_in_wandb=True)
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError):
        sys_.solve(cfg, W0, log_in_wandb=True, wandb_init_kwargs={})
    _, log = sys_.solve(cfg, W0, callback_freq=1, checkpoint_dir=str(tmp_path / "ck"))
    assert sorted(log) == [0, 1, 2]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000001.aux.json", "step_00000001.npz",
        "step_00000002.aux.json", "step_00000002.npz"]
