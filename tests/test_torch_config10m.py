"""Configs 7 and 9 of ``benchmarks/run.py`` (the n = 10M ASkotch headline,
``config7_askotch_10m_reference_scale``, ``config9_askotch_10m_converging``
and the certificate of ``_value64_residual_sampled``) at a small size, in
both packages, on the same numpy inputs: the recipe ``chip_smoke.py`` runs
at n = 10⁷ on the card, here at n = 4,000, d = 50, k = 10, blocks of n/100,
Nyström rank 8, in float64.

Both packages get the same block schedule and the port gets the JAX
solver's draws (``split(state.key, 4)`` each step, from each solve's key),
as ``tests/test_torch_sap.py::test_config8_accelerated_sap_refined_matches_jax``
does. The block products run matrix-free (``blk_dense=False``), as at n =
10⁷, where a block's 40 GB of values pass SAP's budget. The operator is
built with ``compute_dtype="bf16x3"`` as written; float64 points take the
exact product in both packages (JAX's XLA route off the TPU takes no tier,
and the port's operator keeps tier parts of float32 points only).

``benchmarks/run.py`` is not imported: at import it points JAX's persistent
cache at a directory of its own, which the tests' workers must not share.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.kernels import KernelConfig as JKernelConfig
from rlaopt_tpu.kernels import RBFLinOp as JRBFLinOp
from rlaopt_tpu.models import LinSys as JLinSys
from rlaopt_tpu.ops.kernel_value64 import kernel_matmat_value64 as j_value64
from rlaopt_tpu.preconditioners import NystromConfig as JNystromConfig
from rlaopt_tpu.sketches.embeddings import right_embedding as j_right_embedding
from rlaopt_tpu.solvers import SAP as JSAP
from rlaopt_tpu.solvers import SAPAccelConfig as JSAPAccelConfig
from rlaopt_tpu.solvers import SAPConfig as JSAPConfig
from rlaopt_tpu.solvers import factory as j_factory
from rlaopt_tpu.solvers import sap_accel_from_pilot as j_sap_accel_from_pilot
from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
from rlaopt_tpu_torch.models import LinSys
from rlaopt_tpu_torch.preconditioners import NystromConfig
from rlaopt_tpu_torch.solvers import SAP, SAPAccelConfig, SAPConfig, sap_accel_from_pilot
from rlaopt_tpu_torch.solvers import factory as t_factory

N, D, K, RANK, FREQ = 4000, 50, 10, 8, 5
BLK = N // 100
ITERS7, PILOT9, ITERS9 = 20, 10, 20
REG7, REG9 = 1e-2, 1e-5 * N
# SAP's iterates after 20 float64 steps: test_torch_sap's 1e-10 of max|.|.
ITER_RTOL = 1e-10


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _draws(key, steps):
    """The JAX solver's (sketch, power-iteration start) of each step."""
    draws = []
    for _ in range(steps):
        key, _k_blk, k_prec, k_pow = jax.random.split(key, 4)
        Omega = j_right_embedding("ortho", k_prec, RANK, BLK, jnp.float64)
        v0 = jax.random.normal(k_pow, (BLK,), dtype=jnp.float64)
        draws.append((torch.from_numpy(np.array(Omega)), torch.from_numpy(np.array(v0))))
    return lambda t: draws[t]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)) / D**0.5
    y = rng.standard_normal((N, K))
    sched = np.stack([rng.choice(N, BLK, replace=False) for _ in range(ITERS9)])
    return X, y, sched


@pytest.fixture
def both(monkeypatch, data):
    """``solve(reg, accel, iters, key)`` in both packages: ``((W, log,
    state), (W, log, state))`` for JAX and the port, each with the solver's
    last state."""
    X, y, sched = data
    jK = JRBFLinOp(jnp.asarray(X), jnp.asarray(X), JKernelConfig(lengthscale=1.0),
                   compute_dtype="bf16x3")
    tK = RBFLinOp(torch.from_numpy(X), torch.from_numpy(X), KernelConfig(lengthscale=1.0),
                  compute_dtype="bf16x3")
    keys = []
    monkeypatch.setattr(j_factory, "SAP", lambda *a, **kw: JSAP(*a, _block_schedule=sched, **kw))
    monkeypatch.setattr(t_factory, "SAP", lambda *a, **kw: SAP(
        *a, _block_schedule=sched, _draws=_draws(keys.pop(0), ITERS9), **kw))
    states = {}
    for name, cls in (("jax", JLinSys), ("torch", LinSys)):
        real = cls._train

        def keep(self, logger, termination_fn, solver, *a, _real=real, _name=name, **kw):
            out = _real(self, logger, termination_fn, solver, *a, **kw)
            states[_name] = solver.state
            return out

        monkeypatch.setattr(cls, "_train", keep)

    def solve(reg, accel, iters, key):
        base = dict(max_iters=iters, rtol=1e-6, blk_sz=BLK, power_iters=10, blk_dense=False,
                    accel=accel is not None)
        jkey = jax.random.PRNGKey(key)
        keys[:] = [jkey]
        jacc = None if accel is None else JSAPAccelConfig(mu=accel.mu, nu=accel.nu)
        jW, jlog = JLinSys(jK, jnp.asarray(y), reg, jK.row_oracle, jK.blk_oracle).solve(
            JSAPConfig(precond_config=JNystromConfig(rank=RANK, rho=reg), accel_config=jacc,
                       **base),
            jnp.zeros((N, K)), callback_freq=FREQ, key=jkey, metrics="sampled")
        tW, tlog = LinSys(tK, torch.from_numpy(y), reg, tK.row_oracle, tK.blk_oracle).solve(
            SAPConfig(precond_config=NystromConfig(rank=RANK, rho=reg), accel_config=accel,
                      **base),
            torch.zeros((N, K), dtype=torch.float64), callback_freq=FREQ, key=key,
            metrics="sampled")
        return (jW, jlog, states["jax"]), (tW, tlog, states["torch"])

    return solve


def _final_rel(log):
    i = max(j for j in log if isinstance(j, int))
    return float(np.max(np.asarray(log[i]["metrics"]["internal_metrics"]["rel_res"])))


def test_config7_matches_jax_and_stays_inert(both):
    """Config 7 as written (reg 1e-2, μ = 1e-2, ν = 100, key 0) for 20
    iterations: W, V, Y within 1e-10 of max|.| of JAX's; μ·ν = 1 keeps V =
    Y = W in both packages to 1e-12 of max|W| (float64 round-off of the
    recurrence's combinations over 20 steps); the final rel_res (a true
    residual in both) to 1e-10."""
    (jW, jlog, js), (tW, tlog, ts) = both(REG7, SAPAccelConfig(mu=1e-2, nu=100.0), ITERS7, 0)
    assert ts.t == int(js.t) == ITERS7
    for name in ("W", "V", "Y"):
        assert _rel(getattr(ts, name), getattr(js, name)) <= ITER_RTOL, name
    for V, Y, W in ((ts.V.numpy(), ts.Y.numpy(), ts.W.numpy()),
                    (np.asarray(js.V), np.asarray(js.Y), np.asarray(js.W))):
        assert np.abs(V - W).max() <= 1e-12 * np.abs(W).max()
        assert np.abs(Y - W).max() <= 1e-12 * np.abs(W).max()
    assert abs(_final_rel(tlog) - _final_rel(jlog)) <= 1e-10
    assert np.all(np.isfinite(tW.numpy())) and np.abs(tW.numpy()).max() > 0


def test_config9_pilot_acceleration_and_certificate_match_jax(both, data):
    """Config 9 (reg 1e-5·n, key 7): a 10-iteration plain pilot, (μ, ν) by
    ``sap_accel_from_pilot`` (run.py's fallback μ = 0.9·blk/n, ν = n/blk
    where it raises, in both alike), 20 accelerated iterations: the pilot's
    rel_res to 1e-10, (μ, ν) to 1e-9 (here the pilot's rel_res rises, so
    both take the fallback; both functions also agree on a contracting
    pilot's numbers), W, V, Y within 1e-10 of max|.| of JAX's. The
    certificate as run.py computes it, at iteration 20: 2,048 rows of numpy
    seed 11, K·W through ``kernel_matmat_value64`` in each package
    (``chip_smoke.value64_certificate`` for the port, K8's plain version
    here; JAX's engine in interpret mode) and the rest in float64: the two
    within 1e-10 (8e-15 measured), the port's within 1e-12 of a numpy
    float64 certificate of the same rows."""
    X, y, _ = data
    (_, jlog, _), (_, tlog, _) = both(REG9, None, PILOT9, 7)
    jrel, trel = _final_rel(jlog), _final_rel(tlog)
    assert abs(trel - jrel) <= 1e-10
    try:
        acc, jacc = (sap_accel_from_pilot(trel, PILOT9, N, BLK),
                     j_sap_accel_from_pilot(jrel, PILOT9, N, BLK))
    except ValueError:
        with pytest.raises(ValueError):
            j_sap_accel_from_pilot(jrel, PILOT9, N, BLK)
        acc = jacc = SAPAccelConfig(mu=0.9 * BLK / N, nu=N / BLK)
    assert acc.mu == pytest.approx(jacc.mu, rel=1e-9) and acc.nu == jacc.nu
    for rel in (0.5, 0.97):
        a, b = sap_accel_from_pilot(rel, PILOT9, N, BLK), j_sap_accel_from_pilot(rel, PILOT9, N, BLK)
        assert a.mu == pytest.approx(b.mu, rel=1e-12) and a.nu == b.nu
    (jW, _, js), (tW, _, ts) = both(REG9, acc, ITERS9, 7)
    for name in ("W", "V", "Y"):
        assert _rel(getattr(ts, name), getattr(js, name)) <= ITER_RTOL, name

    smoke = _smoke()
    tX, ty = torch.from_numpy(X).float(), torch.from_numpy(y).float()
    W32 = tW.float()
    y_norm = float(torch.linalg.norm(ty.double()))
    t_rel, t_se, idx, _, _ = smoke.value64_certificate(tX, ty, y_norm, W32, REG9)
    rows = np.sort(np.random.default_rng(11).choice(N, size=2048, replace=False))
    assert np.array_equal(idx.numpy(), rows)
    Xr, Wn = X.astype(np.float32), W32.numpy()
    hi, lo = j_value64(jnp.asarray(Xr[rows]), jnp.asarray(Xr), Wn, 1.0, kind="rbf",
                       interpret=True)
    KW = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    yr = y.astype(np.float32).astype(np.float64)
    j_rel = float(np.linalg.norm(yr[rows] - (KW + REG9 * Wn[rows].astype(np.float64)))
                  * (N / 2048) ** 0.5 / np.linalg.norm(yr))
    Xs = Xr.astype(np.float64)
    d2 = ((Xs[rows, None, :] - Xs[None, :, :]) ** 2).sum(-1)
    KW64 = np.exp(-0.5 * d2) @ Wn.astype(np.float64)
    ref = float(np.linalg.norm(yr[rows] - (KW64 + REG9 * Wn[rows].astype(np.float64)))
                * (N / 2048) ** 0.5 / np.linalg.norm(yr))
    assert t_se == pytest.approx((2.0 * 2048) ** -0.5)
    assert abs(t_rel - j_rel) <= 1e-10 * j_rel
    assert abs(t_rel - ref) <= 1e-12 * ref
    assert 0.0 < t_rel < 2.0
