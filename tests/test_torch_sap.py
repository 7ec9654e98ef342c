"""SAP / ASkotch in the port against the JAX package, float64 on the CPU.

Both packages get the same block schedule (``_block_schedule``), and the
port gets the JAX package's per-step draws: the sketch Ω of the block
Nyström preconditioner and the start of the stepsize's power iteration,
which the JAX solver takes from ``split(state.key, 4)`` each step."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.kernels import KernelConfig as JKernelConfig
from rlaopt_tpu.kernels import LaplaceLinOp as JLaplaceLinOp
from rlaopt_tpu.kernels import RBFLinOp as JRBFLinOp
from rlaopt_tpu.linops import aslinop as j_aslinop
from rlaopt_tpu.models import LinSys as JLinSys
from rlaopt_tpu.preconditioners import IdentityConfig as JIdentityConfig
from rlaopt_tpu.preconditioners import NewtonConfig as JNewtonConfig
from rlaopt_tpu.preconditioners import NystromConfig as JNystromConfig
from rlaopt_tpu.sketches.embeddings import right_embedding as j_right_embedding
from rlaopt_tpu.solvers import SAP as JSAP
from rlaopt_tpu.solvers import SAPAccelConfig as JSAPAccelConfig
from rlaopt_tpu.solvers import SAPConfig as JSAPConfig
from rlaopt_tpu.solvers import factory as j_factory
from rlaopt_tpu.solvers import sap_accel_from_pilot as j_sap_accel_from_pilot
from rlaopt_tpu.spectral_estimators import randomized_powering as j_randomized_powering
from rlaopt_tpu_torch.kernels import KernelConfig, LaplaceLinOp, RBFLinOp
from rlaopt_tpu_torch.linops import aslinop
from rlaopt_tpu_torch.models import LinSys
from rlaopt_tpu_torch.preconditioners import IdentityConfig, NewtonConfig, NystromConfig
from rlaopt_tpu_torch.solvers import SAP, SAPAccelConfig, SAPConfig
from rlaopt_tpu_torch.solvers import factory as t_factory
from rlaopt_tpu_torch.solvers import sap_accel_from_pilot
from rlaopt_tpu_torch.spectral_estimators import randomized_powering

REG, LS, STEPS = 0.05, 1.5, 20
OPS = {"rbf": (JRBFLinOp, RBFLinOp), "laplace": (JLaplaceLinOp, LaplaceLinOp)}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _problem(n, d=4, k=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)), rng.standard_normal((n, k))


def _schedule(n, blk_sz, steps, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(n, blk_sz, replace=False) for _ in range(steps)])


def _jax_draws(steps, blk_sz, rank, key=0):
    """The JAX solver's sketch and power-iteration start of each step."""
    key = jax.random.PRNGKey(key)
    draws = []
    for _ in range(steps):
        key, _k_blk, k_prec, k_pow = jax.random.split(key, 4)
        Omega = j_right_embedding("ortho", k_prec, rank, blk_sz, jnp.float64)
        v0 = jax.random.normal(k_pow, (blk_sz,), dtype=jnp.float64)
        draws.append((torch.from_numpy(np.array(Omega)), torch.from_numpy(np.array(v0))))
    return lambda t: draws[t]


def _systems(kind, X, B):
    jop_cls, top_cls = OPS[kind]
    Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    jK = jop_cls(Xj, Xj, JKernelConfig(lengthscale=LS))
    tK = top_cls(Xt, Xt, KernelConfig(lengthscale=LS))
    jsys = JLinSys(jK, jnp.asarray(B), REG, jK.row_oracle, jK.blk_oracle)
    tsys = LinSys(tK, torch.from_numpy(B), REG, tK.row_oracle, tK.blk_oracle)
    return jsys, tsys


# (n, blk_sz, rank): Nyström at rank 8 in a block of 24 takes the SVD route,
# at rank 2 in a block of 160 the eigh route (blk_sz > 64·rank).
PRECONDS = {
    "newton": (96, 24, None),
    "nystrom_svd": (96, 24, 8),
    "nystrom_eigh": (320, 160, 2),
    "identity": (96, 24, None),
}


def _configs(name):
    n, blk_sz, rank = PRECONDS[name]
    if name == "newton":
        return JNewtonConfig(rho=REG), NewtonConfig(rho=REG)
    if name == "identity":
        return JIdentityConfig(), IdentityConfig()
    return JNystromConfig(rank=rank, rho=REG), NystromConfig(rank=rank, rho=REG)


@pytest.mark.parametrize("accel", [True, False])
@pytest.mark.parametrize("precond", list(PRECONDS))
def test_sap_iterates_match_jax(precond, accel):
    """Newton at rho = reg takes the exact step 1.0 (no draws); Nyström and
    Identity take the stepsize from power iteration on injected starts, and
    Nyström its injected sketch. W, V and Y after 20 steps: 1e-10 of max|·|
    (float64 round-off carried through 20 dependent steps)."""
    n, blk_sz, rank = PRECONDS[precond]
    X, B = _problem(n)
    jsys, tsys = _systems("rbf", X, B)
    jcfg, tcfg = _configs(precond)
    sched = _schedule(n, blk_sz, STEPS)
    nu = n / blk_sz
    common = dict(blk_sz=blk_sz, accel=accel, power_iters=10)
    js = JSAP(
        jsys, jnp.zeros((n, 2)), jcfg, accel_config=JSAPAccelConfig(mu=0.2 / nu, nu=nu),
        key=0, _block_schedule=sched, **common,
    )
    ts = SAP(
        tsys, torch.zeros((n, 2), dtype=torch.float64), tcfg,
        accel_config=SAPAccelConfig(mu=0.2 / nu, nu=nu), key=0,
        _block_schedule=sched, _draws=_jax_draws(STEPS, blk_sz, rank or 1), **common,
    )
    js._run_chunk(STEPS)
    ts._run_chunk(STEPS)
    assert ts.state.t == int(js.state.t) == STEPS
    for name in ("W", "V", "Y"):
        assert _rel(getattr(ts.state, name), getattr(js.state, name)) <= 1e-10, name
    assert not np.allclose(ts.W.numpy(), 0.0)


@pytest.mark.parametrize("rtol", [1e-3, 1e-1])
def test_randomized_powering_matches_jax(rtol):
    """The port runs every step and freezes (v, σ) once converged; the JAX
    package stops its while_loop. rtol 1e-1 stops it early: the frozen
    values are those of the early exit. Float64: 1e-12."""
    rng = np.random.default_rng(3)
    G = rng.standard_normal((60, 60))
    A = G @ G.T / 60 + np.diag(np.linspace(0.0, 3.0, 60))
    key = jax.random.PRNGKey(5)
    jsig, jv = j_randomized_powering(jnp.asarray(A), max_iters=25, rtol=rtol, key=key)
    v0 = torch.from_numpy(np.array(jax.random.normal(key, (60,), dtype=jnp.float64)))
    sig, v = randomized_powering(torch.from_numpy(A), max_iters=25, rtol=rtol, v0=v0)
    assert abs(float(sig) - float(jsig)) <= 1e-12 * abs(float(jsig))
    assert _rel(v, jv) <= 1e-12
    if rtol == 1e-1:  # stopped early: not yet at λ_max
        assert float(sig) < 0.999 * np.linalg.eigvalsh(A)[-1]


def test_randomized_powering_draws_from_its_key():
    A = torch.diag(torch.linspace(1.0, 2.0, 30, dtype=torch.float64))
    s1, v1 = randomized_powering(A, key=7)
    s2, v2 = randomized_powering(A, key=7)
    assert torch.equal(v1, v2) and float(s1) == float(s2)
    assert 1.0 < float(s1) <= 2.0


@pytest.mark.parametrize("rel_res,iters", [(0.5, 10), (1e-3, 40)])
def test_sap_accel_from_pilot_matches_jax(rel_res, iters):
    got = sap_accel_from_pilot(rel_res, iters, n=4096, blk_sz=512)
    ref = j_sap_accel_from_pilot(rel_res, iters, n=4096, blk_sz=512)
    assert (got.mu, got.nu) == (ref.mu, ref.nu)
    with pytest.raises(ValueError, match="pilot rel_res"):
        sap_accel_from_pilot(1.5, iters, n=4096, blk_sz=512)


@pytest.mark.parametrize("kind", ["rbf", "laplace"])
def test_blk_dense_on_and_off_give_equal_iterates(kind):
    """The dense block tile and the streamed block oracle are one operator:
    Nyström with injected draws, 20 steps, 1e-10."""
    n, blk_sz, rank = PRECONDS["nystrom_svd"]
    X, B = _problem(n)
    _, tsys = _systems(kind, X, B)
    sched = _schedule(n, blk_sz, STEPS)
    runs = []
    for blk_dense in (True, False):
        s = SAP(
            tsys, torch.zeros((n, 2), dtype=torch.float64), NystromConfig(rank=rank, rho=REG),
            blk_sz=blk_sz, accel=False, accel_config=None, power_iters=10, key=0,
            _block_schedule=sched, blk_dense=blk_dense,
            _draws=_jax_draws(STEPS, blk_sz, rank),
        )
        assert (s._blk_dense_fn is not None) is blk_dense
        s._run_chunk(STEPS)
        runs.append(s.W)
    assert _rel(runs[0], runs[1]) <= 1e-10


def _patch_schedule(monkeypatch, sched, draws=None):
    monkeypatch.setattr(j_factory, "SAP", partial(JSAP, _block_schedule=sched))
    monkeypatch.setattr(
        t_factory, "SAP", partial(SAP, _block_schedule=sched, _draws=draws)
    )


@pytest.mark.parametrize("metrics", ["true", "sampled"])
@pytest.mark.parametrize("kind", ["rbf", "laplace"])
def test_linsys_sap_matches_jax(monkeypatch, kind, metrics):
    """``LinSys.solve(SAPConfig(...))`` on a kernel operator with its
    oracles, accelerated Newton blocks at rho = reg, the same schedule in
    both packages: the logged rel_res (``"sampled"`` draws its rows from
    the same seeds in both) and W to 1e-10."""
    n, blk_sz = 96, 24
    X, B = _problem(n, seed=4)
    jsys, tsys = _systems(kind, X, B)
    _patch_schedule(monkeypatch, _schedule(n, blk_sz, 40))
    nu = n / blk_sz
    kw = dict(max_iters=40, rtol=1e-12, blk_sz=blk_sz, power_iters=5)
    jW, jlog = jsys.solve(
        JSAPConfig(precond_config=JNewtonConfig(rho=REG),
                   accel_config=JSAPAccelConfig(mu=0.3 / nu, nu=nu), **kw),
        jnp.zeros((n, 2)), callback_freq=10, key=0, metrics=metrics,
    )
    tW, tlog = tsys.solve(
        SAPConfig(precond_config=NewtonConfig(rho=REG),
                  accel_config=SAPAccelConfig(mu=0.3 / nu, nu=nu), **kw),
        torch.zeros((n, 2), dtype=torch.float64), callback_freq=10, key=0,
        metrics=metrics,
    )
    keys = sorted(i for i in jlog if isinstance(i, int))
    assert sorted(tlog) == keys == [0, 10, 20, 30, 40]
    for i in keys:
        jm, tm = jlog[i]["metrics"]["internal_metrics"], tlog[i]["metrics"]["internal_metrics"]
        assert tm.get("source") == jm.get("source")
        np.testing.assert_allclose(tm["rel_res"].numpy(), np.asarray(jm["rel_res"]),
                                   rtol=1e-10, atol=1e-12)
    last = tlog[40]["metrics"]["internal_metrics"]["rel_res"]
    assert torch.all(last < 0.5 * tlog[0]["metrics"]["internal_metrics"]["rel_res"])
    assert _rel(tW, jW) <= 1e-10


@pytest.mark.parametrize("precond", ["newton", "nystrom"])
def test_degenerate_block_is_skipped_not_fatal(precond):
    """A block whose factorization fails (a negative diagonal entry makes it
    indefinite: Newton's Cholesky, or the Nyström core's) gives NaN factors,
    a non-finite direction and no update, in both packages; the next block
    updates as usual (Nyström with the JAX package's draws)."""
    n, blk_sz = 40, 10
    rng = np.random.default_rng(6)
    G = rng.standard_normal((n, n))
    A = G @ G.T / n + np.eye(n)
    A[0, 0] = -1.0 if precond == "newton" else -100.0
    B = rng.standard_normal((n, 1))
    sched = np.stack([np.arange(0, 10), np.arange(10, 20)])  # block 0 holds row 0

    def oracles(M, lin):
        return (lambda blk: lin(M[blk, :])), (lambda blk: lin(M[blk][:, blk]))

    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    jsys = JLinSys(Aj, jnp.asarray(B), 0.0, *oracles(Aj, j_aslinop))
    tsys = LinSys(At, torch.from_numpy(B), 0.0, *oracles(At, aslinop))
    kw = dict(blk_sz=blk_sz, accel=False, accel_config=None, power_iters=5, _block_schedule=sched)
    if precond == "newton":
        jcfg, tcfg, draws = JNewtonConfig(rho=0.0), NewtonConfig(rho=0.0), None
    else:
        jcfg, tcfg = JNystromConfig(rank=4, rho=0.1), NystromConfig(rank=4, rho=0.1)
        draws = _jax_draws(2, blk_sz, 4)
    js = JSAP(jsys, jnp.zeros((n, 1)), jcfg, key=0, **kw)
    ts = SAP(tsys, torch.zeros((n, 1), dtype=torch.float64), tcfg, _draws=draws, **kw)
    js._run_chunk(1)
    ts._run_chunk(1)
    assert torch.equal(ts.W, torch.zeros((n, 1), dtype=torch.float64))
    assert np.array_equal(np.asarray(js.W), np.zeros((n, 1)))
    js._run_chunk(1)
    ts._run_chunk(1)
    assert torch.all(torch.isfinite(ts.W)) and torch.any(ts.W[10:20] != 0)
    assert _rel(ts.W, js.W) <= 1e-12


def test_factory_refuses_a_prebuilt_preconditioner():
    X, B = _problem(32)
    _, tsys = _systems("rbf", X, B)
    cfg = SAPConfig(blk_sz=8, accel=False, precond_config=NewtonConfig(rho=REG))
    with pytest.raises(ValueError, match="prebuilt preconditioner"):
        t_factory._get_solver(tsys, torch.zeros((32, 2), dtype=torch.float64), cfg,
                              preconditioner=object())
    bare = LinSys(tsys.A, tsys.B, REG)
    with pytest.raises(ValueError, match="A_row_oracle and A_blk_oracle"):
        bare.solve(cfg, torch.zeros((32, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="accel_config"):
        SAPConfig(blk_sz=8)
    with pytest.raises(ValueError, match="mu must be less"):
        SAPAccelConfig(mu=2.0, nu=1.0)
    with pytest.raises(ValueError, match="sampling"):
        SAPConfig(blk_sz=8, accel=False, sampling="gpu")


@pytest.mark.parametrize("sampling", ["host", "device"])
def test_sampled_blocks_are_distinct_and_reproducible(sampling):
    """Both samplers draw blk_sz distinct rows per step from the key and the
    iteration counter: equal keys give equal iterates."""
    X, B = _problem(64)
    _, tsys = _systems("rbf", X, B)
    cfg = SAPConfig(max_iters=6, blk_sz=16, accel=False, sampling=sampling,
                    precond_config=NewtonConfig(rho=REG))
    runs = []
    for _ in range(2):
        s = t_factory._get_solver(tsys, torch.zeros((64, 2), dtype=torch.float64), cfg, key=3)
        assert s._host_sampling is (sampling == "host")
        blk = s._sample_host_blocks(1)[0] if sampling == "host" else s._device_block(0)
        assert blk.shape == (16,) and torch.unique(blk).numel() == 16
        s._run_chunk(6)
        runs.append(s.W)
    assert torch.equal(runs[0], runs[1])


def _jax_draws_from(key, steps, blk_sz, rank):
    """``_jax_draws`` from a JAX key (the correction solves' keys)."""
    draws = []
    for _ in range(steps):
        key, _k_blk, k_prec, k_pow = jax.random.split(key, 4)
        Omega = j_right_embedding("ortho", k_prec, rank, blk_sz, jnp.float64)
        v0 = jax.random.normal(k_pow, (blk_sz,), dtype=jnp.float64)
        draws.append((torch.from_numpy(np.array(Omega)), torch.from_numpy(np.array(v0))))
    return lambda t: draws[t]


@pytest.mark.parametrize("n", [128, 256])
def test_config8_accelerated_sap_refined_matches_jax(monkeypatch, n):
    """``benchmarks/run.py`` config 8 at a small size, in both packages: RBF
    at ℓ = √d, d = 10, reg = 1e-5·n, blocks of n/8, Nyström rank 16 at rho =
    reg, the same block schedule and the JAX solver's draws in every SAP
    solve (the base solve's from its key, each correction's from the key
    it is given, ``fold_in(key, round + 1)``). A plain pilot gives
    (mu, nu) through ``sap_accel_from_pilot``; accelerated SAP then runs
    with two evaluate-mode float64 refinement rounds on the host. The
    refinement's rel_res_f64 history and W against the JAX package: 1e-10
    (float64 round-off through 20-iteration solves); the last round no
    worse than the first (JAX's ``test_f64_refine_forwards_oracles``)."""
    d, key, pilot_iters, iters, freq = 10, 7, 20, 20, 10
    blk_sz, rank = n // 8, 16
    reg = 1e-5 * n
    rng = np.random.default_rng(8)
    X, y = rng.standard_normal((n, d)), rng.standard_normal(n)
    ls = d**0.5
    Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    jK = JRBFLinOp(Xj, Xj, JKernelConfig(lengthscale=ls))
    tK = RBFLinOp(Xt, Xt, KernelConfig(lengthscale=ls))
    sched = _schedule(n, blk_sz, max(pilot_iters, iters), seed=9)
    jkeys, made = [], {"jax": 0, "torch": 0}

    def j_sap(*args, **kwargs):
        made["jax"] += 1
        return JSAP(*args, _block_schedule=sched, **kwargs)

    def t_sap(*args, **kwargs):
        made["torch"] += 1
        draws = _jax_draws_from(jkeys.pop(0), max(pilot_iters, iters), blk_sz, rank)
        return SAP(*args, _block_schedule=sched, _draws=draws, **kwargs)

    monkeypatch.setattr(j_factory, "SAP", j_sap)

    monkeypatch.setattr(t_factory, "SAP", t_sap)
    base = dict(rtol=1e-7, blk_sz=blk_sz, power_iters=10)

    def run(accel_cfg=None, refine=False, max_iters=iters):
        jkey = jax.random.PRNGKey(key)
        jkeys[:] = [jkey] + [jax.random.fold_in(jkey, r + 1) for r in range(2)]
        kw = dict(f64_refine_rounds=2, f64_refine_device="cpu",
                  f64_refine_residual="evaluate") if refine else {}
        accel = accel_cfg is not None
        jacc = None if not accel else JSAPAccelConfig(mu=accel_cfg.mu, nu=accel_cfg.nu)
        jsys = JLinSys(jK, jnp.asarray(y), reg, jK.row_oracle, jK.blk_oracle)
        jW, jlog = jsys.solve(
            JSAPConfig(max_iters=max_iters, accel=accel, accel_config=jacc,
                       precond_config=JNystromConfig(rank=rank, rho=reg), **base),
            jnp.zeros((n, 1)), callback_freq=freq, key=key, metrics="true", **kw)
        tsys = LinSys(tK, torch.from_numpy(y), reg, tK.row_oracle, tK.blk_oracle)
        tW, tlog = tsys.solve(
            SAPConfig(max_iters=max_iters, accel=accel, accel_config=accel_cfg,
                      precond_config=NystromConfig(rank=rank, rho=reg), **base),
            torch.zeros((n, 1), dtype=torch.float64), callback_freq=freq, key=key,
            metrics="true", **kw)
        return (jW, jlog), (tW, tlog)

    (_, jlog), (_, tlog) = run(max_iters=pilot_iters)
    jrel = float(jnp.max(jlog[pilot_iters]["metrics"]["internal_metrics"]["rel_res"]))
    trel = float(torch.max(tlog[pilot_iters]["metrics"]["internal_metrics"]["rel_res"]))
    assert abs(trel - jrel) <= 1e-10 and 0.0 < trel < 1.0
    acc = sap_accel_from_pilot(trel, pilot_iters, n, blk_sz)
    jacc = j_sap_accel_from_pilot(jrel, pilot_iters, n, blk_sz)
    assert acc.mu == pytest.approx(jacc.mu, rel=1e-9) and acc.nu == jacc.nu

    made.update(jax=0, torch=0)
    (jW, jlog), (tW, tlog) = run(accel_cfg=acc, refine=True)
    assert made["torch"] == made["jax"] == 3  # the base solve and two corrections
    jhist, thist = jlog["f64_refine"]["rel_res_f64"], tlog["f64_refine"]["rel_res_f64"]
    assert len(thist) == len(jhist) >= 2
    np.testing.assert_allclose(np.asarray(thist), np.asarray(jhist), rtol=1e-10, atol=1e-12)
    assert tW.dtype == torch.float64 and tW.device.type == "cpu"
    assert _rel(tW, jW) <= 1e-10
    assert max(thist[-1]) <= max(thist[0])
