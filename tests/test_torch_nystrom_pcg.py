"""Port parity: Nyström factors, P⁻¹ applies and PCG steps against the JAX
package, in float64 on the CPU, from the same numpy inputs and the same
injected sketch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.kernels import KernelConfig as JKernelConfig
from rlaopt_tpu.kernels import RBFLinOp as JRBFLinOp
from rlaopt_tpu.preconditioners import nystrom as j_nys
from rlaopt_tpu.solvers import pcg as j_pcg
from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
from rlaopt_tpu_torch.preconditioners import nystrom as t_nys
from rlaopt_tpu_torch.solvers import pcg as t_pcg

N, D, RANK, LS, REG = 400, 6, 40, 2.0, 0.3


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((N, D))
    Omega = np.linalg.qr(rng.standard_normal((N, RANK)))[0]
    B = rng.standard_normal((N, 2))
    W0 = 0.01 * rng.standard_normal((N, 2))
    Xj = jnp.asarray(X)
    Xt = torch.from_numpy(X)
    return {
        "Omega": Omega,
        "B": B,
        "W0": W0,
        "jA": JRBFLinOp(Xj, Xj, JKernelConfig(lengthscale=LS)),
        "tA": RBFLinOp(Xt, Xt, KernelConfig(lengthscale=LS)),
    }


def _jax_factors(problem, route, monkeypatch):
    Omega = jnp.asarray(problem["Omega"])
    monkeypatch.setattr(j_nys, "right_embedding", lambda *a, **k: Omega)
    jA = problem["jA"]
    return j_nys.nystrom_update(
        lambda V: jA @ V, N, RANK, "ortho", None, jnp.float64, _route=route
    )


def _torch_factors(problem, route):
    tA = problem["tA"]
    return t_nys.nystrom_update(
        lambda V: tA @ V, N, RANK, "ortho", None, torch.float64,
        _route=route, Omega=torch.from_numpy(problem["Omega"]),
    )


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("route", ["eigh", "svd"])
def test_nystrom_factors_match(problem, route, monkeypatch):
    fj = _jax_factors(problem, route, monkeypatch)
    ft = _torch_factors(problem, route)
    Sj, St = np.asarray(fj.S), ft.S.numpy()
    np.testing.assert_allclose(St, Sj, rtol=1e-8, atol=1e-8 * Sj.max())
    Uj, Ut = np.asarray(fj.U), ft.U.numpy()
    # Columns are defined up to sign; compare those whose eigenvalue is
    # well separated from its neighbours (the rest span a shared subspace).
    gaps = np.abs(np.diff(Sj))
    sep = np.minimum(np.r_[np.inf, gaps], np.r_[gaps, np.inf]) > 1e-6 * Sj.max()
    signs = np.sign(np.sum(Uj * Ut, axis=0))
    assert sep.sum() >= RANK // 2
    np.testing.assert_allclose((Ut * signs)[:, sep], Uj[:, sep], atol=1e-7)


@pytest.mark.parametrize("low_precision_path", [False, True])
def test_nystrom_inverse_applies_match(problem, low_precision_path, monkeypatch):
    fj = _jax_factors(problem, None, monkeypatch)
    ft = _torch_factors(problem, None)
    rho_j = j_nys.nystrom_damping(fj.S, REG, REG, adaptive=True)
    rho_t = t_nys.nystrom_damping(ft.S, REG, REG, adaptive=True)
    Lj = j_nys.nystrom_inv_chol(fj.U, fj.S, rho_j) if low_precision_path else None
    Lt = t_nys.nystrom_inv_chol(ft.U, ft.S, rho_t) if low_precision_path else None
    x = problem["B"]
    yj = j_nys.nystrom_apply_inv(fj, rho_j, jnp.asarray(x), Lj)
    yt = t_nys.nystrom_apply_inv(ft, rho_t, torch.from_numpy(x), Lt)
    assert _rel(yt, yj) <= 1e-10
    pj = j_nys.nystrom_apply(fj, rho_j, jnp.asarray(x[:, 0]))
    pt = t_nys.nystrom_apply(ft, rho_t, torch.from_numpy(x[:, 0]))
    assert _rel(pt, pj) <= 1e-10


def test_pcg_init_and_steps_match(problem, monkeypatch):
    fj = _jax_factors(problem, None, monkeypatch)
    ft = _torch_factors(problem, None)
    rho_j = j_nys.nystrom_damping(fj.S, REG, REG, adaptive=True)
    rho_t = t_nys.nystrom_damping(ft.S, REG, REG, adaptive=True)

    def j_inv(_, x):
        return j_nys.nystrom_apply_inv(fj, rho_j, x, None)

    def t_inv(_, x):
        return t_nys.nystrom_apply_inv(ft, rho_t, x, None)

    B, W0 = problem["B"], problem["W0"]
    js = j_pcg.pcg_init(problem["jA"], jnp.asarray(B), REG, jnp.asarray(W0), j_inv, None)
    ts = t_pcg.pcg_init(problem["tA"], torch.from_numpy(B), REG, torch.from_numpy(W0), t_inv,
                        None)
    for name in ("R", "Z", "RZ"):
        assert _rel(getattr(ts, name), getattr(js, name)) <= 1e-9, name
    jmask = jnp.ones((2,), bool)
    tmask = torch.ones((2,), dtype=torch.bool)
    for _ in range(3):
        js = j_pcg.pcg_step(problem["jA"], REG, j_inv, None, js, jmask)
        ts = t_pcg.pcg_step(problem["tA"], REG, t_inv, None, ts, tmask)
    for name in ("W", "R", "Z", "P_", "RZ"):
        assert _rel(getattr(ts, name), getattr(js, name)) <= 1e-9, name
    assert np.array_equal(ts.ok.numpy(), np.asarray(js.ok))


def test_pcg_masked_column_stays_frozen(problem):
    """A masked column keeps its iterate exactly while the other moves."""
    tA = problem["tA"]

    def ident(_, x):
        return x

    B = torch.from_numpy(problem["B"])
    s0 = t_pcg.pcg_init(tA, B, REG, torch.zeros_like(B), ident, None, w_zero=True)
    mask = torch.tensor([True, False])
    s1 = t_pcg.pcg_step(tA, REG, ident, None, s0, mask)
    assert torch.equal(s1.W[:, 1], s0.W[:, 1])
    assert not torch.equal(s1.W[:, 0], s0.W[:, 0])


@pytest.mark.parametrize("config_name,item", [("SAPConfig", 10), ("LSQRConfig", 11)])
def test_factory_names_the_roadmap_item_of_an_unported_solver(config_name, item):
    """SAP (item 10) and LSQR (item 11) are ported: the factory takes their
    configs and each solver refuses what it cannot use, SAP a prebuilt
    preconditioner and LSQR a preconditioner other than Identity or SkPre
    (tests/test_torch_sap.py and tests/test_torch_lsqr.py drive them)."""
    from rlaopt_tpu_torch import preconditioners, solvers

    if config_name == "SAPConfig":
        config = solvers.SAPConfig(blk_sz=4, accel=False)
        with pytest.raises(ValueError, match="prebuilt preconditioner"):
            solvers._get_solver(None, None, config, preconditioner=object())
        return
    config = getattr(solvers, config_name)(
        precond_config=preconditioners.NystromConfig(rank=4, rho=1.0)
    )
    with pytest.raises(TypeError, match="Valid preconditioner configs for LSQR"):
        solvers._get_solver(None, None, config)
