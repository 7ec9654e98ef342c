"""The spectral estimators of config 5 and the rest of the module —
``lanczos``, ``lanczos_eigsh``, ``hutchinson``, ``hutch_plus_plus``,
``fro_norm_est`` — against the JAX package in float64, with the random
draws made once (by the JAX package's own calls on its key, or numpy) and
handed to both: torch and JAX streams differ for the same seed.

Held to 1e-10 of the largest value; the Lanczos recurrence without
reorthogonalization loses orthogonality at the rate it converges, so the
tridiagonal is compared after 12 steps on a spectrum it does not resolve
in that many.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlaopt_tpu.spectral_estimators.trace as j_trace
from rlaopt_tpu.kernels import KernelConfig as JKernelConfig
from rlaopt_tpu.kernels import RBFLinOp as JRBFLinOp
from rlaopt_tpu.linops import aslinop as j_aslinop
from rlaopt_tpu.spectral_estimators import (
    fro_norm_est as j_fro_norm_est,
    hutch_plus_plus as j_hutch_plus_plus,
    hutchinson as j_hutchinson,
    lanczos as j_lanczos,
)
from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp, ShardedRBFLinOp
from rlaopt_tpu_torch.linops import aslinop
from rlaopt_tpu_torch.parallel import make_mesh
from rlaopt_tpu_torch.spectral_estimators import (
    fro_norm_est,
    hutch_plus_plus,
    hutchinson,
    lanczos,
    lanczos_eigsh,
)

N, D, LS, C = 120, 5, 1.7, 1.2


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _points():
    return np.random.default_rng(0).standard_normal((N, D))


def _spd():
    """A symmetric positive definite matrix of spectrum linspace(5, 0.1)."""
    Q = np.linalg.qr(np.random.default_rng(1).standard_normal((N, N)))[0]
    A = (Q * np.linspace(5.0, 0.1, N)) @ Q.T
    return (A + A.T) / 2


def _operators(which):
    """(JAX operand, port operand): a dense SPD matrix, the RBF operator, or
    the port's sharded RBF operator (the half-ring on 3 positions) against
    the JAX single-device one."""
    X = _points()
    if which == "dense":
        A = _spd()
        return jnp.asarray(A), torch.from_numpy(A)
    jK = JRBFLinOp(jnp.asarray(X), jnp.asarray(X), JKernelConfig(lengthscale=LS, const_scaling=C))
    Xt = torch.from_numpy(X)
    cfg = KernelConfig(lengthscale=LS, const_scaling=C)
    if which == "rbf":
        return jK, RBFLinOp(Xt, Xt, cfg)
    return jK, ShardedRBFLinOp(Xt, Xt, cfg, mesh=make_mesh(devices=["cpu"] * 3),
                               memory_mode="ring")


@pytest.mark.parametrize("which", ["dense", "rbf", "sharded"])
def test_lanczos_matches_jax(which):
    jA, tA = _operators(which)
    key = jax.random.PRNGKey(3)
    q0 = torch.from_numpy(np.array(jax.random.normal(key, (N,), dtype=jnp.float64)))
    ja, jb = j_lanczos(jA, 12, key)
    ta, tb = lanczos(tA, 12, q0=q0)
    assert ta.shape == (12,) and tb.shape == (11,)
    assert _rel(ta, ja) <= 1e-10 and _rel(tb, jb) <= 1e-10
    # lanczos_eigsh is eigvalsh of that tridiagonal in both packages
    T = np.diag(np.asarray(ja)) + np.diag(np.asarray(jb), 1) + np.diag(np.asarray(jb), -1)
    tl = lanczos_eigsh(tA, 12, q0=q0)
    assert _rel(tl, np.linalg.eigvalsh(T)) <= 1e-10
    assert bool(torch.all(tl[1:] >= tl[:-1]))


def test_lanczos_draws_its_own_start():
    tA = torch.from_numpy(_spd())
    lam = lanczos_eigsh(tA, 40, key=0)
    assert abs(float(lam[-1]) - 5.0) < 1e-6
    torch.testing.assert_close(lam, lanczos_eigsh(tA, 40, key=0), rtol=0, atol=0)


@pytest.mark.parametrize("which", ["dense", "rbf", "sharded"])
def test_hutchinson_matches_jax(which, monkeypatch):
    jA, tA = _operators(which)
    Omega = np.random.default_rng(4).standard_normal((16, N)) / 4.0
    monkeypatch.setattr(j_trace, "left_embedding", lambda *a, **k: jnp.asarray(Omega))
    jt, jv = j_hutchinson(jA, 16, "gauss", 0)
    tt, tv = hutchinson(tA, 16, "gauss", Omega=torch.from_numpy(Omega))
    assert _rel(tt, jt) <= 1e-10 and _rel(tv, jv) <= 1e-10
    if which != "dense":
        # the RBF diagonal is c: the exact trace is c·n
        t, v = hutchinson(tA, 64, "gauss", key=1)
        assert abs(float(t) - C * N) <= 5 * (float(v) / 64) ** 0.5


def test_hutch_plus_plus_matches_jax():
    jA, tA = _operators("rbf")
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    m = 30 // 3
    S = np.array(jax.random.normal(k1, (N, m), dtype=jnp.float64))
    G = np.array(jax.random.normal(k2, (N, m), dtype=jnp.float64))
    jt = j_hutch_plus_plus(jA, 30, "gauss", key)
    tt = hutch_plus_plus(tA, 30, S=torch.from_numpy(S), G=torch.from_numpy(G))
    assert _rel(tt, jt) <= 1e-10
    assert abs(float(hutch_plus_plus(tA, 30, key=2)) - C * N) < 0.05 * C * N


def test_fro_norm_est_matches_jax(monkeypatch):
    M = np.random.default_rng(6).standard_normal((70, 40))
    Omega = np.random.default_rng(7).standard_normal((12, 40)) / 12**0.5
    monkeypatch.setattr(j_trace, "left_embedding", lambda *a, **k: jnp.asarray(Omega))
    for jM, tM in ((j_aslinop(jnp.asarray(M)), aslinop(torch.from_numpy(M))),
                   (jnp.asarray(M), torch.from_numpy(M))):
        jf, jv = j_fro_norm_est(jM, 12, "gauss", 0)
        tf, tv = fro_norm_est(tM, 12, "gauss", Omega=torch.from_numpy(Omega))
        assert _rel(tf, jf) <= 1e-10 and _rel(tv, jv) <= 1e-10
