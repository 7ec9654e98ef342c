"""Float64 refinement of ``LinSys.solve`` against the JAX package on the
CPU: the same data, the same injected sketch, an f32 base solve, then the
refinement rounds in both packages.

Both converge to the float64 solution whatever their f32 round-off, so the
delivered W64 are held to each other at 1e-6 of ‖W64‖ (measured 2.5e-8 to
3.6e-8 in every mode), and the sequences of residual sources and the round
counts must be equal. The settings keep each decision clear of its
threshold in both packages. Hybrid mode takes a 30-iteration base solve and
three rounds: the JAX package's compensated route off the TPU is the plain
f32 product (its lo part is zero), so its steering round leaves 5.1e-6 and
needs a third round, where the port's compensated kernel is float64 inside
a tile and leaves 8.9e-8.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.kernels import KernelConfig as JKernelConfig
from rlaopt_tpu.kernels import RBFLinOp as JRBFLinOp
from rlaopt_tpu.models import LinSys as JLinSys
from rlaopt_tpu.preconditioners import NystromConfig as JNystromConfig
from rlaopt_tpu.preconditioners import nystrom as j_nys
from rlaopt_tpu.solvers import PCGConfig as JPCGConfig
from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
from rlaopt_tpu_torch.linops import LinOp
from rlaopt_tpu_torch.models import LinSys
from rlaopt_tpu_torch.preconditioners import Nystrom, NystromConfig
from rlaopt_tpu_torch.solvers import PCGConfig
from rlaopt_tpu_torch.utils.rng import fold_in

N, D, RANK = 512, 8, 32
REG = 1e-4 * N
LS = D**0.5


def _data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    w = rng.standard_normal(D).astype(np.float32)
    y = (np.tanh(X @ w) + 0.1 * rng.standard_normal(N)).astype(np.float32)
    Omega = np.linalg.qr(rng.standard_normal((N, RANK)))[0].astype(np.float32)
    return X, y, Omega


def _port_system(X, y, Omega, cfg):
    Xt = torch.from_numpy(X)
    K = RBFLinOp(Xt, Xt, KernelConfig(lengthscale=LS))
    P = Nystrom(cfg.precond_config)
    P._update(K, Omega=torch.from_numpy(Omega))
    P._update_damping(baseline_rho=REG)
    return LinSys(K, torch.from_numpy(y), REG), P


def _solve_both(monkeypatch, rtol, iters, **refine):
    X, y, Omega = _data()
    monkeypatch.setattr(j_nys, "right_embedding", lambda *a, **k: jnp.asarray(Omega))
    Xj = jnp.asarray(X)
    jK = JRBFLinOp(Xj, Xj, JKernelConfig(lengthscale=LS))
    jcfg = JPCGConfig(
        max_iters=iters, rtol=rtol, precond_config=JNystromConfig(rank=RANK, rho=REG)
    )
    jW, jlog = JLinSys(jK, jnp.asarray(y), REG).solve(
        jcfg, jnp.zeros((N, 1), jnp.float32), callback_freq=10, key=0, **refine
    )
    cfg = PCGConfig(
        max_iters=iters, rtol=rtol, precond_config=NystromConfig(rank=RANK, rho=REG)
    )
    sys_, P = _port_system(X, y, Omega, cfg)
    tW, tlog = sys_.solve(
        cfg, torch.zeros((N, 1)), callback_freq=10, key=0, preconditioner=P, **refine
    )
    return np.asarray(jW), jlog["f64_refine"], tW, tlog["f64_refine"]


MODES = [
    # (device, residual, certify, rtol, base iterations, rounds, sources)
    ("cpu", "evaluate", "full", 1e-8, 60, 2, ["evaluate"] * 3),
    ("accel", "evaluate", "full", 1e-8, 60, 2, ["evaluate"] * 3),
    ("accel", "update", "full", 1e-8, 60, 2, ["evaluate", "update", "update"]),
    ("accel", "hybrid", "full", 1e-8, 30, 3,
     ["compensated_f32", "evaluate", "update", "update"]),
    ("accel", "update", "sampled", 1e-8, 60, 2, ["evaluate", "value64_sampled"]),
]


@pytest.mark.parametrize("device,residual,certify,rtol,iters,rounds,sources", MODES)
def test_refinement_matches_jax(
    monkeypatch, device, residual, certify, rtol, iters, rounds, sources
):
    jW, jref, tW, tref = _solve_both(
        monkeypatch, rtol, iters,
        f64_refine_rounds=rounds, f64_refine_device=device,
        f64_refine_residual=residual, f64_refine_certify=certify,
    )
    assert tref["residual_sources"] == jref["residual_sources"] == sources
    assert len(tref["rel_res_f64"]) == len(jref["rel_res_f64"])
    assert len(tref["phase_walls"]["correction_solve"]) == len(
        jref["phase_walls"]["correction_solve"]
    )
    assert tref["rel_res_f64"][-1][0] <= rtol and jref["rel_res_f64"][-1][0] <= rtol
    assert tW.dtype == torch.float64 and tW.device.type == "cpu"
    assert np.linalg.norm(tW.numpy() - jW) <= 1e-6 * np.linalg.norm(jW)
    if certify == "sampled":
        cert = tref["sampled_certificate"]
        assert cert["refreshed"] is jref["sampled_certificate"]["refreshed"] is False
    elif residual == "update":
        assert tref["update_check"]["refreshed"] is False


def test_refinement_validation_matches_jax(monkeypatch):
    """The same errors of the same types, at the same points: an unknown
    residual mode before the base solve, the rest after it."""
    X, y, Omega = _data()
    Xj = jnp.asarray(X)
    jsys = JLinSys(JRBFLinOp(Xj, Xj, JKernelConfig(lengthscale=LS)), jnp.asarray(y), REG)
    jcfg = JPCGConfig(max_iters=2, precond_config=JNystromConfig(rank=8, rho=REG))
    cfg = PCGConfig(max_iters=2, precond_config=NystromConfig(rank=8, rho=REG))
    tsys, _ = _port_system(X, y, Omega, cfg)
    bad = [
        (dict(f64_refine_residual="cheap"), "unknown f64_refine_residual"),
        (dict(f64_refine_certify="maybe"), "unknown f64_refine_certify"),
        (dict(f64_refine_certify="sampled"), "requires"),
        (dict(f64_refine_residual="hybrid"), "hybrid"),
        (dict(f64_refine_residual="update", f64_refine_certify="sampled"), "requires"),
    ]
    for kwargs, match in bad:
        with pytest.raises(ValueError, match=match):
            jsys.solve(jcfg, jnp.zeros((N, 1), jnp.float32), key=0,
                       f64_refine_rounds=1, **kwargs)
        with pytest.raises(ValueError, match=match):
            tsys.solve(cfg, torch.zeros((N, 1)), key=0, f64_refine_rounds=1, **kwargs)
    # an operator with no float64 route
    A = np.asarray(tsys.A @ torch.eye(N))
    opaque = LinOp((N, N), lambda v: torch.from_numpy(A) @ v, dtype=torch.float32)
    with pytest.raises(ValueError, match="dense matrix or kernel operator"):
        LinSys(opaque, torch.from_numpy(y), REG).solve(
            cfg, torch.zeros((N, 1)), key=0, f64_refine_rounds=1
        )


def _spd_system(n, k, seed=0):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = (Q * np.logspace(0, -3, n)) @ Q.T
    B = rng.standard_normal((n, k))
    return torch.from_numpy(A.astype(np.float32)), torch.from_numpy(B.astype(np.float32))


def test_refinement_factors_once(monkeypatch):
    """The correction solves reuse the base solve's factor: Nyström's
    ``_update`` runs once across the base solve and every round (the port of
    the JAX package's test of the same name), here on a dense operand,
    whose float64 route is the dense branch."""
    calls = {"n": 0}
    orig = Nystrom._update

    def counting_update(self, *args, **kwargs):
        calls["n"] += 1
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(Nystrom, "_update", counting_update)
    A, B = _spd_system(96, 2)
    cfg = PCGConfig(
        max_iters=50, rtol=1e-9, precond_config=NystromConfig(rank=48, rho=1e-2)
    )
    W64, log = LinSys(A, B, reg=1e-2).solve(
        cfg, torch.zeros_like(B), callback_freq=10, key=0, f64_refine_rounds=2
    )
    assert calls["n"] == 1
    assert max(log["f64_refine"]["rel_res_f64"][-1]) < 1e-7
    assert W64.dtype == torch.float64
    R = B.double() - (A.double() @ W64 + 1e-2 * W64)
    assert torch.all(torch.linalg.norm(R, dim=0) / torch.linalg.norm(B.double(), dim=0) < 1e-7)


def test_sampled_certificates_draw_new_rows(monkeypatch):
    """Two sampled certificates of one solve take different rows (the JAX
    package seeds every draw with ``0x64 ^ n`` and so repeats its rows).
    At rtol 1e-9 the certificate after the first correction fails and the
    one after the second passes; 128 of the 512 rows are drawn each time."""
    X, y, Omega = _data()
    cfg = PCGConfig(
        max_iters=30, rtol=1e-9, precond_config=NystromConfig(rank=RANK, rho=REG)
    )
    sys_, P = _port_system(X, y, Omega, cfg)
    drawn = []
    orig_rows = LinSys._sample_rows

    def recording_rows(self, salt, n, s):
        idx = orig_rows(self, salt, n, s)
        drawn.append((salt, idx))
        return idx

    monkeypatch.setattr(LinSys, "_sample_rows", recording_rows)
    monkeypatch.setattr(
        LinSys, "_sampled_value64_residual",
        functools.partialmethod(LinSys._sampled_value64_residual, s=128),
    )
    W64, log = sys_.solve(
        cfg, torch.zeros((N, 1)), callback_freq=10, key=0, preconditioner=P,
        f64_refine_rounds=3, f64_refine_device="accel",
        f64_refine_residual="update", f64_refine_certify="sampled",
    )
    ref = log["f64_refine"]
    assert ref["residual_sources"] == ["evaluate", "evaluate", "value64_sampled"]
    certs = [idx for salt, idx in drawn if salt == 0x64]
    assert len(certs) == 2 and len(certs[0]) == 128
    assert not np.array_equal(certs[0], certs[1])
    assert ref["sampled_certificate"]["refreshed"] is False


def test_fold_in_is_pure_and_keyed():
    g = torch.Generator().manual_seed(7)
    a, b = fold_in(g, 1), fold_in(g, 1)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    c = fold_in(g, 2)
    assert not torch.equal(torch.rand(4, generator=fold_in(g, 1)), torch.rand(4, generator=c))
    assert g.initial_seed() == 7
