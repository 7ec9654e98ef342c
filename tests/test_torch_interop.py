"""Carrying a solve across from the JAX package: Nyström factors and a
mid-solve PCG state built there continue here, step for step (float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.kernels import KernelConfig as JKernelConfig
from rlaopt_tpu.kernels import RBFLinOp as JRBFLinOp
from rlaopt_tpu.preconditioners import Nystrom as JNystrom
from rlaopt_tpu.preconditioners import NystromConfig as JNystromConfig
from rlaopt_tpu.solvers import pcg as j_pcg
from rlaopt_tpu_torch import interop
from rlaopt_tpu_torch.solvers import pcg as t_pcg


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("low_precision_path", [False, True])
def test_mid_solve_state_continues_in_the_port(low_precision_path):
    rng = np.random.default_rng(21)
    n, d, k, reg = 300, 5, 2, 0.2
    X = jnp.asarray(rng.standard_normal((n, d)))
    B = jnp.asarray(rng.standard_normal((n, k)))
    jA = JRBFLinOp(X, X, JKernelConfig(lengthscale=1.4, const_scaling=1.3))
    P = JNystrom(JNystromConfig(rank=30, rho=reg))
    P._update(jA, key=3)
    P._update_damping(baseline_rho=reg)
    if low_precision_path:  # the f32 route's extra Cholesky, here in f64
        P.low_precision = True
    inv_fn, pstate = P._functional_inverse()
    js = j_pcg.pcg_init(jA, B, reg, jnp.zeros((n, k)), inv_fn, pstate, w_zero=True)
    mask = jnp.ones((k,), bool)
    for _ in range(4):
        js = j_pcg.pcg_step(jA, reg, inv_fn, pstate, js, mask)

    d_ = jA._data
    tA = interop.kernel_operator(d_["X1"], d_["ls"], d_["scale"], jA.kind, device="cpu")
    assert tA.A1 is tA.A2 and tA.kind == "rbf"
    tP = interop.nystrom_preconditioner(P.U, P.S, P.rho, P.L, device="cpu")
    ts = interop.pcg_state(*(np.asarray(f) for f in js), device="cpu")
    assert _rel(tA @ ts.P_, jA @ js.P_) <= 1e-12
    assert _rel(tP._inverse_matmul(ts.R), inv_fn(pstate, js.R)) <= 1e-12

    t_inv_fn, t_pstate = tP._functional_inverse()
    tmask = torch.ones((k,), dtype=torch.bool)
    for _ in range(5):
        js = j_pcg.pcg_step(jA, reg, inv_fn, pstate, js, mask)
        ts = t_pcg.pcg_step(tA, reg, t_inv_fn, t_pstate, ts, tmask)
    for name in ("W", "R", "Z", "P_", "RZ"):
        assert _rel(getattr(ts, name), getattr(js, name)) <= 1e-9, name
    assert np.array_equal(ts.ok.numpy(), np.asarray(js.ok))


@pytest.mark.parametrize("cd", ["bf16x3", "bfloat16"])
def test_tier_operator_applies_like_jax(cd):
    """A bf16 tier operator carried across from the JAX package (its payload
    and ``compute_dtype``) applies like the JAX tier: the port's triangle
    (k = 3, through the operator) against ``kernel_matvec_symmetric`` in
    interpret mode at n = 2T, where both schedules mirror the same tile.
    The tier tolerance is float32 summation order: 3e-6 for bf16x3's split
    mirror, 1e-6 for bfloat16."""
    from rlaopt_tpu.ops.kernel_pallas import kernel_matvec_symmetric

    rng = np.random.default_rng(23)
    X = jnp.asarray(rng.standard_normal((128, 28)).astype(np.float32))
    V = rng.standard_normal((128, 3)).astype(np.float32)
    jA = JRBFLinOp(X, X, JKernelConfig(lengthscale=5.0, const_scaling=0.7),
                   compute_dtype=cd)
    d_ = jA._data
    tA = interop.kernel_operator(d_["X1"], d_["ls"], d_["scale"], jA.kind,
                                 device="cpu", compute_dtype=jA.compute_dtype)
    assert tA.compute_dtype == cd and tA._tier is not None
    import rlaopt_tpu_torch.ops.kernel_plain as kp

    ref = kernel_matvec_symmetric(
        "rbf", X, jnp.asarray(V), d_["ls"], d_["scale"], compute_dtype=cd,
        tile=64, interpret=True,
    )
    # the operator's apply takes K2b's schedule at its own tile (64): at
    # n = 2T = 128 it mirrors the same tile as the JAX triangle at T = 64
    assert kp.SYMMETRIC_TILE == 64
    got = tA @ torch.from_numpy(V)
    assert _rel(got, ref) <= (3e-6 if cd == "bf16x3" else 1e-6)


def test_mid_solve_sap_state_continues_in_the_port():
    """A JAX SAP solve (accelerated, Newton blocks at rho = reg: the exact
    step) stopped after 6 steps continues in the port from
    ``interop.sap_state``, with ``interop.newton_preconditioner`` applying
    the JAX factor of one block, and both run 6 more steps on one schedule:
    W, V and Y to 1e-10."""
    from rlaopt_tpu.preconditioners import Newton as JNewton
    from rlaopt_tpu.preconditioners import NewtonConfig as JNewtonConfig
    from rlaopt_tpu.models import LinSys as JLinSys
    from rlaopt_tpu.solvers import SAP as JSAP
    from rlaopt_tpu.solvers import SAPAccelConfig as JSAPAccelConfig
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.preconditioners import NewtonConfig
    from rlaopt_tpu_torch.solvers import SAP, SAPAccelConfig

    rng = np.random.default_rng(25)
    n, d, k, reg, blk_sz = 120, 4, 2, 0.1, 30
    X = rng.standard_normal((n, d))
    B = rng.standard_normal((n, k))
    sched = np.stack([rng.choice(n, blk_sz, replace=False) for _ in range(12)])
    jA = JRBFLinOp(jnp.asarray(X), jnp.asarray(X), JKernelConfig(lengthscale=1.2))
    jsys = JLinSys(jA, jnp.asarray(B), reg, jA.row_oracle, jA.blk_oracle)
    kw = dict(blk_sz=blk_sz, accel=True, power_iters=5, _block_schedule=sched)
    js = JSAP(jsys, jnp.zeros((n, k)), JNewtonConfig(rho=reg),
              accel_config=JSAPAccelConfig(mu=0.05, nu=4.0), key=0, **kw)
    js._run_chunk(6)

    d_ = jA._data
    tA = interop.kernel_operator(d_["X1"], d_["ls"], d_["scale"], jA.kind, device="cpu")
    tsys = LinSys(tA, torch.from_numpy(B), reg, tA.row_oracle, tA.blk_oracle)
    ts = SAP(tsys, torch.zeros((n, k), dtype=torch.float64), NewtonConfig(rho=reg),
             accel_config=SAPAccelConfig(mu=0.05, nu=4.0), key=0, **kw)
    ts.state = interop.sap_state(*(np.asarray(f) for f in (js.state.W, js.state.V,
                                                           js.state.Y, js.state.t)),
                                  device="cpu")
    assert ts.state.t == 6

    blk = sched[6]
    jP = JNewton(JNewtonConfig(rho=reg))
    jP._update(jA.blk_dense(jnp.asarray(blk)))
    tP = interop.newton_preconditioner(jP.L, reg, device="cpu")
    R = rng.standard_normal((blk_sz, k))
    assert _rel(tP._inverse_matmul(torch.from_numpy(R)), jP._inverse_matmul(jnp.asarray(R))) <= 1e-12
    assert _rel(tP @ torch.from_numpy(R), jP @ jnp.asarray(R)) <= 1e-12

    js._run_chunk(6)
    ts._run_chunk(6)
    for name in ("W", "V", "Y"):
        assert _rel(getattr(ts.state, name), getattr(js.state, name)) <= 1e-10, name
