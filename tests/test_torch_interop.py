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
    tA = interop.kernel_operator(d_["X1"], d_["ls"], d_["scale"], jA.kind)
    assert tA.A1 is tA.A2 and tA.kind == "rbf"
    tP = interop.nystrom_preconditioner(P.U, P.S, P.rho, P.L)
    ts = interop.pcg_state(*(np.asarray(f) for f in js))
    assert _rel(tA @ ts.P_, jA @ js.P_) <= 1e-12
    assert _rel(tP._inverse_matmul(ts.R), inv_fn(pstate, js.R)) <= 1e-12

    tmask = torch.ones((k,), dtype=torch.bool)
    for _ in range(5):
        js = j_pcg.pcg_step(jA, reg, inv_fn, pstate, js, mask)
        ts = t_pcg.pcg_step(tA, reg, tP._inverse_matmul, ts, tmask)
    for name in ("W", "R", "Z", "P_", "RZ"):
        assert _rel(getattr(ts, name), getattr(js, name)) <= 1e-9, name
    assert np.array_equal(ts.ok.numpy(), np.asarray(js.ok))
