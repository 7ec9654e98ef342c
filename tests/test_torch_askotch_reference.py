"""The plain ASkotch reference of the benchmark (``portbench/reference/
askotch_krr.py``) against the port, float64 on the CPU: the port's SAP
through ``LinSys.solve`` and the reference's dense step, given the same
blocks and draws, agree; the reference's blocked Gram product is the dense
one; the bf16x3 row oracle reads under the cell's ``oracle_err`` limit and
the bfloat16 tier over it."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.reference import askotch_krr
from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
from rlaopt_tpu_torch.models import LinSys
from rlaopt_tpu_torch.preconditioners import NystromConfig
from rlaopt_tpu_torch.solvers import SAP, SAPAccelConfig, SAPConfig
from rlaopt_tpu_torch.solvers import factory as t_factory

ROOT = Path(__file__).resolve().parents[1]
N, D, K, BLK, RANK, STEPS, FREQ = 2000, 50, 3, 200, 20, 20, 5
REG = 1e-5 * N
ACCEL = (0.9 * BLK / N, N / BLK)
# float64 round-off over 20 steps, as tests/test_torch_sap.py holds the port to JAX
ITER_RTOL = 1e-10


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(21)
    X = torch.from_numpy(rng.standard_normal((N, D)) / D**0.5)
    y = torch.from_numpy(rng.standard_normal((N, K)))
    sched = np.stack([rng.choice(N, BLK, replace=False) for _ in range(STEPS)])
    g = torch.Generator().manual_seed(22)
    draws = [(torch.linalg.qr(torch.randn((BLK, RANK), generator=g, dtype=torch.float64))[0],
              torch.randn((BLK,), generator=g, dtype=torch.float64)) for _ in range(STEPS)]
    return X, y, sched, draws


@pytest.mark.parametrize("accel", [False, True])
def test_port_sap_matches_the_dense_askotch_step(monkeypatch, problem, accel):
    """20 steps of SAP (plain, and accelerated with μ = 0.9·blk/n, ν = n/blk),
    blocks of 200, Nyström rank 20 damped adaptively (ρ = reg + λ_r, reg =
    1e-5·n), 10 power
    iterations, matrix-free blocks, sampled metrics: the port's W (and V, Y)
    within 1e-10 of max|.| of the reference's, the port's draws pinned to
    the reference's blocks, sketches and power-iteration starts."""
    X, y, sched, draws = problem
    solvers = []

    def pinned(*a, **kw):
        solvers.append(SAP(*a, _block_schedule=sched, _draws=lambda t: draws[t], **kw))
        return solvers[-1]

    monkeypatch.setattr(t_factory, "SAP", pinned)
    op = RBFLinOp(X, X, KernelConfig(lengthscale=1.0))
    cfg = SAPConfig(max_iters=STEPS, rtol=1e-9, blk_sz=BLK, power_iters=10, blk_dense=False,
                    accel=accel, accel_config=SAPAccelConfig(mu=ACCEL[0], nu=ACCEL[1]) if accel
                    else None, precond_config=NystromConfig(rank=RANK, rho=REG))
    W, _ = LinSys(op, y, REG, op.row_oracle, op.blk_oracle).solve(
        cfg, torch.zeros_like(y), callback_freq=FREQ, key=3, metrics="sampled")
    Kd = askotch_krr.dense_gram(X, 1.0)
    state = (torch.zeros_like(y),) * 3
    for t in range(STEPS):
        blk = torch.from_numpy(sched[t])
        state = askotch_krr.askotch_step(Kd, y, REG, state, blk, *draws[t], 10,
                                         ACCEL if accel else None)
    port = solvers[-1].state
    assert port.t == STEPS
    for got, want in ((W, state[0]), (port.V, state[1]), (port.Y, state[2])):
        assert float((got - want).abs().max() / want.abs().max()) <= ITER_RTOL
    assert float(state[0].abs().max()) > 0


def test_gram_apply_is_the_dense_product():
    g = torch.Generator().manual_seed(5)
    X = torch.randn((300, 7), generator=g)
    V = torch.randn((300, 4), generator=g, dtype=torch.float64)
    rows = torch.randperm(300, generator=g)[:97]
    Xd = X.double() / 1.7
    sq = (Xd * Xd).sum(1)
    dense = torch.exp(-0.5 * torch.clamp(sq[:, None] + sq[None, :] - 2 * Xd @ Xd.T, min=0))
    got = askotch_krr.gram_apply(X, rows, V, 1.7, block_values=1000)
    assert torch.allclose(got, (dense @ V)[rows], rtol=1e-12, atol=1e-12)
    y = torch.randn((300, 4), generator=g, dtype=torch.float64)
    want = torch.linalg.norm((y - (dense @ V + 0.3 * V))[rows], dim=0) * (300 / 97) ** 0.5
    assert torch.allclose(askotch_krr.residual_norms(X, y, V, 0.3, 1.7, rows), want,
                          rtol=1e-12, atol=0)


def test_bf16x3_row_oracle_is_under_the_oracle_limit_and_bfloat16_over():
    """The row oracle of a block of 200 rows against n = 20,000 columns
    (float32 points N(0, 1)/√50, k = 10) on the CPU's plain tiers, judged
    as the cell judges it: bf16x3 under ``oracle_err``'s limit, the
    bfloat16 tier over it."""
    limit = json.loads((ROOT / "portbench/checks/krr10m-askotch-iters.json").read_text())[
        "limits"]["oracle_err"]
    oracle_err = spec.program("krr_sap").oracle_err
    g = torch.Generator().manual_seed(6)
    n = 20_000
    X = torch.randn((n, D), generator=g) / D**0.5
    V = torch.randn((n, 10), generator=g)
    blk = torch.randperm(n, generator=g)[:BLK]
    errs = {}
    for cd in ("bf16x3", "bfloat16"):
        op = RBFLinOp(X, X, KernelConfig(lengthscale=1.0), compute_dtype=cd)
        Y = op.row_oracle(blk) @ V
        errs[cd] = oracle_err(askotch_krr, X, 1.0, [(blk, V, Y)], torch.arange(BLK))
    assert errs["bf16x3"] < limit < errs["bfloat16"], errs
