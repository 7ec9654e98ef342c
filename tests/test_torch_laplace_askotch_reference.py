"""The plain Laplace reference of the benchmark (``portbench/reference/
laplace_krr.py``) against the port, float64 on the CPU: the port's SAP on a
Laplace operator through ``LinSys.solve`` and the reference's dense step,
given the same blocks and draws, agree, on SAP's dense-block path and
matrix-free; the reference's blocked Gram product and its tile are the
brute-force ones; the port's plain Laplace row oracle reads under the
cell's ``oracle_err`` limit and the TF32 reference over it, and the port's
dense block tile under ``blk_err``'s and the tile from bfloat16 points
over it; and the reference imports neither JAX nor the port, nor calls
``torch.cdist``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.reference import laplace_krr
from rlaopt_tpu_torch.kernels import KernelConfig, LaplaceLinOp
from rlaopt_tpu_torch.models import LinSys
from rlaopt_tpu_torch.preconditioners import NystromConfig
from rlaopt_tpu_torch.solvers import SAP, SAPAccelConfig, SAPConfig
from rlaopt_tpu_torch.solvers import factory as t_factory

ROOT = Path(__file__).resolve().parents[1]
CELL = "krr1m-laplace-askotch-iters"
N, D, K, BLK, RANK, STEPS, FREQ, LS = 2000, 50, 3, 200, 20, 20, 5, 8.0
REG = 1e-5 * N
ACCEL = (0.9 * BLK / N, N / BLK)
# float64 round-off over 20 steps, as tests/test_torch_sap.py holds the port to JAX
ITER_RTOL = 1e-10


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(31)
    X = torch.from_numpy(rng.standard_normal((N, D)) / D**0.5)
    y = torch.from_numpy(rng.standard_normal((N, K)))
    sched = np.stack([rng.choice(N, BLK, replace=False) for _ in range(STEPS)])
    g = torch.Generator().manual_seed(32)
    draws = [(torch.linalg.qr(torch.randn((BLK, RANK), generator=g, dtype=torch.float64))[0],
              torch.randn((BLK,), generator=g, dtype=torch.float64)) for _ in range(STEPS)]
    return X, y, sched, draws, laplace_krr.dense_gram(X, LS)


@pytest.mark.parametrize("blk_dense", [None, False], ids=["dense_block", "matrix_free"])
@pytest.mark.parametrize("accel", [False, True])
def test_port_sap_on_laplace_matches_the_dense_askotch_step(monkeypatch, problem, accel,
                                                            blk_dense):
    """20 steps of SAP on ``LaplaceLinOp`` (ℓ = 8; plain, and accelerated
    with μ = 0.9·blk/n, ν = n/blk), blocks of 200, Nyström rank 20 damped
    adaptively (ρ = reg + λ_r, reg = 1e-5·n), 10 power iterations, sampled
    metrics, the block tile materialized (SAP's default where it fits) or
    matrix-free: the port's W (and V, Y) within 1e-10 of max|.| of the
    reference's, the port's draws pinned to the reference's."""
    X, y, sched, draws, Kd = problem
    solvers = []

    def pinned(*a, **kw):
        solvers.append(SAP(*a, _block_schedule=sched, _draws=lambda t: draws[t], **kw))
        return solvers[-1]

    monkeypatch.setattr(t_factory, "SAP", pinned)
    op = LaplaceLinOp(X, X, KernelConfig(lengthscale=LS))
    cfg = SAPConfig(max_iters=STEPS, rtol=1e-9, blk_sz=BLK, power_iters=10,
                    blk_dense=blk_dense, accel=accel,
                    accel_config=SAPAccelConfig(mu=ACCEL[0], nu=ACCEL[1]) if accel else None,
                    precond_config=NystromConfig(rank=RANK, rho=REG))
    W, _ = LinSys(op, y, REG, op.row_oracle, op.blk_oracle).solve(
        cfg, torch.zeros_like(y), callback_freq=FREQ, key=3, metrics="sampled")
    assert (solvers[-1]._blk_dense_fn is not None) == (blk_dense is None)
    state = (torch.zeros_like(y),) * 3
    for t in range(STEPS):
        blk = torch.from_numpy(sched[t])
        state = laplace_krr.askotch_step(Kd, y, REG, state, blk, *draws[t], 10,
                                         ACCEL if accel else None)
    port = solvers[-1].state
    assert port.t == STEPS
    for got, want in ((W, state[0]), (port.V, state[1]), (port.Y, state[2])):
        assert float((got - want).abs().max() / want.abs().max()) <= ITER_RTOL
    assert float(state[0].abs().max()) > 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gram_apply_is_the_brute_force_laplace_product(dtype):
    """Row blocks of 3 rows (``block_values`` 1,000 over 300 points) against
    a float64 Gram summed over a (n, n, d) broadcast, from float32 and
    float64 points; the residual estimate from the same rows."""
    g = torch.Generator().manual_seed(5)
    X = torch.randn((300, 7), generator=g).to(dtype)
    V = torch.randn((300, 4), generator=g, dtype=torch.float64)
    rows = torch.randperm(300, generator=g)[:97]
    Xd = X.double() / 1.7
    dense = torch.exp(-(Xd[:, None, :] - Xd[None, :, :]).abs().sum(-1))
    got = laplace_krr.gram_apply(X, rows, V, 1.7, block_values=1000)
    assert torch.allclose(got, (dense @ V)[rows], rtol=1e-12, atol=1e-12)
    assert torch.allclose(laplace_krr.dense_gram(X, 1.7), dense, rtol=1e-13, atol=0)
    y = torch.randn((300, 4), generator=g, dtype=torch.float64)
    want = torch.linalg.norm((y - (dense @ V + 0.3 * V))[rows], dim=0) * (300 / 97) ** 0.5
    assert torch.allclose(laplace_krr.residual_norms(X, y, V, 0.3, 1.7, rows), want,
                          rtol=1e-12, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gram_block_is_the_brute_force_laplace_tile(dtype):
    """``K[rows, cols]`` against the same brute-force float64 Gram, from
    float32 and float64 points, in float64 and (from float32 points) in
    float32 within float32 round-off."""
    g = torch.Generator().manual_seed(8)
    X = torch.randn((300, 7), generator=g).to(dtype)
    rows, cols = torch.randperm(300, generator=g)[:41], torch.randperm(300, generator=g)[:97]
    Xd = X.double() / 1.7
    dense = torch.exp(-(Xd[:, None, :] - Xd[None, :, :]).abs().sum(-1))
    want = dense[rows][:, cols]
    assert torch.allclose(laplace_krr.gram_block(X, rows, cols, 1.7), want, rtol=1e-13, atol=0)
    got = laplace_krr.gram_block(X.float(), rows, cols, 1.7, torch.float32)
    assert got.dtype == torch.float32
    assert torch.allclose(got.double(), want, rtol=1e-5, atol=0)


def test_tf32_reference_rounds_only_the_contraction():
    """float32 without TF32 within float32 round-off of the float64
    reference; with TF32 farther than that, by the rounding of K and V."""
    g = torch.Generator().manual_seed(7)
    X = torch.randn((2000, D), generator=g) / D**0.5
    V = torch.randn((2000, 3), generator=g)
    rows = torch.arange(0, 2000, 9)
    exact = laplace_krr.gram_apply(X, rows, V, LS)
    f32 = laplace_krr.gram_apply(X, rows, V, LS, torch.float32).double()
    tf32 = laplace_krr.gram_apply(X, rows, V, LS, torch.float32, tf32=True).double()
    err = lambda a: float((a - exact).abs().max() / exact.abs().max())  # noqa: E731
    assert err(f32) < 1e-6 < err(tf32)


def test_plain_laplace_row_oracle_is_under_the_oracle_limit_and_tf32_over():
    """The row oracle of a block of 200 rows against n = 20,000 columns
    (float32 points N(0, 1)/√50, ℓ = 8, k = 10) on the CPU's plain exact
    tier, judged as the cell judges it: under ``oracle_err``'s limit; the
    control, the TF32 reference in the program's place, over it."""
    limit = json.loads((ROOT / f"portbench/checks/{CELL}.json").read_text())[
        "limits"]["oracle_err"]
    sap = spec.program("krr_sap_exact")
    g = torch.Generator().manual_seed(6)
    n = 20_000
    X = torch.randn((n, D), generator=g) / D**0.5
    V = torch.randn((n, 10), generator=g)
    blk = torch.randperm(n, generator=g)[:BLK]
    op = LaplaceLinOp(X, X, KernelConfig(lengthscale=LS))
    applies = [(blk, V, op.row_oracle(blk) @ V)]
    pos = torch.arange(BLK)
    port = sap.krr_sap.oracle_err(laplace_krr, X, LS, applies, pos)
    control = sap.tf32_oracle_err(laplace_krr, X, LS, applies, pos)
    assert port < limit < control, (port, control)


def test_port_dense_block_is_under_the_block_limit_and_bfloat16_points_over():
    """The dense tile K[blk, blk] of a block of 1,000 of n = 20,000 float32
    points N(0, 1)/√50 (ℓ = 8) as SAP takes it from the Laplace operator,
    judged as the cell judges it on 200 of its rows: under ``blk_err``'s
    limit; the control, the tile from the points rounded to bfloat16, over
    it."""
    limit = json.loads((ROOT / f"portbench/checks/{CELL}.json").read_text())[
        "limits"]["blk_err"]
    sap = spec.program("krr_sap_exact")
    g = torch.Generator().manual_seed(9)
    n = 20_000
    X = torch.randn((n, D), generator=g) / D**0.5
    blk = torch.randperm(n, generator=g)[:1000]
    pos = torch.randperm(1000, generator=g)[:200]
    op = LaplaceLinOp(X, X, KernelConfig(lengthscale=LS))
    tile = (blk, pos, op.blk_dense(blk)[pos])
    port = sap.blk_err(laplace_krr, X, LS, tile)
    control = sap.blk_err(laplace_krr, X, LS, tile, control=True)
    assert port < limit < control, (port, control)


def test_reference_imports_neither_jax_nor_the_port_and_calls_no_cdist():
    """Imported alone in a fresh interpreter, the reference loads no module
    of JAX, of the JAX package or of the port; its code never calls
    ``cdist``, the routine of the program's dense block."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench.reference import laplace_krr; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'rlaopt_tpu', 'rlaopt_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"
    tree = ast.parse((ROOT / "portbench/reference/laplace_krr.py").read_text())
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)} | {
        n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert "cdist" not in names
