"""Routing and the host-side operands of K1b and the triangle K1c, on the CPU.

The kernels run only on a card (``tests/test_torch_cuda.py``, marked
``cuda``); here the CUDA wrappers are replaced by recorders that compute
with the plain versions, and ``kernel_dispatch._on_card`` is forced true, so
each caller shows which kernel it reaches. The operands the wrappers build
on the host (V's bf16 parts, the float64 transposed points, the run count
of the m axis) are pure functions of their inputs and are held to the plain
versions bit for bit.
"""

import numpy as np
import pytest
import torch

from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp, ShardedRBFLinOp
from rlaopt_tpu_torch.kernels.functions import scale_inputs
from rlaopt_tpu_torch.models import LinSys
from rlaopt_tpu_torch.ops import kernel_cuda, kernel_dispatch, kernel_plain
from rlaopt_tpu_torch.ops.kernel_tiers import split_bf16, split_rhs
from rlaopt_tpu_torch.parallel import make_mesh

H100_SMS = 132


def _points(n, d, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32))


@pytest.fixture
def recorded(monkeypatch):
    """Every compensated product takes the card's route, through recorders
    of the two K1c wrappers that compute with the plain version."""
    calls = []

    def triangle(kind, X, V, lengthscale, const_scaling=1.0):
        calls.append("gram_matvec_symmetric_comp")
        return kernel_plain.gram_matmat_comp(kind, X, X, V, lengthscale, const_scaling)

    def general(kind, X1, X2, V, lengthscale, const_scaling=1.0):
        calls.append("gram_matmat_comp")
        return kernel_plain.gram_matmat_comp(kind, X1, X2, V, lengthscale, const_scaling)

    monkeypatch.setattr(kernel_cuda, "gram_matvec_symmetric_comp", triangle)
    monkeypatch.setattr(kernel_cuda, "gram_matmat_comp", general)
    monkeypatch.setattr(kernel_dispatch, "_on_card", lambda impl, t: True)
    return calls


CFG = KernelConfig(const_scaling=1.1, lengthscale=0.8)


def test_one_data_set_reaches_the_triangle_k1c(recorded):
    """A one-data-set operator's compensated apply, LinSys's true residual
    and the refinement's update-mode matmat take the triangle form."""
    X = _points(90, 3, 1)
    y = _points(90, 1, 2)[:, 0]
    W = _points(90, 2, 3)
    K = RBFLinOp(X, X, CFG)
    hi, lo = K.matmat_compensated(W)
    assert recorded == ["gram_matvec_symmetric_comp"]
    want = kernel_plain.gram_matmat_comp("rbf", X, X, W, 0.8, 1.1)
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
    sys_ = LinSys(K, y, reg=0.1)
    sys_._true_internal_metrics(W[:, :1])
    assert recorded[1:] == ["gram_matvec_symmetric_comp"]
    update = sys_._compensated_update_matmat("accel")
    got = update(W[:, :1].double())
    assert recorded[2:] == ["gram_matvec_symmetric_comp"]
    assert got.dtype == torch.float64 and got.shape == (90, 1)


def test_two_data_sets_reach_the_general_k1c(recorded):
    """Two data sets (even of equal size and values), an oracle's
    submatrix, the sharded operator's replicated slabs and the general ring
    of two data sets take the general K1c (one data set in ring mode takes
    the half-ring, ``tests/test_torch_comp_routes.py``)."""
    X = _points(64, 3, 4)
    W = _points(64, 2, 5)
    RBFLinOp(X, X.clone(), CFG).matmat_compensated(W)
    assert recorded == ["gram_matmat_comp"]
    blk = torch.arange(0, 64, 3)
    RBFLinOp(X, X, CFG).blk_oracle(blk).matmat_compensated(W[blk])
    RBFLinOp(X, X, CFG).row_oracle(blk).matmat_compensated(W)
    assert recorded[1:] == ["gram_matmat_comp"] * 2
    del recorded[:]
    mesh = make_mesh(devices=["cpu"] * 4)
    ShardedRBFLinOp(X, X, CFG, mesh=mesh).matmat_compensated(W)
    ShardedRBFLinOp(X, X.clone(), CFG, mesh=mesh, memory_mode="ring").matmat_compensated(W)
    assert recorded and set(recorded) == {"gram_matmat_comp"}


def test_compensated_dispatch_rule(recorded):
    """``kernel_matmat_compensated``: ``symmetric`` with equal row counts
    takes the triangle, anything else the general kernel."""
    X, V = _points(40, 2, 6), _points(40, 1, 7)
    kernel_dispatch.kernel_matmat_compensated("rbf", X, X, V, 1.0, symmetric=True)
    kernel_dispatch.kernel_matmat_compensated("rbf", X, X, V, 1.0)
    kernel_dispatch.kernel_matmat_compensated("rbf", X, X[:30], V[:30], 1.0, symmetric=True)
    assert recorded == ["gram_matvec_symmetric_comp", "gram_matmat_comp", "gram_matmat_comp"]


@pytest.mark.parametrize("n,m,k,runs", [
    (10_000, 1_000_000, 1, 13),   # SAP's row oracle (config 4): 79 row blocks
    (10_000, 1_000_000, 16, 13),
    (1_000_000, 1_000_000, 1, 1),   # config 6's n: 7,813 row blocks
    (1_000_000, 1_000_000, 500, 1),  # config 6's sketch: the wide kernel
    (100_000, 100_000, 1, 1),     # 782 row blocks, three rounds of 264
    (1_000, 777, 7, 1),           # 13 column tiles: no run of 16
    (1_000, 64_000, 3, 62),       # 8 row blocks; runs of 16 tiles
    (30_000, 1_000_000, 1, 4),    # 235 row blocks: 4 x 235 = 940 <= 1,056
])
def test_tier_splits(n, m, k, runs):
    """K1b's run count of the m axis on an H100 (132 SMs, two 128-row
    blocks an SM): one run once the row blocks fill two rounds of the 264
    slots; else as many as keep the blocks within four rounds, each run 16
    column tiles or more; one past 16 columns."""
    assert kernel_cuda.tier_splits(n, m, k, H100_SMS) == runs


@pytest.mark.parametrize("k", [1, 16, 17, 64, 500])
@pytest.mark.parametrize("passes", [3, 1])
def test_split_rhs_is_the_plain_split(k, passes):
    """V's bf16 parts split once per call are, bit for bit, those of the
    plain tier's contraction (``split_bf16`` for bf16x3, one rounding for
    bfloat16), zero in the padding to a multiple of 16 columns."""
    V = torch.from_numpy(np.random.default_rng(k).standard_normal((300, k)).astype(np.float32))
    V[0, 0] = 1.0 + 2.0**-9  # a tie: round to nearest even
    vh, vl = split_rhs(V, passes)
    kp = -(-k // 16) * 16
    assert vh.dtype == torch.bfloat16 and vh.shape == (300, kp) and vh.is_contiguous()
    assert not vh[:, k:].any()
    hi, lo = split_bf16(V)
    assert torch.equal(vh[:, :k].float(), hi if passes == 3 else V.to(torch.bfloat16).float())
    if passes == 1:
        assert vl is None
    else:
        assert vl.shape == (300, kp) and not vl[:, k:].any()
        assert torch.equal(vl[:, :k].float(), lo)


@pytest.mark.parametrize("n,d,ls", [(300, 3, 0.7), (128, 16, 2.0), (1000, 28, None)])
def test_symmetric_comp_operand(n, d, ls):
    """The float64 tile's points (``comp_operand``, every form of K1c, K3c,
    K7 and K8): the plain version's float64 scaling,
    transposed, zero past n and d, padded to whole tiles of 128 points and
    chunks of 16 features; an ARD lengthscale divides feature by feature."""
    X = _points(n, d, 8)
    ls = torch.linspace(0.5, 2.0, d, dtype=torch.float64) if ls is None else ls
    XT = kernel_cuda.comp_operand(X, ls)
    assert XT.dtype == torch.float64
    assert XT.shape == (-(-d // 16) * 16, -(-n // 128) * 128)
    assert torch.equal(XT[:d, :n], scale_inputs(X.double(), ls).T)
    assert not XT[d:].any() and not XT[:, n:].any()
    with pytest.raises(ValueError, match="lengthscale"):
        kernel_cuda.comp_operand(X, torch.ones(d + 1))
