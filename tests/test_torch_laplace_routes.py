"""Routing and the host-side operands of the Laplace kernels K3 and K3c, on
the CPU.

The kernels run only on a card (``tests/test_torch_cuda.py``, marked
``cuda``); here the CUDA wrappers are replaced by recorders that compute
with the plain versions, and ``kernel_dispatch._on_card`` is forced true, so
each caller shows which kernel it reaches (and the operands an operator
keeps for K3's tile are checked where the tile takes them): a
one-data-set compensated apply
the triangle K3c (``gram_matvec_symmetric_comp``), two data sets the
general K3c, K3 its Hopper tile (``laplace_matmat_narrow``) up to 16
columns and past that K1's 3xTF32 kernel (the shared wide entry
``rl_gram_matmat_wide`` with Laplace's code), on the operands an operator
keeps. The operands the wrappers build on the host (K3's transposed
points, the triangle's float64 points, the run count of the m axis) are
pure functions of their inputs and are held to the plain versions bit for
bit.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from rlaopt_tpu_torch.kernels import KernelConfig, LaplaceLinOp, ShardedLaplaceLinOp, linop
from rlaopt_tpu_torch.kernels.functions import scale_inputs
from rlaopt_tpu_torch.models import LinSys
from rlaopt_tpu_torch.ops import kernel_cuda, kernel_dispatch, kernel_plain
from rlaopt_tpu_torch.parallel import make_mesh
from rlaopt_tpu_torch.preconditioners import NystromConfig
from rlaopt_tpu_torch.solvers import PCGConfig, SAPConfig

H100_SMS = 132
CFG = KernelConfig(const_scaling=1.1, lengthscale=2.5)


def _points(n, d, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32))


@pytest.fixture
def recorded(monkeypatch):
    """Every Laplace product takes the card's route, through recorders of
    the wrappers that compute with the plain versions: (wrapper, k) per
    call; the wide K3 is recorded where ``laplace_matmat`` launches it, the
    shared wide entry (``kernel_cuda._wide``), with the family code and
    the operands it is handed, computing from their points."""
    calls = []

    def triangle(kind, X, V, lengthscale, const_scaling=1.0):
        calls.append(("gram_matvec_symmetric_comp", kind))
        return kernel_plain.gram_matmat_comp(kind, X, X, V, lengthscale, const_scaling)

    def general(X1, X2, V, lengthscale, const_scaling=1.0):
        calls.append(("laplace_matmat_comp", "laplace"))
        return kernel_plain.gram_matmat_comp("laplace", X1, X2, V, lengthscale, const_scaling)

    def narrow(X1, X2, V, lengthscale, const_scaling=1.0, operands=None):
        calls.append(("laplace_matmat_narrow", 1 if V.ndim == 1 else V.shape[1]))
        if operands is not None:  # an operator's kept operands: the wrapper's own, bit for bit
            for XT, X in zip(operands, (X1, X2)):
                assert torch.equal(XT, kernel_cuda.tile_operand(X, lengthscale))
        return kernel_plain.gram_matmat("laplace", X1, X2, V, lengthscale, const_scaling)

    def wide(code, X1, X2, V, XT1, XT2, const_scaling):
        calls.append(("rl_gram_matmat_wide", V.shape[1]))
        assert code == kernel_cuda.KIND_CODES["laplace"]
        (n, d), m = X1.shape, X2.shape[0]
        wide.operands.append((XT1, XT2))
        # the operands' points are the plain version's scaled ones, bit for bit
        P1, P2 = (XT[:d, :r].T.contiguous() for XT, r in ((XT1, n), (XT2, m)))
        return kernel_plain.gram_matmat("laplace", P1, P2, V, 1.0, const_scaling)

    def check_dtypes(dtypes, *tensors):
        assert all(t.dtype == dt for t, dt in zip(tensors, dtypes))

    def k5(X, V, lengthscale, const_scaling=1.0, operand=None):
        calls.append(("laplace_matvec_symmetric", 1 if V.ndim == 1 else V.shape[1]))
        if operand is not None:  # an operator's kept operand: the wrapper's own, bit for bit
            assert torch.equal(operand, kernel_cuda.tile_operand(X, lengthscale))
        k5.operands.append(operand)
        return kernel_plain.gram_matvec_symmetric("laplace", X, V, lengthscale, const_scaling)

    k5.operands, wide.operands = [], []

    monkeypatch.setattr(kernel_cuda, "gram_matvec_symmetric_comp", triangle)
    monkeypatch.setattr(kernel_cuda, "laplace_matmat_comp", general)
    monkeypatch.setattr(kernel_cuda, "laplace_matmat_narrow", narrow)
    monkeypatch.setattr(kernel_cuda, "_wide", wide)
    monkeypatch.setattr(kernel_cuda, "_check_tensors", check_dtypes)
    monkeypatch.setattr(kernel_cuda, "laplace_matvec_symmetric", k5)
    monkeypatch.setattr(kernel_dispatch, "_on_card", lambda impl, t: True)
    return calls


TRIANGLE = ("gram_matvec_symmetric_comp", "laplace")
GENERAL = ("laplace_matmat_comp", "laplace")


def test_one_data_set_reaches_the_triangle_k3c(recorded):
    """A one-data-set Laplace operator's compensated apply, LinSys's true
    residual and the refinement's update-mode matmat take the triangle K3c,
    with the general plain version's values."""
    X, y, W = _points(90, 3, 1), _points(90, 1, 2)[:, 0], _points(90, 2, 3)
    K = LaplaceLinOp(X, X, CFG)
    hi, lo = K.matmat_compensated(W)
    assert recorded == [TRIANGLE]
    want = kernel_plain.gram_matmat_comp("laplace", X, X, W, 2.5, 1.1)
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
    sys_ = LinSys(K, y, reg=0.1)
    sys_._true_internal_metrics(W[:, :1])
    assert recorded[1:] == [TRIANGLE]
    got = sys_._compensated_update_matmat("accel")(W[:, :1].double())
    assert recorded[2:] == [TRIANGLE]
    assert got.dtype == torch.float64 and got.shape == (90, 1)


def test_two_data_sets_reach_the_general_k3c(recorded):
    """Two data sets (even of equal size and values), an oracle's
    submatrix, the sharded operator's replicated slabs and the general ring
    of two data sets take the general K3c (E3's ring, one data set, takes
    the half-ring: ``tests/test_torch_comp_routes.py``)."""
    X, W = _points(64, 3, 4), _points(64, 2, 5)
    LaplaceLinOp(X, X.clone(), CFG).matmat_compensated(W)
    blk = torch.arange(0, 64, 3)
    LaplaceLinOp(X, X, CFG).blk_oracle(blk).matmat_compensated(W[blk])
    LaplaceLinOp(X, X, CFG).row_oracle(blk).matmat_compensated(W)
    assert recorded == [GENERAL] * 3
    del recorded[:]
    mesh = make_mesh(devices=["cpu"] * 3)
    ShardedLaplaceLinOp(X, X, CFG, mesh=mesh).matmat_compensated(W)
    ShardedLaplaceLinOp(X, X.clone(), CFG, mesh=mesh, memory_mode="ring").matmat_compensated(W)
    assert recorded and set(recorded) == {GENERAL}


def test_compensated_dispatch_rule(recorded):
    """``kernel_matmat_compensated``: ``symmetric`` with equal row counts
    takes the triangle in every family, Laplace included; anything else
    the general kernel of the family."""
    X, V = _points(40, 2, 6), _points(40, 1, 7)
    kernel_dispatch.kernel_matmat_compensated("laplace", X, X, V, 1.0, symmetric=True)
    kernel_dispatch.kernel_matmat_compensated("laplace", X, X, V, 1.0)
    kernel_dispatch.kernel_matmat_compensated("laplace", X, X[:30], V[:30], 1.0, symmetric=True)
    kernel_dispatch.kernel_matmat_compensated("matern32", X, X, V, 1.0, symmetric=True)
    assert recorded == [TRIANGLE, GENERAL, GENERAL, ("gram_matvec_symmetric_comp", "matern32")]


@pytest.mark.parametrize("k,symmetric,route", [
    (1, False, "laplace_matmat_narrow"),
    (16, False, "laplace_matmat_narrow"),
    (17, False, "rl_gram_matmat_wide"),
    (500, False, "rl_gram_matmat_wide"),
    (1, True, "laplace_matvec_symmetric"),
    (16, True, "laplace_matvec_symmetric"),
    (17, True, "rl_gram_matmat_wide"),
])
def test_k3_routes_by_width(recorded, k, symmetric, route):
    """K3: its tile up to 16 columns, the 3xTF32 wide kernel past 16 (the
    Nyström sketch); one data set K5 up to 16 columns. The values are the
    plain product's."""
    X1, V = _points(50, 4, 8), _points(50, k, 9)
    got = kernel_dispatch.kernel_matmat("laplace", X1, X1, V, 2.0, 0.7, symmetric=symmetric)
    assert recorded == [(route, k)]
    assert torch.equal(got, kernel_plain.gram_matmat("laplace", X1, X1, V, 2.0, 0.7))


def test_path_b_reaches_the_triangle_at_every_boundary(recorded):
    """Path B (Nyström-PCG on ``LaplaceLinOp``): the sketch takes the wide
    K3 (rank 20 > 16 columns), each step K5, every logged boundary's true
    residual the triangle K3c; nothing takes the general K3c."""
    n = 200
    X, y = _points(n, 5, 10), _points(n, 1, 11)[:, 0]
    K = LaplaceLinOp(X, X, KernelConfig(lengthscale=4.0))
    cfg = PCGConfig(max_iters=6, rtol=1e-12, precond_config=NystromConfig(rank=20, rho=0.5))
    _, log = LinSys(K, y, reg=0.5).solve(cfg, torch.zeros((n, 1)), callback_freq=3, key=0)
    names = [c[0] for c in recorded]
    assert ("rl_gram_matmat_wide", 20) in recorded
    assert names.count("laplace_matvec_symmetric") >= 6
    assert names.count("gram_matvec_symmetric_comp") >= len(log)
    assert "laplace_matmat_comp" not in names and "laplace_matmat_narrow" not in names


def test_path_a_reaches_the_tile_and_the_triangle(recorded):
    """Path A (SAP on ``LaplaceLinOp`` with its row and block oracles,
    sampled metrics): each step's row oracle (k = 1) takes K3's tile, the
    final true residual the triangle K3c, never the general K3c."""
    n, iters = 256, 6
    X, y = _points(n, 4, 12), _points(n, 1, 13)[:, 0]
    K = LaplaceLinOp(X, X, KernelConfig(lengthscale=3.0))
    sys_ = LinSys(K, y, reg=0.5, A_row_oracle=K.row_oracle, A_blk_oracle=K.blk_oracle)
    cfg = SAPConfig(max_iters=iters, rtol=1e-12, blk_sz=32,
                    precond_config=NystromConfig(rank=8, rho=0.5), accel=False)
    _, log = sys_.solve(cfg, torch.zeros((n, 1)), callback_freq=3, key=0, metrics="sampled")
    assert max(log) == iters
    narrow = [c for c in recorded if c[0] == "laplace_matmat_narrow"]
    assert len(narrow) >= iters and all(k == 1 for _, k in narrow)
    assert TRIANGLE in recorded and GENERAL not in recorded
    assert recorded[-1] == TRIANGLE


def test_path_a_builds_the_points_operand_once(recorded, monkeypatch):
    """Path A's row oracles share the operator's operand of the data set
    for K3's tile: built once over the solve, where each call built it
    before; each oracle builds one of its own rows (a step's block, the
    sampled metrics' rows). A symmetric apply (K5, the tile's triangle
    form) builds the operator's own at its first use; the wide K3 takes
    that one."""
    built = []

    def counted(X, lengthscale):
        built.append(X)
        return kernel_cuda.tile_operand(X, lengthscale)

    monkeypatch.setattr(linop, "tile_operand", counted)
    n, iters = 256, 6
    X, y = _points(n, 4, 12), _points(n, 1, 13)[:, 0]
    K = LaplaceLinOp(X, X, KernelConfig(lengthscale=3.0))
    K @ _points(n, 1, 16)
    K @ _points(n, 20, 17)
    assert len(built) == 1 and built[0] is X
    assert all(XT is K._tile_ops[0].get() for XT in kernel_cuda._wide.operands[0])
    sys_ = LinSys(K, y, reg=0.5, A_row_oracle=K.row_oracle, A_blk_oracle=K.blk_oracle)
    cfg = SAPConfig(max_iters=iters, rtol=1e-12, blk_sz=32,
                    precond_config=NystromConfig(rank=8, rho=0.5), accel=False)
    sys_.solve(cfg, torch.zeros((n, 1)), callback_freq=3, key=0, metrics="sampled")
    steps = sum(1 for c in recorded if c[0] == "laplace_matmat_narrow")
    assert steps >= iters and sum(1 for P in built if P is X) == 1
    assert len(built) == steps + 1


@pytest.mark.parametrize("n,d,ls", [(300, 3, 0.7), (128, 16, 2.0), (1000, 50, 8.0),
                                    (777, 28, None)])
def test_laplace_operand_is_the_plain_scaled_points(n, d, ls):
    """K3's points: the float32 ``X / ℓ`` of the plain version (and of the
    float32 kernels), transposed, zero past n and d, padded to whole tiles
    of 128 points and chunks of 32 features; an ARD lengthscale divides
    feature by feature."""
    X = _points(n, d, 14)
    ls = torch.linspace(0.5, 2.0, d) if ls is None else ls
    XT = kernel_cuda.tile_operand(X, ls)
    assert XT.dtype == torch.float32 and XT.is_contiguous()
    assert XT.shape == (-(-d // 32) * 32, -(-n // 128) * 128)
    assert torch.equal(XT[:d, :n], scale_inputs(X, ls).T)
    assert not XT[d:].any() and not XT[:, n:].any()


@pytest.mark.parametrize("ls", [8.0, 32.0, "ard"])
def test_triangle_k3c_operand_is_the_plain_float64_scaling(ls):
    """The triangle K3c's points are the general plain version's float64
    ``X / ℓ`` (``gram_matmat_comp`` scales the float64 cast), transposed
    and padded: bit for bit, at the paths' lengthscales and an ARD one."""
    X = _points(300, 50, 15)
    ls = torch.linspace(6.0, 10.0, 50, dtype=torch.float64) if ls == "ard" else ls
    XT = kernel_cuda.comp_operand(X, ls)
    assert XT.dtype == torch.float64 and XT.shape == (64, 384)
    assert torch.equal(XT[:50, :300], scale_inputs(X.double(), ls).T)
    assert not XT[50:].any() and not XT[:, 300:].any()


@pytest.mark.parametrize("n,m,k,runs", [
    (10_000, 1_000_000, 1, 13),    # SAP's row oracle (path A): 79 row tiles
    (10_000, 1_000_000, 16, 13),
    (100_000, 100_000, 1, 1),      # 782 row tiles fill two rounds of 264
    (100_000, 100_000, 500, 1),    # the wide kernel
    (1_000, 777, 7, 1),            # 7 column tiles: no run of 8
    (1_000, 300_000, 3, 132),      # 8 row tiles; 132 runs of 18 tiles
    (30_000, 1_000_000, 1, 4),     # 235 row tiles
])
def test_laplace_splits(n, m, k, runs):
    """K3's run count of the m axis on an H100 (132 SMs, two blocks of 128
    rows an SM): one run once the row tiles fill two rounds of the 264
    slots; else as many as keep the blocks within four rounds, each run 8
    column tiles of 128 or more; one past 16 columns."""
    assert kernel_cuda.tile_splits(n, m, k, H100_SMS) == runs


def test_path_b_hands_k5_the_operators_operand(recorded, monkeypatch):
    """Path B (Nyström-PCG on one ``LaplaceLinOp``): K5's operand of the
    points is built once over the solve and that one tensor is handed to
    every K5 call, where each call built its own before."""
    built = []

    def counted(X, lengthscale):
        built.append(X)
        return kernel_cuda.tile_operand(X, lengthscale)

    monkeypatch.setattr(linop, "tile_operand", counted)
    n = 200
    X, y = _points(n, 5, 10), _points(n, 1, 11)[:, 0]
    K = LaplaceLinOp(X, X, KernelConfig(lengthscale=4.0))
    cfg = PCGConfig(max_iters=6, rtol=1e-12, precond_config=NystromConfig(rank=20, rho=0.5))
    LinSys(K, y, reg=0.5).solve(cfg, torch.zeros((n, 1)), callback_freq=3, key=0)
    given = kernel_cuda.laplace_matvec_symmetric.operands
    assert len(given) >= 6 and len(built) == 1 and built[0] is X
    assert all(g is given[0] for g in given) and given[0] is K._tile_ops[0].get()


def test_e3_half_ring_keeps_each_shards_operand(recorded, monkeypatch):
    """E3's half-ring (one data set, ring mode, 3 positions): each
    position's diagonal block (K5) takes the operand of its own shard,
    built once per operator over two matvecs; the ring's product is the
    plain one's."""
    built = []

    def counted(X, lengthscale):
        built.append(X)
        return kernel_cuda.tile_operand(X, lengthscale)

    def pair(X1, X2, V2, V1, lengthscale, const_scaling=1.0, operands=None):
        return (kernel_plain.gram_matmat("laplace", X1, X2, V2, lengthscale, const_scaling),
                kernel_plain.gram_matmat("laplace", X2, X1, V1, lengthscale, const_scaling))

    monkeypatch.setattr(linop, "tile_operand", counted)
    monkeypatch.setattr(kernel_cuda, "laplace_pair", pair)
    X, v = _points(90, 3, 20), _points(90, 1, 21)[:, 0]
    K = ShardedLaplaceLinOp(X, X, CFG, mesh=make_mesh(devices=["cpu"] * 3), memory_mode="ring")
    outs = [K @ v for _ in range(2)]
    given = kernel_cuda.laplace_matvec_symmetric.operands
    assert len(built) == 3 and len(given) == 6
    assert all(g is b for g, b in zip(given, given[3:])) and all(g is not None for g in given)
    want = kernel_plain.gram_matmat("laplace", X, X, v[:, None], 2.5, 1.1)[:, 0]
    for out in outs:
        assert torch.allclose(out, want, rtol=0, atol=1e-5 * want.abs().max().item())


class _K5Entry:
    """``rl_laplace_matvec_symmetric`` emulated on the host, with the
    arguments of its ctypes signature (XT, V, out, n, npad, d, dpad, k, c,
    stream): ``c·k(P, P) @ V`` in float64 from the operand's points P."""

    def __init__(self):
        self.calls = []

    def rl_laplace_matvec_symmetric(self, *args):
        assert len(args) == len(kernel_cuda._SIGNATURES["rl_laplace_matvec_symmetric"])
        xt, v, out, n, npad, d, dpad, k, c, _stream = args
        assert npad % kernel_cuda.TILE_POINTS == 0 and dpad % kernel_cuda.TILE_FEAT == 0

        def host(ptr, shape):
            return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)),
                                         shape=shape)

        XT = host(xt, (dpad, npad)).copy()
        P = XT[:d, :n].T.astype(np.float64)
        Kv = np.exp(-np.abs(P[:, None, :] - P[None, :, :]).sum(-1)) @ host(v, (n, k))
        host(out, (n, k))[:] = c * Kv
        self.calls.append({"ptr": xt, "XT": XT, "n": n, "d": d, "k": k})
        return 0


@pytest.fixture
def k5_entry(monkeypatch):
    """K5's wrapper on CPU tensors down to the emulated entry."""
    entry = _K5Entry()

    def check_dtypes(dtypes, *tensors):
        assert all(t.dtype == dt for t, dt in zip(tensors, dtypes))

    monkeypatch.setattr(kernel_cuda, "_check_tensors", check_dtypes)
    monkeypatch.setattr(kernel_cuda, "build", lambda: None)
    monkeypatch.setattr(kernel_cuda, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setitem(kernel_cuda._lib, "handle", entry)
    return entry


@pytest.mark.parametrize("n,d,k,ls", [(300, 3, 1, 0.7), (130, 28, 10, 32.0), (257, 50, 16, "ard")])
def test_k5_hands_its_entry_k3s_operand(k5_entry, n, d, k, ls):
    """K5's wrapper hands its entry the tile's operand (``tile_operand``: the
    plain version's scaled points, transposed, padded) bit for bit, built
    in the call or given; the product on it is the plain version's."""
    X, V = _points(n, d, 22), _points(n, k, 23)
    ls = torch.linspace(0.5, 2.0, d) * d if ls == "ard" else ls
    got = kernel_cuda.laplace_matvec_symmetric(X, V, ls, 0.9)
    call = k5_entry.calls[-1]
    assert np.array_equal(call["XT"], kernel_cuda.tile_operand(X, ls).numpy())
    assert (call["n"], call["d"], call["k"]) == (n, d, k)
    want = kernel_plain.gram_matmat_f64("laplace", X, X, V.double(), ls, 0.9)
    assert ((got.double() - want).abs().max() / want.abs().max()).item() <= 1e-6
    XT = kernel_cuda.tile_operand(X, ls)
    kernel_cuda.laplace_matvec_symmetric(X, V, ls, 0.9, XT)
    assert k5_entry.calls[-1]["ptr"] == XT.data_ptr()


def test_k5_rejects_a_wrong_operand(k5_entry):
    """K5 refuses, as K3's tile does, an operand that
    ``tile_operand`` would not give for its points: another set's
    shape, float64, a layout that is not contiguous; nothing launches."""
    X, V = _points(300, 28, 24), _points(300, 2, 25)
    XT = kernel_cuda.tile_operand(X, 32.0)
    wider = kernel_cuda.tile_operand(_points(300, 40, 26), 32.0)
    wrong = (kernel_cuda.tile_operand(X[:200], 32.0), wider, XT.double(), XT.T.contiguous().T)
    for op in wrong:
        with pytest.raises(ValueError, match="tile's operand"):
            kernel_cuda.laplace_matvec_symmetric(X, V, 32.0, 1.0, op)
    assert k5_entry.calls == []
