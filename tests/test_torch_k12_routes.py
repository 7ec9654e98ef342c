"""Routing and the host-side operands of K1 and K2, the exact tier's RBF and
Matérn kernels, on the CPU.

The kernels run only on a card (``tests/test_torch_cuda.py``, marked
``cuda``). Here each wrapper runs down to its C entry, emulated on the host
with the arguments of its ctypes signature (the operands read through their
pointers), as ``tests/test_torch_laplace_routes.py`` does for K5; or the
wrappers are replaced by recorders that compute with the plain versions and
``kernel_dispatch._on_card`` is forced true, so that each caller shows which
kernel it reaches. K2 takes the register tile's triangle form up to 16
columns; K1 its forward form up to 16 columns (in ``tile_splits`` runs of
the m axis) and the 3xTF32 tensor-core kernel past 16, on V's TF32 parts
(``wide_rhs``). The operands the wrappers build on the host are pure
functions of their inputs and are held to the plain versions bit for bit;
the emulated products, in float64 from those operands, to 1e-6 of max|ref|
(V's TF32 parts carry V to 2^-22 of its size).
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

import rlaopt_tpu_torch.kernels as tk
from rlaopt_tpu_torch.kernels import KernelConfig, KernelLinOp, RBFLinOp, linop
from rlaopt_tpu_torch.kernels.functions import scale_inputs
from rlaopt_tpu_torch.ops import kernel_cuda, kernel_dispatch, kernel_plain
from rlaopt_tpu_torch.parallel import make_mesh

SQDIST_KINDS = ("rbf", "matern12", "matern32", "matern52")
H100_SMS = 132
KIND_OF = {code: kind for kind, code in kernel_cuda.KIND_CODES.items()}


def _points(n, d, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _host(ptr, shape):
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)), shape=shape)


def _gram64(kind, P1, P2, V, c):
    """c·k(P1, P2) @ V in float64 from points already scaled."""
    t = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)) for a in (P1, P2, V)]
    return c * kernel_plain.gram_matmat_f64(kind, *t, 1.0).numpy()


class _Entries:
    """K1's and K2's C entries emulated on the host, with the arguments of
    their ctypes signatures."""

    def __init__(self):
        self.calls = []

    def _check(self, name, args):
        assert len(args) == len(kernel_cuda._SIGNATURES[name])

    def rl_gram_matmat_narrow(self, *args):
        self._check("rl_gram_matmat_narrow", args)
        code, xt1, xt2, v, out, part, n, m, npad, mpad, d, dpad, k, splits, c, _s = args
        XT1, XT2 = _host(xt1, (dpad, npad)).copy(), _host(xt2, (dpad, mpad)).copy()
        host_out = _host(out, (n, k))
        host_out[:] = _gram64(KIND_OF[code], XT1[:d, :n].T, XT2[:d, :m].T, _host(v, (m, k)), c)
        self.calls.append({"entry": "narrow", "kind": KIND_OF[code], "XT1": XT1, "XT2": XT2,
                           "ptrs": (xt1, xt2), "part": part, "n": n, "m": m, "npad": npad,
                           "mpad": mpad, "d": d, "dpad": dpad, "k": k, "splits": splits})
        return 0

    def rl_gram_matmat_wide(self, *args):
        self._check("rl_gram_matmat_wide", args)
        code, xt1, xt2, vp, out, n, m, npad, mpad, d, dpad, k, kp, nf, c, _s = args
        assert npad % 128 == 0 and mpad % 128 == 0 and kp % 8 == 0
        XT1, XT2 = _host(xt1, (dpad, npad)).copy(), _host(xt2, (dpad, mpad)).copy()
        VP = _host(vp, (mpad // 2, kp, 4)).copy()
        V = np.empty((mpad, kp), np.float64)  # hi + lo of each row of the pairs
        V[0::2] = VP[..., 0].astype(np.float64) + VP[..., 2]
        V[1::2] = VP[..., 1].astype(np.float64) + VP[..., 3]
        _host(out, (n, k))[:] = _gram64(KIND_OF[code], XT1[:d, :n].T, XT2[:d, :m].T,
                                         V[:m, :k], c)
        self.calls.append({"entry": "wide", "kind": KIND_OF[code], "XT1": XT1, "XT2": XT2,
                           "ptrs": (xt1, xt2), "VP": VP, "n": n, "m": m, "npad": npad,
                           "mpad": mpad, "d": d, "dpad": dpad, "k": k, "kp": kp, "nf": nf})
        return 0

    def rl_gram_matvec_symmetric(self, *args):
        self._check("rl_gram_matvec_symmetric", args)
        code, xt, v, out, n, npad, d, dpad, k, c, _s = args
        XT = _host(xt, (dpad, npad)).copy()
        P = XT[:d, :n].T
        _host(out, (n, k))[:] = _gram64(KIND_OF[code], P, P, _host(v, (n, k)), c)
        self.calls.append({"entry": "triangle", "kind": KIND_OF[code], "XT": XT, "ptr": xt,
                           "n": n, "npad": npad, "d": d, "dpad": dpad, "k": k})
        return 0


@pytest.fixture
def entries(monkeypatch):
    """K1's and K2's wrappers on CPU tensors down to the emulated entries,
    on a card of H100_SMS SMs."""
    entry = _Entries()

    def check_dtypes(dtypes, *tensors):
        assert all(t.dtype == dt for t, dt in zip(tensors, dtypes))

    monkeypatch.setattr(kernel_cuda, "_check_tensors", check_dtypes)
    monkeypatch.setattr(kernel_cuda, "build", lambda: None)
    monkeypatch.setattr(kernel_cuda, "_stream", lambda t: None)
    monkeypatch.setattr(kernel_cuda, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setitem(kernel_cuda._lib, "handle", entry)
    return entry


def _ard(d):
    return torch.linspace(0.5, 2.0, d) * d**0.5


@pytest.mark.parametrize("k", [1, 3, 16, 17, 40, 130])
@pytest.mark.parametrize("kind", SQDIST_KINDS)
def test_k1_routes_by_width_down_to_its_entry(entries, kind, k):
    """K1 up to 16 columns: the tile's forward entry, the points as
    ``tile_operand`` bit for bit; past 16 the wide entry, V as
    ``wide_rhs`` (kp the next multiple of 8, 128 columns a block past 64,
    else 64). The emulated product is the plain float64 one's."""
    X1, X2, V = _points(130, 5, 1), _points(257, 5, 2), _points(257, k, 3)
    ls = _ard(5)
    got = kernel_cuda.gram_matmat(kind, X1, X2, V, ls, 0.9)
    call = entries.calls[-1]
    assert call["entry"] == ("narrow" if k <= 16 else "wide") and call["kind"] == kind
    assert np.array_equal(call["XT1"], kernel_cuda.tile_operand(X1, ls).numpy())
    assert np.array_equal(call["XT2"], kernel_cuda.tile_operand(X2, ls).numpy())
    assert (call["n"], call["m"], call["d"], call["k"]) == (130, 257, 5, k)
    assert (call["npad"], call["mpad"], call["dpad"]) == (256, 384, 32)
    if k > 16:
        kp = -(-k // 8) * 8
        assert call["kp"] == kp and call["nf"] == (16 if kp > 64 else 8)
        want = kernel_cuda.wide_rhs(V, 384, kp).numpy()
        assert np.array_equal(call["VP"].view(np.int32), want.view(np.int32))
    ref = kernel_plain.gram_matmat_f64(kind, X1, X2, V, ls.double(), 0.9)
    assert got.shape == (130, k) and _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("k", [1, 2, 3, 10, 16])
@pytest.mark.parametrize("kind", SQDIST_KINDS)
def test_k2_hands_its_entry_the_tiles_operand(entries, kind, k):
    """K2's wrapper hands the triangle entry the tile's operand, built in
    the call or given (its pointer passed on); more than 16 columns raise
    before any launch."""
    X, V = _points(300, 28, 4), _points(300, k, 5)
    got = kernel_cuda.gram_matvec_symmetric(kind, X, V, 5.3, 1.1)
    call = entries.calls[-1]
    assert call["entry"] == "triangle" and call["kind"] == kind
    assert np.array_equal(call["XT"], kernel_cuda.tile_operand(X, 5.3).numpy())
    assert (call["n"], call["npad"], call["d"], call["dpad"], call["k"]) == (300, 384, 28, 32, k)
    XT = kernel_cuda.tile_operand(X, 5.3)
    kernel_cuda.gram_matvec_symmetric(kind, X, V, 5.3, 1.1, XT)
    assert entries.calls[-1]["ptr"] == XT.data_ptr()
    ref = kernel_plain.gram_matmat_f64(kind, X, X, V, 5.3, 1.1)
    assert _rel(got, ref) <= 1e-6
    with pytest.raises(ValueError, match="k <= 16"):
        kernel_cuda.gram_matvec_symmetric(kind, X, _points(300, 17, 6), 5.3)
    assert len(entries.calls) == 2


def test_k1_and_k2_refuse_a_wrong_operand(entries):
    """The tile refuses an operand that ``tile_operand`` would not give for
    its points (another set's shape, float64, not contiguous), in both
    forms and both widths; nothing launches."""
    X, V = _points(300, 28, 7), _points(300, 2, 8)
    XT = kernel_cuda.tile_operand(X, 5.0)
    wrong = (kernel_cuda.tile_operand(X[:100], 5.0), XT.double(), XT.T.contiguous().T)
    for op in wrong:
        with pytest.raises(ValueError, match="tile's operand"):
            kernel_cuda.gram_matvec_symmetric("rbf", X, V, 5.0, 1.0, op)
        for W in (V, _points(300, 20, 9)):
            with pytest.raises(ValueError, match="tile's operand"):
                kernel_cuda.gram_matmat("rbf", X, X, W, 5.0, 1.0, lambda op=op: (XT, op))
    assert entries.calls == []


@pytest.mark.parametrize("n,m,k,runs", [
    (10_000, 1_000_000, 1, 13),    # SAP's row oracle (config 4 as written, path A')
    (50_000, 50_000, 1, 2),        # config 5's n (E1): 391 row tiles, under two rounds
    (12_500, 12_500, 10, 10),      # E2's shard size: 98 row tiles, runs of 9 or 10
    (100_000, 100_000, 16, 1),
    (100, 20_000, 3, 19),          # one row tile: runs of 8 column tiles
    (100_000, 100_000, 500, 1),    # the wide kernel takes no runs
])
def test_k1_takes_tile_splits_runs(entries, n, m, k, runs):
    """K1's run count is ``tile_splits`` (K3's rule): one run once the
    128-row tiles fill two rounds of the H100's 264 block slots, else as
    many as keep the blocks within four rounds, each run 8 column tiles or
    more; the wrapper hands the entry that count and a partial buffer of
    (runs, n, k) floats when there is more than one."""
    assert kernel_cuda.tile_splits(n, m, k, H100_SMS) == runs
    if n * m > 3e6:
        return  # the emulated entry at the small shape only
    X1, X2, V = _points(n, 3, 10), _points(m, 3, 11), _points(m, k, 12)
    got = kernel_cuda.gram_matmat("rbf", X1, X2, V, 1.7)
    call = entries.calls[-1]
    assert call["splits"] == runs and (call["part"] is not None) == (runs > 1)
    assert _rel(got, kernel_plain.gram_matmat_f64("rbf", X1, X2, V, 1.7)) <= 1e-6


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30, 1e-40])
def test_tf32_split_holds_v_and_matches_the_wrappers_bits(scale):
    """The plain split (``kernel_plain.tf32_split``): ``hi`` has 11
    significant bits (13 low bits zero), ``hi + lo`` is V to 2^-22 of its
    size (subnormals: to TF32's quantum 2^-136), ``|lo| <= 2^-11 |hi|``
    where hi is normal;
    the wrapper's pieces (``wide_rhs``, bit operations) hold the same bits
    in the kernel's layout, zero past m and k."""
    V = _points(301, 19, 13).double().mul(scale).float()
    hi, lo = kernel_plain.tf32_split(V)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - V.double()).abs()
    assert (err <= torch.clamp(V.double().abs() * 2.0**-22, min=2.0**-137)).all()
    normal = hi.abs() >= 2.0**-126  # below, hi and lo are multiples of one quantum
    assert (lo.abs()[normal].double() <= hi.abs()[normal].double() * 2.0**-11).all()
    VP = kernel_cuda.wide_rhs(V, 384, 24)
    assert VP.shape == (192, 24, 4) and VP.is_contiguous()
    for first, want in ((0, hi), (2, lo)):
        got = torch.empty((384, 24))
        got[0::2], got[1::2] = VP[..., first], VP[..., first + 1]
        assert torch.equal(got[:301, :19].view(torch.int32), want.view(torch.int32))
        assert not got[301:].any() and not got[:, 19:].any()


@pytest.fixture
def recorded(monkeypatch):
    """Every exact-tier product takes the card's route, through recorders of
    K1 and K2 that compute with the plain versions and note the operands
    they were given: (wrapper, k) per call."""
    calls = []

    def k1(kind, X1, X2, V, lengthscale, const_scaling=1.0, operands=None):
        calls.append(("gram_matmat", 1 if V.ndim == 1 else V.shape[1]))
        if operands is not None:  # an operator's kept operands: the wrapper's own, bit for bit
            for XT, X in zip(operands(), (X1, X2)):
                assert torch.equal(XT, kernel_cuda.tile_operand(X, lengthscale))
        k1.operands.append(operands)
        return kernel_plain.gram_matmat(kind, X1, X2, V, lengthscale, const_scaling)

    def k2(kind, X, V, lengthscale, const_scaling=1.0, operand=None):
        calls.append(("gram_matvec_symmetric", 1 if V.ndim == 1 else V.shape[1]))
        if operand is not None:
            assert torch.equal(operand, kernel_cuda.tile_operand(X, lengthscale))
        k2.operands.append(operand)
        return kernel_plain.gram_matvec_symmetric(kind, X, V, lengthscale, const_scaling)

    k1.operands, k2.operands = [], []
    monkeypatch.setattr(kernel_cuda, "gram_matmat", k1)
    monkeypatch.setattr(kernel_cuda, "gram_matvec_symmetric", k2)
    monkeypatch.setattr(kernel_dispatch, "_on_card", lambda impl, t: True)
    return calls


@pytest.mark.parametrize("k,symmetric,route", [
    (1, True, "gram_matvec_symmetric"),
    (16, True, "gram_matvec_symmetric"),
    (17, True, "gram_matmat"),
    (1, False, "gram_matmat"),
    (500, False, "gram_matmat"),
])
@pytest.mark.parametrize("kind", SQDIST_KINDS)
def test_k1_k2_dispatch_rule(recorded, kind, k, symmetric, route):
    """``kernel_matmat``: one data set up to 16 columns takes K2, anything
    else K1 (its forward tile or its wide kernel by width); the values are
    the plain product's."""
    X, V = _points(50, 4, 14), _points(50, k, 15)
    got = kernel_dispatch.kernel_matmat(kind, X, X, V, 2.0, 0.7, symmetric=symmetric)
    assert recorded == [(route, k)]
    assert torch.equal(got, kernel_plain.gram_matmat(kind, X, X, V, 2.0, 0.7))


@pytest.mark.parametrize("kind", SQDIST_KINDS)
def test_operator_builds_its_operand_once(recorded, monkeypatch, kind):
    """A float32 exact-tier operator of any family keeps the tile's operand
    of its points: built the first time a kernel takes it (K2 at k = 1,
    then the wide K1 at k = 20 on the same tensor), never again; its row
    and block oracles share the parent's for the side they keep, each
    building one of its own rows; it equals the plain scaled points."""
    built = []

    def counted(X, lengthscale):
        built.append(X)
        return kernel_cuda.tile_operand(X, lengthscale)

    monkeypatch.setattr(linop, "tile_operand", counted)
    X = _points(200, 6, 16)
    K = KernelLinOp(X, X, KernelConfig(lengthscale=2.5), kind)
    K @ _points(200, 1, 17)
    K @ _points(200, 20, 18)
    assert len(built) == 1 and built[0] is X
    XT = K._tile_ops[0].get()
    assert torch.equal(XT[:6, :200], scale_inputs(X, K.lengthscale).T)
    assert recorded == [("gram_matvec_symmetric", 1), ("gram_matmat", 20)]
    assert kernel_cuda.gram_matvec_symmetric.operands[0] is XT
    assert all(op is XT for op in kernel_cuda.gram_matmat.operands[0]())
    blk = torch.arange(0, 200, 7)
    for _ in range(2):
        K.row_oracle(blk) @ _points(200, 1, 19)
    assert len(built) == 3
    assert kernel_cuda.gram_matmat.operands[-1]()[1] is XT
    K.blk_oracle(blk) @ _points(len(blk), 2, 20)
    assert len(built) == 5


def test_tier_and_float64_operators_keep_no_tile_operand():
    """The bf16 tiers keep their own parts, and float64 points take the
    float64 plain product: neither keeps the tile's operand."""
    X = _points(64, 3, 21)
    cfg = KernelConfig(lengthscale=1.5)
    assert RBFLinOp(X, X, cfg, compute_dtype="bf16x3")._tile_ops is None
    assert RBFLinOp(X.double(), X.double(), cfg)._tile_ops is None
    assert RBFLinOp(X, X, cfg)._tile_ops is not None


@pytest.mark.parametrize("kind", ["RBF", "Matern32"])
def test_half_ring_keeps_each_shards_operand(recorded, monkeypatch, kind):
    """E2's half-ring (one data set, ring mode, 3 positions): each
    position's diagonal block (K2) takes the operand of its own shard,
    built once per operator over two matvecs; the ring's product is the
    plain one's."""
    built = []

    def counted(X, lengthscale):
        built.append(X)
        return kernel_cuda.tile_operand(X, lengthscale)

    def pair(kind_, X1, X2, V2, V1, lengthscale, const_scaling=1.0, operands=None):
        return (kernel_plain.gram_matmat(kind_, X1, X2, V2, lengthscale, const_scaling),
                kernel_plain.gram_matmat(kind_, X2, X1, V1, lengthscale, const_scaling))

    monkeypatch.setattr(linop, "tile_operand", counted)
    monkeypatch.setattr(kernel_cuda, "gram_pair", pair)
    cfg = KernelConfig(lengthscale=2.5, const_scaling=1.1)
    X, v = _points(90, 3, 22), _points(90, 1, 23)[:, 0]
    K = getattr(tk, f"Sharded{kind}LinOp")(X, X, cfg, mesh=make_mesh(devices=["cpu"] * 3),
                                           memory_mode="ring")
    outs = [K @ v for _ in range(2)]
    given = kernel_cuda.gram_matvec_symmetric.operands
    assert len(built) == 3 and len(given) == 6
    assert all(g is b for g, b in zip(given, given[3:])) and all(g is not None for g in given)
    want = kernel_plain.gram_matmat(K.kind, X, X, v[:, None], 2.5, 1.1)[:, 0]
    for out in outs:
        assert torch.allclose(out, want, rtol=0, atol=1e-5 * want.abs().max().item())
