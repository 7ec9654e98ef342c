"""Routing and the host-side operands of K3 past 16 columns and of the exact
pair kernels K4 and K6, on the CPU.

The kernels run only on a card (``tests/test_torch_cuda.py``, marked
``cuda``). Here each wrapper runs down to its C entry, emulated on the host
with the arguments of its ctypes signature (the operands read through their
pointers), as ``tests/test_torch_k12_routes.py`` does for K1 and K2; or the
wrappers are replaced by recorders that compute with the plain versions and
``kernel_dispatch._on_card`` is forced true, so that each caller shows what
it hands the kernels. K3 past 16 columns takes K1's 3xTF32 entry
(``rl_gram_matmat_wide``) with Laplace's code; K4 and K6 take the register
tile's pair form (``rl_tile_pair``) on the tile's operands of both point
sets, the column tiles of X2 in ``tile_splits`` runs. The operands the
wrappers build are pure functions of their inputs and are held to the plain
versions bit for bit; the emulated products, in float64 from those
operands, to 1e-6 of max|ref| (V's TF32 parts carry V to 2^-22 of its
size; the pair's operands are V itself).
"""

import contextlib
import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

from rlaopt_tpu_torch.kernels import KernelConfig, ShardedKernelLinOp, linop
from rlaopt_tpu_torch.ops import kernel_cuda, kernel_dispatch, kernel_plain
from rlaopt_tpu_torch.parallel import make_mesh

KINDS = ("rbf", "matern12", "matern32", "matern52", "laplace")
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
    """The wide entry and the pair entry emulated on the host, with the
    arguments of their ctypes signatures."""

    def __init__(self):
        self.calls = []

    def rl_gram_matmat_wide(self, *args):
        assert len(args) == len(kernel_cuda._SIGNATURES["rl_gram_matmat_wide"])
        code, xt1, xt2, vp, out, n, m, npad, mpad, d, dpad, k, kp, nf, c, _s = args
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

    def rl_tile_pair(self, *args):
        """The pair as the kernel schedules it: outputs zeroed, then block
        (I, s) adds its row tile's forward sums over the column tiles of
        run s to out1 and each tile's mirror to out2; a column tile outside
        every run, or in two, shows in the sums."""
        assert len(args) == len(kernel_cuda._SIGNATURES["rl_tile_pair"])
        code, xt1, xt2, v2, v1, o1, o2, n1, n2, n1pad, n2pad, d, dpad, k, run, c, _s = args
        assert n1pad % 128 == 0 and n2pad % 128 == 0 and dpad % 32 == 0 and 1 <= k <= 16
        XT1, XT2 = _host(xt1, (dpad, n1pad)).copy(), _host(xt2, (dpad, n2pad)).copy()
        V2, V1 = _host(v2, (n2, k)).astype(np.float64), _host(v1, (n1, k)).astype(np.float64)
        K = _gram64(KIND_OF[code], XT1[:d, :n1].T, XT2[:d, :n2].T, np.eye(n2), 1.0)
        out1, out2 = np.zeros((n1, k)), np.zeros((n2, k))
        nt2 = -(-n2 // 128)
        for s in range(-(-nt2 // run)):
            cols = slice(s * run * 128, min((s + 1) * run * 128, n2))
            out1 += K[:, cols] @ V2[cols]
            out2[cols] += K[:, cols].T @ V1
        _host(o1, (n1, k))[:] = c * out1
        _host(o2, (n2, k))[:] = c * out2
        self.calls.append({"entry": "pair", "kind": KIND_OF[code], "XT1": XT1, "XT2": XT2,
                           "ptrs": (xt1, xt2), "V2": V2, "V1": V1, "n1": n1, "n2": n2,
                           "n1pad": n1pad, "n2pad": n2pad, "d": d, "dpad": dpad, "k": k,
                           "run": run})
        return 0


@pytest.fixture
def entries(monkeypatch):
    """The wrappers on CPU tensors down to the emulated entries, on a card
    of H100_SMS SMs."""
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
    return torch.linspace(0.5, 2.0, d) * d


@pytest.mark.parametrize("k", [17, 40, 64, 65, 130, 500])
@pytest.mark.parametrize("given", [False, True])
def test_k3_past_16_reaches_the_wide_entry(entries, k, given):
    """K3 past 16 columns: the shared wide entry with Laplace's code, on the
    tile's operands (built in the call, or given: their pointers passed on)
    bit for bit, K1's rule of output columns (kp the next multiple of 8,
    128 columns a block past kp = 64, else 64) and V as ``wide_rhs``'s
    TF32 parts, bit for bit against the plain split. The emulated product
    is the plain float64 one's; the wrapper counts the launch."""
    X1, X2, V = _points(130, 5, 1), _points(257, 5, 2), _points(257, k, 3)
    ls = _ard(5)
    XT1, XT2 = kernel_cuda.tile_operand(X1, ls), kernel_cuda.tile_operand(X2, ls)
    before = kernel_cuda.laplace_matmat.launches
    ops = (lambda: (XT1, XT2)) if given else None
    got = kernel_cuda.laplace_matmat(X1, X2, V, ls, 0.9, ops)
    assert kernel_cuda.laplace_matmat.launches == before + 1
    (call,) = entries.calls
    assert call["entry"] == "wide" and call["kind"] == "laplace"
    assert np.array_equal(call["XT1"], XT1.numpy()) and np.array_equal(call["XT2"], XT2.numpy())
    if given:
        assert call["ptrs"] == (XT1.data_ptr(), XT2.data_ptr())
    assert (call["n"], call["m"], call["d"], call["k"]) == (130, 257, 5, k)
    assert (call["npad"], call["mpad"], call["dpad"]) == (256, 384, 32)
    kp = -(-k // 8) * 8
    assert call["kp"] == kp and call["nf"] == (16 if kp > 64 else 8)
    hi, lo = kernel_plain.tf32_split(V)
    for first, part in ((0, hi), (2, lo)):
        rows = np.zeros((384, kp), np.float32)
        rows[0::2], rows[1::2] = call["VP"][..., first], call["VP"][..., first + 1]
        assert np.array_equal(rows[:257, :k].view(np.int32), part.numpy().view(np.int32))
        assert not rows[257:].any() and not rows[:, k:].any()
    ref = kernel_plain.gram_matmat_f64("laplace", X1, X2, V, ls.double(), 0.9)
    assert got.shape == (130, k) and _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("k", [1, 2, 3, 10, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_pair_reaches_the_tile_pair_entry(entries, kind, k):
    """K4 (K6 for Laplace): one entry for every family, with the family's
    code, both tile operands bit for bit (ragged n1 ≠ n2, an ARD ℓ), V2 and
    V1 as given, and the column tiles of X2 in ``tile_splits`` runs; the
    emulated schedule's outputs (zeroed, then every run's sums added) are
    the plain float64 pair's."""
    X1, X2 = _points(301, 6, 4), _points(1100, 6, 5)
    V2, V1 = _points(1100, k, 6), _points(301, k, 7)
    ls = _ard(6)
    if kind == "laplace":
        o1, o2 = kernel_cuda.laplace_pair(X1, X2, V2, V1, ls, 0.8)
    else:
        o1, o2 = kernel_cuda.gram_pair(kind, X1, X2, V2, V1, ls, 0.8)
    (call,) = entries.calls
    assert call["entry"] == "pair" and call["kind"] == kind
    assert np.array_equal(call["XT1"], kernel_cuda.tile_operand(X1, ls).numpy())
    assert np.array_equal(call["XT2"], kernel_cuda.tile_operand(X2, ls).numpy())
    assert (call["n1"], call["n2"], call["d"], call["k"]) == (301, 1100, 6, k)
    assert (call["n1pad"], call["n2pad"], call["dpad"]) == (384, 1152, 32)
    assert np.array_equal(call["V2"], V2.numpy()) and np.array_equal(call["V1"], V1.numpy())
    runs = kernel_cuda.tile_splits(301, 1100, k, H100_SMS)
    assert runs == 1 and call["run"] == 9  # 9 column tiles: no run of 8 besides
    r1, r2 = kernel_plain.gram_pair(kind, X1.double(), X2.double(), V2.double(), V1.double(),
                                    ls.double(), 0.8)
    assert o1.shape == (301, k) and o2.shape == (1100, k)
    assert _rel(o1, r1) <= 1e-6 and _rel(o2, r2) <= 1e-6


@pytest.mark.parametrize("n1,n2,k,runs,run", [
    (12_500, 12_500, 1, 10, 10),   # E2's shards: 98 x 98 tiles, 980 blocks
    (12_500, 12_500, 16, 10, 10),
    (33_334, 33_334, 1, 4, 66),    # E3's shards: 261 row tiles
    (100, 20_000, 3, 19, 9),       # one row tile: runs of 8 column tiles or more
    (300, 1_000, 2, 1, 8),         # 8 column tiles: one run
])
def test_pair_runs_rule(entries, n1, n2, k, runs, run):
    """The pair's runs of the X2 axis are the forward form's
    (``tile_splits``): ~10 at E2's shard size, filling the H100's 264 block
    slots in four rounds; the entry is handed the column tiles a run. The
    emulated schedule (every run's sums added) gives the plain product at
    the small shapes."""
    assert kernel_cuda.tile_splits(n1, n2, k, H100_SMS) == runs
    assert -(-(-(-n2 // 128)) // runs) == run
    if n1 * n2 > 3e6:
        return  # the emulated entry at the small shapes only
    X1, X2 = _points(n1, 3, 8), _points(n2, 3, 9)
    V2, V1 = _points(n2, k, 10), _points(n1, k, 11)
    o1, o2 = kernel_cuda.gram_pair("matern52", X1, X2, V2, V1, 1.7)
    assert entries.calls[-1]["run"] == run
    r1, r2 = kernel_plain.gram_pair("matern52", X1.double(), X2.double(), V2.double(),
                                    V1.double(), 1.7)
    assert _rel(o1, r1) <= 1e-6 and _rel(o2, r2) <= 1e-6


@pytest.mark.parametrize("kind", ["rbf", "laplace"])
def test_pair_hands_its_entry_the_given_operands(entries, kind):
    """Operands given to the pair (the half-ring's kept ones) reach the
    entry as they are (their pointers); an operand that ``tile_operand``
    would not give for its points is refused before any launch."""
    X1, X2 = _points(200, 28, 12), _points(300, 28, 13)
    V2, V1 = _points(300, 3, 14), _points(200, 3, 15)
    XT1, XT2 = kernel_cuda.tile_operand(X1, 5.0), kernel_cuda.tile_operand(X2, 5.0)

    def pair(*args):
        if kind == "laplace":
            return kernel_cuda.laplace_pair(*args)
        return kernel_cuda.gram_pair(kind, *args)

    pair(X1, X2, V2, V1, 5.0, 1.0, lambda: (XT1, XT2))
    assert entries.calls[-1]["ptrs"] == (XT1.data_ptr(), XT2.data_ptr())
    for wrong in ((XT2, XT1), (XT1, XT2.double()), (XT1, XT2.T.contiguous().T)):
        with pytest.raises(ValueError, match="tile's operand"):
            pair(X1, X2, V2, V1, 5.0, 1.0, lambda wrong=wrong: wrong)
    assert len(entries.calls) == 1


@pytest.mark.parametrize("kind", ["rbf", "matern32", "laplace"])
def test_pair_past_16_makes_two_general_calls_on_the_same_operands(entries, monkeypatch, kind):
    """``kernel_pair`` past 16 columns: two general calls (the wide entry),
    the first on the operands of (X1, X2), the second on the same two
    swapped; the outputs are the plain pair's. At k ≤ 16 one pair call on
    them."""
    monkeypatch.setattr(kernel_dispatch, "_on_card", lambda impl, t: True)
    X1, X2 = _points(200, 7, 16), _points(150, 7, 17)
    XT1, XT2 = kernel_cuda.tile_operand(X1, 3.0), kernel_cuda.tile_operand(X2, 3.0)
    V2, V1 = _points(150, 20, 18), _points(200, 20, 19)
    o1, o2 = kernel_dispatch.kernel_pair(kind, X1, X2, V2, V1, 3.0, 0.7,
                                         tile_operands=lambda: (XT1, XT2))
    assert [(c["entry"], c["kind"], c["ptrs"]) for c in entries.calls] == [
        ("wide", kind, (XT1.data_ptr(), XT2.data_ptr())),
        ("wide", kind, (XT2.data_ptr(), XT1.data_ptr())),
    ]
    r1, r2 = kernel_plain.gram_pair(kind, X1.double(), X2.double(), V2.double(), V1.double(),
                                    3.0, 0.7)
    assert _rel(o1, r1) <= 1e-6 and _rel(o2, r2) <= 1e-6
    kernel_dispatch.kernel_pair(kind, X1, X2, V2[:, :4], V1[:, :4], 3.0, 0.7,
                                tile_operands=lambda: (XT1, XT2))
    assert entries.calls[-1]["entry"] == "pair"
    assert entries.calls[-1]["ptrs"] == (XT1.data_ptr(), XT2.data_ptr())


@pytest.fixture
def ring(monkeypatch):
    """Every exact-tier product of the half-ring takes the card's route,
    through recorders that compute with the plain versions and note the
    operands each was handed; the operand builds of the operator counted."""
    rec = {"pairs": [], "general": [], "triangles": [], "built": []}

    def gram_pair(kind, X1, X2, V2, V1, ls, c=1.0, operands=None):
        rec["pairs"].append((X1, X2, operands()))
        return kernel_plain.gram_pair(kind, X1, X2, V2, V1, ls, c)

    def laplace_pair(X1, X2, V2, V1, ls, c=1.0, operands=None):
        return gram_pair("laplace", X1, X2, V2, V1, ls, c, operands)

    def general(kind, X1, X2, V, ls, c=1.0, operands=None):
        rec["general"].append((X1, X2, operands()))
        return kernel_plain.gram_matmat(kind, X1, X2, V, ls, c)

    def laplace_general(X1, X2, V, ls, c=1.0, operands=None):
        return general("laplace", X1, X2, V, ls, c, operands)

    def triangle(kind, X, V, ls, c=1.0, operand=None):
        rec["triangles"].append((X, operand))
        return kernel_plain.gram_matvec_symmetric(kind, X, V, ls, c)

    def laplace_triangle(X, V, ls, c=1.0, operand=None):
        return triangle("laplace", X, V, ls, c, operand)

    def counted(X, lengthscale):
        rec["built"].append(X)
        return kernel_cuda.tile_operand(X, lengthscale)

    monkeypatch.setattr(kernel_cuda, "gram_pair", gram_pair)
    monkeypatch.setattr(kernel_cuda, "laplace_pair", laplace_pair)
    monkeypatch.setattr(kernel_cuda, "gram_matmat", general)
    monkeypatch.setattr(kernel_cuda, "laplace_matmat", laplace_general)
    monkeypatch.setattr(kernel_cuda, "gram_matvec_symmetric", triangle)
    monkeypatch.setattr(kernel_cuda, "laplace_matvec_symmetric", laplace_triangle)
    monkeypatch.setattr(kernel_dispatch, "_on_card", lambda impl, t: True)
    monkeypatch.setattr(linop, "tile_operand", counted)
    return rec


@pytest.mark.parametrize("kind,P", [("rbf", 4), ("laplace", 3)])
def test_half_ring_hands_each_pair_both_shards_kept_operands(ring, kind, P):
    """E2's (4 positions, RBF) and E3's (3 positions, Laplace) half-ring:
    each pair call of shards (p, q) is handed the kept operand of shard p
    and that of shard q, the same tensors the diagonal blocks take; past 16
    columns (the Nyström sketch) each pair's two general calls take the
    same two, swapped for the second; each shard's operand is built once
    over the operator's applies. The products are the plain ones'."""
    n = 203
    X = _points(n, 5, 20)
    cfg = KernelConfig(lengthscale=2.5, const_scaling=1.1)
    K = ShardedKernelLinOp(X, X, cfg, kind, mesh=make_mesh(devices=["cpu"] * P),
                           memory_mode="ring")
    shards = [d["X1"].X for d in K._data]

    def which(Y):
        (p,) = [p for p, S in enumerate(shards) if Y is S]
        return p

    v, W = _points(n, 2, 21), _points(n, 20, 22)
    outs = [K @ v, K @ v, K @ W]
    assert len(ring["built"]) == P and all(any(b is S for S in shards) for b in ring["built"])
    kept = [d["tile"].get() for d in K._data]
    assert [which(X_) for X_, _ in ring["triangles"]] == list(range(P)) * 2
    assert all(op is kept[which(X_)] for X_, op in ring["triangles"])
    assert len(ring["pairs"]) == 2 * P * (P - 1) // 2
    seen = set()
    for X1, X2, (XT1, XT2) in ring["pairs"]:
        p, q = which(X1), which(X2)
        assert p != q and XT1 is kept[p] and XT2 is kept[q]
        seen.add(frozenset((p, q)))
    assert len(seen) == P * (P - 1) // 2
    # k = 20: the diagonal blocks and each pair's two general calls
    assert len(ring["general"]) == P + 2 * P * (P - 1) // 2
    for X1, X2, (XT1, XT2) in ring["general"]:
        assert XT1 is kept[which(X1)] and XT2 is kept[which(X2)]
    for out, V in zip(outs, (v, v, W)):
        want = kernel_plain.gram_matmat(kind, X, X, V, 2.5, 1.1)
        assert _rel(out, want) <= 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel,n,m,k,kind,ms", [
    # past 16 columns the contraction on the TF32 tensor cores, 6k operations
    # a value at 495 TFLOP/s, for K1 and K3 alike: 60.6 ms at 100k², k = 500
    ("laplace_matmat", 100_000, 100_000, 500, "laplace", 3 * 2 * 500 * 1e10 / 495e12 * 1e3),
    ("gram_matmat", 100_000, 100_000, 500, "rbf", 3 * 2 * 500 * 1e10 / 495e12 * 1e3),
    # E3's shard pair past 16 columns: one general call
    ("laplace_matmat", 33_334, 33_334, 500, "laplace", 3 * 2 * 500 * 33_334**2 / 495e12 * 1e3),
    # the pair: each of n1·n2 values once, its distance (3 or 2 operations a
    # feature) and 4k of contraction on the FP32 cores
    ("gram_pair", 12_500, 12_500, 1, "rbf", 12_500**2 * (3 * 28 + 4) / 67e12 * 1e3),
    ("laplace_pair", 33_334, 33_334, 10, "laplace", 33_334**2 * (2 * 28 + 40) / 67e12 * 1e3),
])
def test_bound_ms_of_the_wide_k3_and_the_pair(kernel, n, m, k, kind, ms):
    """``chip_smoke.bound_ms`` counts K3 past 16 columns as K1's 3xTF32
    kernel (the tensor cores bound it, not its L1 distance) and the pair's
    two contractions; both bound by operations at these shapes."""
    got, by = _chip_smoke().bound_ms(kernel, n, m, 28, k, kind)
    assert by == "operations" and got == pytest.approx(ms)


def test_ceiling_shares_skip_the_wide_k3():
    """K3 past 16 columns is not read against the L1 ceiling (its time goes
    to the contraction); K3's tile is."""
    smoke = _chip_smoke()
    rates = {"vpu_peak float32": 1e13, "vpu_peak float64": 5e12}
    pipes = {"float32": 1.6e13, "float64": 8e12}
    t = {kname: [smoke.timing_entry(kname, "a", 50.0, None, 100_000, 100_000, 28, k, "laplace")]
         for kname, k in (("laplace_matmat", 500), ("laplace_matmat_narrow", 1))}
    smoke.ceiling_shares(t, rates, pipes)
    assert "ceiling_ms" not in t["laplace_matmat"][0]
    assert "ceiling_ms" in t["laplace_matmat_narrow"][0]
