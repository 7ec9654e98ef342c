"""Routing and the host-side operands of the float64 tile's forward and pair
forms (the general K1c, K3c and K8, and the certified pairs), and the
sharded half-ring's certified routes, on the CPU.

The kernels run only on a card (``tests/test_torch_cuda.py``, marked
``cuda``). Here every entry of ``csrc/gram_comp.cu`` is emulated on the host
with the arguments of its ctypes signature (the operands read through their
pointers), as ``tests/test_torch_pair_routes.py`` does for K4 and K6: the
forward entries write each run of X2's tiles to its partial and add the runs
in order, the pair entries add every run's row and column sums, the
triangle entries compute the product of their operand's points; every value
in float64 from the operands' points, distances summed directly. The
operands the wrappers build (``comp_operand``) are held to the plain
version's float64 scaling bit for bit, and the emulated products to 1e-12
of max|ref| of the plain float64 version. Last, the port's sharded certified
routes against the JAX package's sharded operators on its 8-device CPU mesh,
on the same numpy points.
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.kernels import KernelConfig as JKernelConfig
from rlaopt_tpu.kernels import ShardedLaplaceLinOp as JShardedLaplaceLinOp
from rlaopt_tpu.kernels import ShardedRBFLinOp as JShardedRBFLinOp
from rlaopt_tpu.parallel import make_mesh as j_make_mesh
from rlaopt_tpu_torch.kernels import KernelConfig, ShardedKernelLinOp
from rlaopt_tpu_torch.kernels.functions import scale_inputs
from rlaopt_tpu_torch.ops import kernel_cuda, kernel_dispatch, kernel_plain
from rlaopt_tpu_torch.parallel import make_mesh

KINDS = ("rbf", "matern12", "matern32", "matern52", "laplace")
KIND_OF = {code: kind for kind, code in kernel_cuda.KIND_CODES.items()}
H100_SMS = 132
F64 = 1e-12
TILE = kernel_cuda.COMP_TILE


def _points(n, d, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _host(ptr, shape, ctype=ctypes.c_double):
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=shape)


def _values(kind, XT1, n1, XT2, n2, d):
    """k(P1, P2) in float64 from the operands' points (scaled, transposed),
    distances summed directly, feature by feature."""
    P1, P2 = XT1[:d, :n1], XT2[:d, :n2]
    acc = np.zeros((n1, n2))
    for f in range(d):
        diff = P1[f][:, None] - P2[f][None, :]
        acc += np.abs(diff) if kind == "laplace" else diff * diff
    if kind == "laplace":
        return np.exp(-acc)
    r = np.sqrt(acc)
    return {
        "rbf": lambda: np.exp(-0.5 * acc),
        "matern12": lambda: np.exp(-r),
        "matern32": lambda: (1 + 3**0.5 * r) * np.exp(-(3**0.5) * r),
        "matern52": lambda: (1 + 5**0.5 * r + 5 / 3 * acc) * np.exp(-(5**0.5) * r),
    }[kind]()


class _Entries:
    """The entries of ``csrc/gram_comp.cu`` emulated on the host, with the
    arguments of their ctypes signatures; ``calls`` keeps each call's
    entry, family, operands and sizes."""

    def __init__(self):
        self.calls = []

    def _check(self, name, args):
        assert len(args) == len(kernel_cuda._SIGNATURES[name])

    def _forward(self, name, vtype, args):
        self._check(name, args)
        if vtype == ctypes.c_float:
            code, xt1, xt2, v, part, out, lo, n, m, npad, mpad, dpad, k, run, c, _s = args
        else:
            code, xt1, xt2, v, part, out, n, m, npad, mpad, dpad, k, run, c, _s = args
            lo = None
        assert npad % TILE == 0 and mpad % TILE == 0 and dpad % kernel_cuda.COMP_FEAT == 0
        XT1, XT2 = _host(xt1, (dpad, npad)).copy(), _host(xt2, (dpad, mpad)).copy()
        V = _host(v, (m, k), vtype).astype(np.float64)
        K = _values(KIND_OF[code], XT1, n, XT2, m, dpad)
        runs = -(-(-(-m // TILE)) // run)
        parts = _host(part, (runs, n, k))
        for s in range(runs):
            cols = slice(s * run * TILE, min((s + 1) * run * TILE, m))
            parts[s] = K[:, cols] @ V[cols]
        total = np.zeros((n, k))
        for s in range(runs):
            total += parts[s]
        total *= c
        if lo is None:
            _host(out, (n, k))[:] = total
        else:
            hi = total.astype(np.float32)
            _host(out, (n, k), ctypes.c_float)[:] = hi
            _host(lo, (n, k), ctypes.c_float)[:] = (total - hi).astype(np.float32)
        self.calls.append({"entry": name, "kind": KIND_OF[code], "XT1": XT1, "XT2": XT2,
                           "n": n, "m": m, "k": k, "run": run, "runs": runs})
        return 0

    def rl_gram_matmat_comp(self, *args):
        return self._forward("rl_gram_matmat_comp", ctypes.c_float, args)

    def rl_gram_matmat_f64(self, *args):
        return self._forward("rl_gram_matmat_f64", ctypes.c_double, args)

    def _pair(self, name, vtype, args):
        """Every run's row sums of V2 and column sums of V1 added into the
        zeroed (n1 + n2, k) output, then scaled by c."""
        self._check(name, args)
        code, xt1, xt2, v2, v1, out, n1, n2, npad1, npad2, dpad, k, run, c, _s = args
        assert npad1 % TILE == 0 and npad2 % TILE == 0
        XT1, XT2 = _host(xt1, (dpad, npad1)).copy(), _host(xt2, (dpad, npad2)).copy()
        V2 = _host(v2, (n2, k), vtype).astype(np.float64)
        V1 = _host(v1, (n1, k), vtype).astype(np.float64)
        K = _values(KIND_OF[code], XT1, n1, XT2, n2, dpad)
        o = np.zeros((n1 + n2, k))
        for s in range(-(-(-(-n2 // TILE)) // run)):
            cols = slice(s * run * TILE, min((s + 1) * run * TILE, n2))
            o[:n1] += K[:, cols] @ V2[cols]
            o[n1:][cols] += K[:, cols].T @ V1
        _host(out, (n1 + n2, k))[:] = c * o
        self.calls.append({"entry": name, "kind": KIND_OF[code], "XT1": XT1, "XT2": XT2,
                           "n1": n1, "n2": n2, "k": k, "run": run})
        return 0

    def rl_gram_pair_comp(self, *args):
        return self._pair("rl_gram_pair_comp", ctypes.c_float, args)

    def rl_gram_pair_f64(self, *args):
        return self._pair("rl_gram_pair_f64", ctypes.c_double, args)

    def rl_gram_matvec_symmetric_comp(self, *args):
        self._check("rl_gram_matvec_symmetric_comp", args)
        code, xt, v, acc, out, lo, n, npad, dpad, k, c, _s = args
        XT = _host(xt, (dpad, npad)).copy()
        s = c * _values(KIND_OF[code], XT, n, XT, n, dpad) @ _host(
            v, (n, k), ctypes.c_float).astype(np.float64)
        hi = s.astype(np.float32)
        _host(out, (n, k), ctypes.c_float)[:] = hi
        _host(lo, (n, k), ctypes.c_float)[:] = (s - hi).astype(np.float32)
        self.calls.append({"entry": "rl_gram_matvec_symmetric_comp", "kind": KIND_OF[code],
                           "XT": XT, "n": n, "k": k})
        return 0

    def rl_gram_matvec_symmetric_f64(self, *args):
        self._check("rl_gram_matvec_symmetric_f64", args)
        code, xt, v, out, n, npad, dpad, k, c, _s = args
        XT = _host(xt, (dpad, npad)).copy()
        _host(out, (n, k))[:] = c * _values(KIND_OF[code], XT, n, XT, n, dpad) @ _host(v, (n, k))
        self.calls.append({"entry": "rl_gram_matvec_symmetric_f64", "kind": KIND_OF[code],
                           "XT": XT, "n": n, "k": k})
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


def _assert_operand(XT, X, ls):
    """``comp_operand``'s layout: the plain versions' float64 ``X / ℓ``,
    transposed, zero past n and d, whole tiles of 128 points and chunks of
    16 features, bit for bit."""
    n, d = X.shape
    assert XT.shape == (-(-d // 16) * 16, -(-n // TILE) * TILE)
    want = scale_inputs(X.double(), torch.as_tensor(ls, dtype=torch.float64)).T.numpy()
    assert np.array_equal(XT[:d, :n], want)
    assert not XT[d:].any() and not XT[:, n:].any()


def _ls(ard, d):
    return torch.linspace(0.6, 1.8, d, dtype=torch.float64) * d**0.5 if ard else 1.3 * d**0.5


SHAPES = [(100, 257, 3), (301, 1100, 28)]  # ragged; n1 below one tile, then above


@pytest.mark.parametrize("vtype", ["comp", "f64"])
@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("n,m,d", SHAPES)
@pytest.mark.parametrize("k", [1, 3, 10, 17])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_reaches_its_entry(entries, kind, k, n, m, d, ard, vtype):
    """The general K1c (K3c for Laplace; ``comp``) and K8 (``f64``): the
    forward entry of the float64 tile with the family's code, both points'
    operands bit for bit, X2's tiles in ``comp_run`` runs; the emulated
    product (hi + lo for K1c and K3c) within 1e-12 of the plain float64
    one, and the wrapper counts its launch."""
    X1, X2 = _points(n, d, 1), _points(m, d, 2)
    V = _points(m, k, 3)
    ls = _ls(ard, d)
    if vtype == "f64":
        V = V.double()
        wrapper = kernel_cuda.gram_matmat_f64
        before = wrapper.launches
        got = wrapper(kind, X1, X2, V, ls, 0.8)
        assert got.dtype == torch.float64
    else:
        wrapper = kernel_cuda.laplace_matmat_comp if kind == "laplace" else kernel_cuda.gram_matmat_comp
        before = wrapper.launches
        args = (X1, X2, V, ls, 0.8)
        hi, lo = wrapper(*args) if kind == "laplace" else wrapper(kind, *args)
        assert hi.dtype == lo.dtype == torch.float32
        got = hi.double() + lo.double()
    assert wrapper.launches == before + 1
    (call,) = entries.calls
    entry = "rl_gram_matmat_f64" if vtype == "f64" else "rl_gram_matmat_comp"
    assert call["entry"] == entry and call["kind"] == kind
    assert (call["n"], call["m"], call["k"]) == (n, m, k)
    _assert_operand(call["XT1"], X1, ls)
    _assert_operand(call["XT2"], X2, ls)
    tiles = -(-m // TILE)
    assert call["run"] == kernel_cuda.comp_run(-(-n // TILE) * -(-k // 16), tiles, H100_SMS)
    ref = kernel_plain.gram_matmat_f64(kind, X1, X2, V, ls, 0.8)
    assert got.shape == (n, k) and _rel(got, ref) <= F64


@pytest.mark.parametrize("vtype", ["comp", "f64"])
@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("n1,n2,d", SHAPES)
@pytest.mark.parametrize("k", [1, 3, 10, 17])
@pytest.mark.parametrize("kind", KINDS)
def test_pair_reaches_its_entry(entries, kind, k, n1, n2, d, ard, vtype):
    """The certified pairs (``gram_pair_comp`` with float32 V, ``gram_pair_f64``
    with float64 V), every family, any k: the pair entry with the family's
    code, both operands bit for bit, V2 and V1 as given; both float64
    outputs (views of one array) within 1e-12 of the plain pair's."""
    X1, X2 = _points(n1, d, 4), _points(n2, d, 5)
    V2, V1 = _points(n2, k, 6), _points(n1, k, 7)
    ls = _ls(ard, d)
    if vtype == "f64":
        V2, V1 = V2.double(), V1.double()
    wrapper = kernel_cuda.gram_pair_f64 if vtype == "f64" else kernel_cuda.gram_pair_comp
    before = wrapper.launches
    o1, o2 = wrapper(kind, X1, X2, V2, V1, ls, 0.8)
    assert wrapper.launches == before + 1
    (call,) = entries.calls
    assert call["entry"] == f"rl_gram_pair_{vtype}" and call["kind"] == kind
    assert (call["n1"], call["n2"], call["k"]) == (n1, n2, k)
    _assert_operand(call["XT1"], X1, ls)
    _assert_operand(call["XT2"], X2, ls)
    slices = 1 if k <= 2 else -(-k // 4)
    assert call["run"] == kernel_cuda.comp_run(-(-n1 // TILE) * slices, -(-n2 // TILE), H100_SMS)
    r1, r2 = kernel_plain.gram_pair_f64(kind, X1, X2, V2, V1, ls, 0.8)
    assert o1.dtype == o2.dtype == torch.float64
    assert o1.shape == (n1, k) and o2.shape == (n2, k)
    assert _rel(o1, r1) <= F64 and _rel(o2, r2) <= F64


@pytest.mark.parametrize("n,m,k,blocks,runs,run", [
    (100_000, 100_000, 1, 782, 1, 782),      # 782 row tiles fill the card
    (100_000, 100_000, 10, 782, 1, 782),
    (100_000, 100_000, 17, 1564, 1, 782),   # past 16 columns: two slices
    (50_000, 50_000, 1, 391, 1, 391),        # E1's slab
    (12_500, 12_500, 1, 98, 5, 20),          # E2's shard: 98 row tiles
    (33_334, 33_334, 1, 261, 2, 131),        # E3's shard
    (8_192, 1_000_000, 1, 64, 8, 977),       # config 6's certificate
    (100, 5_000, 3, 1, 5, 8),                # one row tile: runs of 8 tiles
])
def test_forward_runs_rule(entries, n, m, k, blocks, runs, run):
    """The forward form's runs of X2's tiles on an H100: one run once the
    row tiles (times the 16-column slices) fill two rounds of the 132 SMs;
    else as many as keep the blocks within four rounds, each of 8 tiles or
    more. At the small shape the emulated runs' partials, added in order,
    give the plain product."""
    tiles = -(-m // TILE)
    assert -(-n // TILE) * -(-k // 16) == blocks
    assert kernel_cuda.comp_run(blocks, tiles, H100_SMS) == run
    assert -(-tiles // run) == runs
    if n * m > 1e6:
        return
    X1, X2, V = _points(n, 3, 8), _points(m, 3, 9), _points(m, k, 10).double()
    got = kernel_cuda.gram_matmat_f64("matern32", X1, X2, V, 1.1)
    assert entries.calls[-1]["runs"] == runs
    assert _rel(got, kernel_plain.gram_matmat_f64("matern32", X1, X2, V, 1.1)) <= F64


@pytest.mark.parametrize("n,k,runs", [
    (12_500, 1, 5),    # E2's shard pair: 98 row tiles, one slice
    (12_500, 3, 5),    # one slice of 4 columns
    (12_500, 10, 1),   # three slices: 294 blocks fill two rounds
    (33_334, 1, 2),    # E3's shard pair: 261 row tiles
])
def test_pair_runs_rule(n, k, runs):
    """The pair's runs of X2's tiles: the forward form's rule over its row
    tiles times its slices (1 or 2 right-hand sides a slice up to k = 2,
    then 4)."""
    tiles = -(-n // TILE)
    slices = 1 if k <= 2 else -(-k // 4)
    run = kernel_cuda.comp_run(tiles * slices, tiles, H100_SMS)
    assert -(-tiles // run) == runs


def test_dispatch_rule(entries, monkeypatch):
    """On a card (``_on_card`` true) the general compensated and float64
    products take the forward entries and the certified pairs the pair
    entries, Laplace included; on the CPU the plain versions, with the
    same values to 1e-12."""
    X1, X2 = _points(90, 4, 11), _points(70, 4, 12)
    V2, V1 = _points(70, 2, 13), _points(90, 2, 14)
    host = [
        kernel_dispatch.kernel_pair_compensated("laplace", X1, X2, V2, V1, 1.2, 0.9),
        kernel_dispatch.kernel_pair_f64("rbf", X1, X2, V2, V1, 1.2, 0.9),
        kernel_dispatch.kernel_matmat_compensated("matern52", X1, X2, V2, 1.2, 0.9),
        kernel_dispatch.kernel_matmat_f64("laplace", X1, X2, V2, 1.2, 0.9),
    ]
    assert entries.calls == []
    monkeypatch.setattr(kernel_dispatch, "_on_card", lambda impl, t: True)
    card = [
        kernel_dispatch.kernel_pair_compensated("laplace", X1, X2, V2, V1, 1.2, 0.9),
        kernel_dispatch.kernel_pair_f64("rbf", X1, X2, V2, V1, 1.2, 0.9),
        kernel_dispatch.kernel_matmat_compensated("matern52", X1, X2, V2, 1.2, 0.9),
        kernel_dispatch.kernel_matmat_f64("laplace", X1, X2, V2, 1.2, 0.9),
    ]
    assert [(c["entry"], c["kind"]) for c in entries.calls] == [
        ("rl_gram_pair_comp", "laplace"), ("rl_gram_pair_f64", "rbf"),
        ("rl_gram_matmat_comp", "matern52"), ("rl_gram_matmat_f64", "laplace")]
    for (h1, h2), (c1, c2) in zip(host[:2], card[:2]):
        assert _rel(c1, h1) <= F64 and _rel(c2, h2) <= F64
    hi, lo = card[2]
    assert _rel(hi.double() + lo.double(), host[2][0].double() + host[2][1].double()) <= F64
    assert _rel(card[3], host[3]) <= F64


@pytest.mark.parametrize("kind,P", [("rbf", 4), ("laplace", 3), ("matern32", 4)])
def test_sharded_certified_routes_take_the_half_ring(entries, monkeypatch, kind, P):
    """One data set in ring mode (E2: RBF on 4 positions, E3: Laplace on 3):
    ``matmat_compensated`` makes P compensated-triangle and P(P − 1)/2
    compensated-pair calls, ``matmat_f64`` (and ``matmat_value64``) P K7
    and P(P − 1)/2 float64-pair calls, no general call; each triangle on
    its shard's operand, each pair on two distinct shards'. Both equal the
    plain float64 product (hi + lo to 1e-12). Two data sets in ring mode
    and the replicated mode keep the general forward form."""
    monkeypatch.setattr(kernel_dispatch, "_on_card", lambda impl, t: True)
    n = 203  # shards of 51 (or 68), padded
    X = _points(n, 5, 20)
    W = _points(n, 2, 21)
    cfg = KernelConfig(lengthscale=2.5, const_scaling=1.1)
    K = ShardedKernelLinOp(X, X, cfg, kind, mesh=make_mesh(devices=["cpu"] * P),
                           memory_mode="ring")
    ref = kernel_plain.gram_matmat_f64(kind, X, X, W.double(), 2.5, 1.1)
    pairs = P * (P - 1) // 2
    hi, lo = K.matmat_compensated(W)
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == (n, 2)
    assert [c["entry"] for c in entries.calls] == (
        ["rl_gram_matvec_symmetric_comp"] * P + ["rl_gram_pair_comp"] * pairs)
    assert _rel(hi.double() + lo.double(), ref) <= F64
    loc = K._data[0]["X1"].X.shape[0]
    shards = [d["X1"].X for d in K._data]
    for p, call in enumerate(entries.calls[:P]):
        _assert_operand(call["XT"], shards[p], 2.5)
    seen = set()
    for call in entries.calls[P:]:
        assert call["n1"] == call["n2"] == loc
        (p,) = [p for p, S in enumerate(shards)
                if np.array_equal(call["XT1"], kernel_cuda.comp_operand(S, 2.5).numpy())]
        (q,) = [q for q, S in enumerate(shards)
                if np.array_equal(call["XT2"], kernel_cuda.comp_operand(S, 2.5).numpy())]
        assert p != q
        seen.add(frozenset((p, q)))
    assert len(seen) == pairs
    del entries.calls[:]
    got = K.matmat_f64(W[:, 0])
    vh, vl = K.matmat_value64(W)
    assert [c["entry"] for c in entries.calls] == 2 * (
        ["rl_gram_matvec_symmetric_f64"] * P + ["rl_gram_pair_f64"] * pairs)
    assert got.dtype == torch.float64 and got.shape == (n,)
    assert _rel(got, ref[:, 0]) <= F64 and _rel(vh.double() + vl.double(), ref) <= F64
    del entries.calls[:]
    mesh = make_mesh(devices=["cpu"] * P)
    ShardedKernelLinOp(X, X.clone(), cfg, kind, mesh=mesh, memory_mode="ring").matmat_compensated(W)
    ShardedKernelLinOp(X, X, cfg, kind, mesh=mesh).matmat_compensated(W)
    assert [c["entry"] for c in entries.calls] == ["rl_gram_matmat_comp"] * (P * P + P)


def _jax_sharded(kind, X, ls):
    cls = JShardedLaplaceLinOp if kind == "laplace" else JShardedRBFLinOp
    Xj = jnp.asarray(X)
    return cls(Xj, Xj, JKernelConfig(lengthscale=ls, const_scaling=1.1), mesh=j_make_mesh(),
               memory_mode="ring")


# The JAX package's compensated contract off the TPU: its ring visits the
# float32 plain product (``lo`` zero), float32 values of points scaled in
# float32, 2.3–4.6e-7 of max|ref| from the float64 product at d = 28
# (ROADMAP Queue 3's standing difference; 1.0–1.6e-7 on these points),
# where the port's half-ring is float64 to the last bits of (hi, lo).
JAX_F32_GAP = 5e-7


@pytest.mark.parametrize("P", [4, 3])
@pytest.mark.parametrize("kind", ["rbf", "laplace"])
def test_sharded_certified_routes_match_jax(kind, P):
    """The port's sharded half-ring (P CPU positions, the plain versions)
    against the JAX package's sharded operator (ring mode on its 8 CPU
    devices) on the same float32 points: ``matmat_compensated`` within the
    JAX float32 contract's gap, ``matmat_value64`` within 1e-12 (the JAX
    value64 engine in interpret mode), both also against float64."""
    n, d = 150, 6
    X = np.random.default_rng(30 + P).standard_normal((n, d)).astype(np.float32)
    V = np.random.default_rng(31).standard_normal((n, 2)).astype(np.float32)
    ls = 3.0  # a float32 one: the JAX operator keeps it in the points' type
    Xt = torch.from_numpy(X)
    K = ShardedKernelLinOp(Xt, Xt, KernelConfig(lengthscale=ls, const_scaling=1.1), kind,
                           mesh=make_mesh(devices=["cpu"] * P), memory_mode="ring")
    J = _jax_sharded(kind, X, ls)
    ref = kernel_plain.gram_matmat_f64(kind, Xt, Xt, torch.from_numpy(V).double(), ls, 1.1)
    hi, lo = K.matmat_compensated(torch.from_numpy(V))
    jhi, jlo = J.matmat_compensated(jnp.asarray(V))
    port = hi.double() + lo.double()
    jax_c = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    assert _rel(port, ref) <= F64
    assert _rel(port, jax_c) <= JAX_F32_GAP
    vh, vl = K.matmat_value64(torch.from_numpy(V))
    jvh, jvl = J.matmat_value64(V)
    port64 = vh.double() + vl.double()
    jax64 = np.asarray(jvh, np.float64) + np.asarray(jvl, np.float64)
    assert _rel(port64, jax64) <= F64 and _rel(port64, ref) <= F64
