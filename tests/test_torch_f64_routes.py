"""Routing and the host-side operand of K7, the float64 sweep, on the CPU.

K7 runs only on a card (``tests/test_torch_cuda.py``, marked ``cuda``). Here
``kernel_dispatch._on_card`` is forced true, so each float64 sweep shows
which kernel it reaches: the other wrappers on the way (K1, K2, K1c, K8)
are replaced by recorders that compute with their plain versions, and K7's
own wrapper runs as written down to its C entry point
(``rl_gram_matvec_symmetric_f64``), which is emulated on the host: it reads
the operands through the pointers the wrapper passes, as the kernel does, and
writes ``c·k(P, P) @ V`` in float64 from the operand's points P. So the
tests hold the operand that K7 is handed (``X.double() / ℓ``, transposed
and padded: ``kernel_cuda.symmetric_comp_operand``) to the plain version's
scaling bit for bit, and the port's float64 route to a numpy float64
product and to the JAX package's value64 engine in interpret mode on the
same inputs, each within 1e-12 of max|ref|.
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.ops.kernel_value64 import kernel_matmat_value64 as jax_value64
from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp, ShardedRBFLinOp
from rlaopt_tpu_torch.kernels.sharded import ShardedKernelLinOp
from rlaopt_tpu_torch.models import LinSys
from rlaopt_tpu_torch.ops import kernel_cuda, kernel_dispatch, kernel_plain
from rlaopt_tpu_torch.parallel import make_mesh
from rlaopt_tpu_torch.preconditioners import NystromConfig
from rlaopt_tpu_torch.solvers import PCGConfig

KINDS = ("rbf", "laplace", "matern12", "matern32", "matern52")
CODES = {code: kind for kind, code in kernel_cuda.KIND_CODES.items()}
ARD = np.array([0.7, 1.1, 1.9, 2.5, 0.9])
F64 = 1e-12


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _points(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _numpy_kernel(kind, P, Q):
    """k(P, Q) in float64 from scaled points, distances summed directly."""
    diff = P[:, None, :] - Q[None, :, :]
    if kind == "laplace":
        return np.exp(-np.abs(diff).sum(-1))
    d2 = (diff**2).sum(-1)
    r = np.sqrt(d2)
    return {
        "rbf": lambda: np.exp(-0.5 * d2),
        "matern12": lambda: np.exp(-r),
        "matern32": lambda: (1 + 3**0.5 * r) * np.exp(-(3**0.5) * r),
        "matern52": lambda: (1 + 5**0.5 * r + 5 / 3 * d2) * np.exp(-(5**0.5) * r),
    }[kind]()


def _host_array(ptr, shape):
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_double)), shape=shape)


class _K7Entry:
    """``rl_gram_matvec_symmetric_f64`` emulated on the host, with the
    arguments of its ctypes signature: (kind, XT, V, out, n, npad, dpad, k,
    c, stream). ``calls`` keeps each call's family, operand and sizes."""

    def __init__(self):
        self.calls = []

    def rl_gram_matvec_symmetric_f64(self, *args):
        assert len(args) == len(kernel_cuda._SIGNATURES["rl_gram_matvec_symmetric_f64"])
        code, xt, v, out, n, npad, dpad, k, c, _stream = args
        assert all(isinstance(i, int) for i in (code, xt, v, out, n, npad, dpad, k))
        assert isinstance(c, float)
        assert npad % kernel_cuda.COMP_TILE == 0 and dpad % kernel_cuda.COMP_FEAT == 0
        XT = _host_array(xt, (dpad, npad)).copy()
        P = XT[:, :n].T
        _host_array(out, (n, k))[:] = c * _numpy_kernel(CODES[code], P, P) @ _host_array(v, (n, k))
        self.calls.append({"kind": CODES[code], "XT": XT, "n": n, "k": k})
        return 0


@pytest.fixture
def card(monkeypatch):
    """The card's routes on CPU tensors: recorders for K1, K2, K1c, K8 and
    K8's pair form (wrapper names in ``calls``), K7's wrapper down to the
    emulated entry
    (``"gram_matvec_symmetric_f64"`` in ``calls``, the operands in
    ``entry.calls``)."""
    calls, entry = [], _K7Entry()

    def recorder(name, plain):
        def rec(*args, **kwargs):
            calls.append(name)
            return plain(*args, **kwargs)
        rec.launches = 0  # K7's wrapper counts on the name it is bound to
        return rec

    def triangle_comp(kind, X, V, lengthscale, const_scaling=1.0):
        return kernel_plain.gram_matmat_comp(kind, X, X, V, lengthscale, const_scaling)

    # K1 and K2 take the register tile's operands besides (an operator keeps them)
    def k1(kind, X1, X2, V, lengthscale, const_scaling=1.0, XT1=None, XT2=None):
        return kernel_plain.gram_matmat(kind, X1, X2, V, lengthscale, const_scaling)

    def k2(kind, X, V, lengthscale, const_scaling=1.0, XT=None):
        return kernel_plain.gram_matvec_symmetric(kind, X, V, lengthscale, const_scaling)

    for name, plain in (("gram_matmat", k1),
                        ("gram_matvec_symmetric", k2),
                        ("gram_matmat_comp", kernel_plain.gram_matmat_comp),
                        ("gram_matvec_symmetric_comp", triangle_comp),
                        ("gram_matmat_f64", kernel_plain.gram_matmat_f64),
                        ("gram_pair_f64", kernel_plain.gram_pair_f64)):
        monkeypatch.setattr(kernel_cuda, name, recorder(name, plain))
    real_k7 = kernel_cuda.gram_matvec_symmetric_f64
    monkeypatch.setattr(kernel_cuda, "gram_matvec_symmetric_f64",
                        recorder("gram_matvec_symmetric_f64", real_k7))

    def check_dtypes(dtypes, *tensors):
        assert all(t.dtype == dt for t, dt in zip(tensors, dtypes))

    monkeypatch.setattr(kernel_cuda, "_check_tensors", check_dtypes)
    monkeypatch.setattr(kernel_cuda, "build", lambda: None)
    monkeypatch.setattr(kernel_cuda, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setitem(kernel_cuda._lib, "handle", entry)
    monkeypatch.setattr(kernel_dispatch, "_on_card", lambda impl, t: True)
    return calls, entry


def _assert_operand(call, X, ls):
    """K7's operand: ``X.double() / ℓ`` transposed, zero past d and n, bit
    for bit."""
    n, d = X.shape
    XT = call["XT"]
    assert XT.shape == (-(-d // kernel_cuda.COMP_FEAT) * kernel_cuda.COMP_FEAT,
                        -(-n // kernel_cuda.COMP_TILE) * kernel_cuda.COMP_TILE)
    want = (X.double() / torch.as_tensor(ls, dtype=torch.float64)).T.numpy()
    assert np.array_equal(XT[:d, :n], want)
    assert not XT[d:].any() and not XT[:, n:].any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ard", [False, True])
def test_k7_operand_and_value(card, kind, ard):
    """K7's wrapper hands its entry the plain version's scaled points
    (scalar and ARD ℓ, ragged n and d), and the product on that operand is
    the plain K7's. V is float32-representable, so the route, the plain K7
    and the JAX package's value64 engine all take the same inputs: the route
    and the plain K7 are within 1e-12 of the numpy float64 product and of
    the JAX engine (3e-15 measured)."""
    calls, entry = card
    n, d, k, c = 300, 5, 3, 0.83
    X = _points(n, d, 4)
    V = np.random.default_rng(5).standard_normal((n, k)).astype(np.float32).astype(np.float64)
    ls = ARD if ard else 1.6
    Xt, Vt = torch.from_numpy(X), torch.from_numpy(V)
    lst = torch.as_tensor(ls, dtype=torch.float64)
    got = kernel_cuda.gram_matvec_symmetric_f64(kind, Xt, Vt, lst, c)
    assert calls == ["gram_matvec_symmetric_f64"] and len(entry.calls) == 1
    assert entry.calls[0]["kind"] == kind and got.dtype == torch.float64
    _assert_operand(entry.calls[0], Xt, lst)
    plain = kernel_plain.gram_matvec_symmetric_f64(kind, Xt, Vt, lst, c)
    Xs = X.astype(np.float64) / ls
    assert _rel(got, plain) <= F64
    assert _rel(plain, c * _numpy_kernel(kind, Xs, Xs) @ V) <= F64
    Xj = jnp.asarray(X)
    jhi, jlo = jax_value64(Xj, Xj, V.astype(np.float32), ls, c, kind=kind, interpret=True)
    jax_out = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    assert _rel(got, jax_out) <= F64 and _rel(plain, jax_out) <= F64


def test_float64_dispatch_rule(card):
    """``kernel_matmat_f64`` on the card's route: ``symmetric`` with equal
    row counts takes K7 in every family, anything else K8; 1-D operands
    come back 1-D."""
    calls, entry = card
    X = torch.from_numpy(_points(40, 2, 6))
    V = torch.linspace(-1.0, 1.0, 40, dtype=torch.float64)
    for kind in KINDS:
        kernel_dispatch.kernel_matmat_f64(kind, X, X, V, 1.0, symmetric=True)
    out = kernel_dispatch.kernel_matmat_f64("rbf", X, X, V, 1.0)
    kernel_dispatch.kernel_matmat_f64("rbf", X, X[:30], V[:30], 1.0, symmetric=True)
    assert calls == ["gram_matvec_symmetric_f64"] * 5 + ["gram_matmat_f64"] * 2
    assert [c["kind"] for c in entry.calls] == list(KINDS)
    assert out.shape == (40,)


N, D, RANK = 512, 8, 32
REG = 1e-4 * N


@pytest.mark.parametrize("residual", ["evaluate", "update"])
def test_refinement_sweeps_reach_k7(card, residual):
    """``LinSys`` refinement on a one-data-set operator (n = 512), in
    evaluate and update mode: every float64 sweep takes K7 with the
    triangle's operand, none K8, and the delivered W64 is the plain
    route's (the CPU's) to float64 round-off."""
    calls, entry = card
    rng = np.random.default_rng(0)
    X = torch.from_numpy(_points(N, D, 1))
    y = torch.from_numpy(np.tanh(X.numpy() @ rng.standard_normal(D)).astype(np.float32))
    ls = D**0.5
    cfg = PCGConfig(max_iters=60, rtol=1e-8, precond_config=NystromConfig(rank=RANK, rho=REG))

    def solve():
        K = RBFLinOp(X, X, KernelConfig(lengthscale=ls))
        return LinSys(K, y, REG).solve(
            cfg, torch.zeros((N, 1)), callback_freq=10, key=0, f64_refine_rounds=2,
            f64_refine_device="accel", f64_refine_residual=residual,
        )

    W64, log = solve()
    assert "gram_matvec_symmetric_f64" in calls and "gram_matmat_f64" not in calls
    assert len(entry.calls) == calls.count("gram_matvec_symmetric_f64")
    for call in entry.calls:
        _assert_operand(call, X, ls)
    if residual == "update":
        assert "gram_matvec_symmetric_comp" in calls
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernel_dispatch, "_on_card", lambda impl, t: False)
        W_cpu, log_cpu = solve()
    assert log["f64_refine"]["residual_sources"] == log_cpu["f64_refine"]["residual_sources"]
    assert _rel(W64, W_cpu) <= 1e-9


def test_sharded_sweep_reaches_k7_on_own_shards(card):
    """The sharded operator's float64 sweep (``matmat_f64``) on 4 positions:
    K7 where a position meets its own shard of one data set (4 launches,
    each with its shard's operand), and on the other shard pairs K8's pair
    form once each on the half-ring (6 launches, ring mode) or K8 on all 12
    (the replicated mode's sweep); two data sets take K8 alone. All equal
    the plain float64 product."""
    calls, entry = card
    X = torch.from_numpy(_points(203, 3, 7))  # ragged: shards of 51, padded
    V = torch.from_numpy(np.random.default_rng(8).standard_normal((203, 2)))
    cfg = KernelConfig(lengthscale=1.4, const_scaling=0.9)
    ref = kernel_plain.gram_matmat_f64("matern32", X, X, V, 1.4, 0.9)
    for mode in ("ring", "replicated"):
        del calls[:], entry.calls[:]
        K = ShardedKernelLinOp(X, X, cfg, "matern32", mesh=make_mesh(devices=["cpu"] * 4),
                               memory_mode=mode)
        got = K.matmat_f64(V)
        assert calls.count("gram_matvec_symmetric_f64") == 4
        if mode == "ring":
            assert calls.count("gram_pair_f64") == 6 and "gram_matmat_f64" not in calls
        else:
            assert calls.count("gram_matmat_f64") == 12 and "gram_pair_f64" not in calls
        Xp = torch.cat([X, X.new_zeros((1, 3))])
        for p, call in enumerate(entry.calls):
            _assert_operand(call, Xp[51 * p: 51 * (p + 1)], torch.tensor(1.4, dtype=torch.float64))
        assert _rel(got, ref) <= F64
    del calls[:]
    K2 = ShardedRBFLinOp(X, X.clone(), cfg, mesh=make_mesh(devices=["cpu"] * 4),
                         memory_mode="ring")
    assert _rel(K2.matmat_f64(V), kernel_plain.gram_matmat_f64("rbf", X, X, V, 1.4, 0.9)) <= F64
    assert calls == ["gram_matmat_f64"] * 16
