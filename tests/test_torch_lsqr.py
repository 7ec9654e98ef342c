"""The port's sketch-and-precondition least squares against the JAX package
on the CPU, on the same numpy inputs: the butterfly FWHT, the SRHT, the
SkPre factor and its applies, and LSQR through ``LstSq.solve`` with the same
factor handed to both packages (float64: 1e-12 for the transforms, 1e-9
for the iterates); the damped and unpreconditioned solves, the sparse
path end to end against scipy, and the state carried across packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from rlaopt_tpu.models import LstSq as JLstSq
from rlaopt_tpu.ops.fwht import fwht as j_fwht
from rlaopt_tpu.preconditioners import IdentityConfig as JIdentityConfig
from rlaopt_tpu.preconditioners import SkPre as JSkPre
from rlaopt_tpu.preconditioners import SkPreConfig as JSkPreConfig
from rlaopt_tpu.preconditioners import skpre as j_skpre
from rlaopt_tpu.sketches import embeddings as j_emb
from rlaopt_tpu.solvers import LSQRConfig as JLSQRConfig
from rlaopt_tpu.sparse import SparseCSRTensor as JSparseCSRTensor
from rlaopt_tpu_torch import interop
from rlaopt_tpu_torch.linops import aslinop
from rlaopt_tpu_torch.models import LstSq
from rlaopt_tpu_torch.ops.fwht import fwht, hadamard_matrix, next_pow2
from rlaopt_tpu_torch.preconditioners import (
    IdentityConfig,
    NystromConfig,
    SkPre,
    SkPreConfig,
    skpre_apply,
    skpre_apply_inv,
    skpre_update,
)
from rlaopt_tpu_torch.sketches import embeddings as t_emb
from rlaopt_tpu_torch.solvers import LSQRConfig
from rlaopt_tpu_torch.sparse import SparseCSRTensor

M, N, S = 600, 64, 256
ITERS, FREQ = 30, 5


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _problem(k=1, sparse=False, seed=0, s=S, decay=3):
    """A tall A with columns scaled by logspace(0, -decay), a (M, k)
    right-hand side and the factor of an s-row Gaussian sketch of A.

    LSQR's float64 iterates are only reproducible across two summation
    orders while it is well conditioned: unpreconditioned at decay 3 (or
    with a sketch of N + 8 rows), a 1e-15 change of B moves the logged
    rel_res by 60% within 20 steps, in either package alone (damped at
    decay 1, by 5e-5 within 30). The parity tests hence take the 4N-row
    sketch, or decay 1 and 20 steps without one."""
    rng = np.random.default_rng(seed)
    if sparse:
        A = sp.random(M, N, density=0.2, format="csr", random_state=seed)
        A = (A + sp.diags(np.ones(N), shape=(M, N))).tocsr()
        A = (A @ sp.diags(np.logspace(0, -decay, N))).tocsr()
        dense = A.toarray()
    else:
        dense = rng.standard_normal((M, N)) * np.logspace(0, -decay, N)
        A = dense
    B = rng.standard_normal((M, k))
    Omega = rng.standard_normal((s, M)) / s**0.5
    L = np.linalg.cholesky((Omega @ dense).T @ (Omega @ dense))
    return A, dense, B, L


def _operands(A, sparse):
    if sparse:
        return JSparseCSRTensor(A), SparseCSRTensor(A, device="cpu")
    return jnp.asarray(A), torch.from_numpy(A)


def _close(t, j):
    """Logged rel_res of the two packages: 1e-9 relative, and 1e-11 absolute
    near convergence, where the normal residual ‖Aᵀ(B − AW)‖ magnifies the
    iterates' rounding-level difference (≤ 1e-12 of W) by ‖AᵀA‖‖W‖/‖AᵀB‖."""
    return np.all(np.abs(np.asarray(t) - np.asarray(j)) <= 1e-9 * np.abs(j) + 1e-11)


def _solve_both(A, B, L, sparse, damp=0.0, precond="skpre", iters=ITERS, rtol=1e-14):
    """One LstSq solve in each package; returns (jax, torch) pairs of
    (W, {iteration: rel_res}, [W at each boundary])."""
    jA, tA = _operands(A, sparse)
    if precond == "skpre":
        jP = JSkPre(JSkPreConfig(sketch_size=S, rho=0.0))
        jP.L = jnp.asarray(L)
        tP = interop.skpre_preconditioner(L)
        jcfg_p, tcfg_p = JSkPreConfig(sketch_size=S, rho=0.0), SkPreConfig(sketch_size=S, rho=0.0)
    else:
        jP = tP = None
        jcfg_p, tcfg_p = JIdentityConfig(), IdentityConfig()
    out = []
    for model, cfg, W0, P, to_np in (
        (JLstSq(jA, jnp.asarray(B), damp=damp),
         JLSQRConfig(max_iters=iters, rtol=rtol, damp=damp, precond_config=jcfg_p),
         jnp.zeros((N, B.shape[1])), jP, np.asarray),
        (LstSq(tA, torch.from_numpy(B), damp=damp),
         LSQRConfig(max_iters=iters, rtol=rtol, damp=damp, precond_config=tcfg_p),
         torch.zeros((N, B.shape[1]), dtype=torch.float64), tP, lambda t: t.numpy()),
    ):
        seen = []
        W, log = model.solve(
            cfg, W0, callback_freq=FREQ, key=0, preconditioner=P,
            callback_fn=lambda w, _m: seen.append(to_np(w).copy()),
        )
        rel = {i: to_np(log[i]["metrics"]["internal_metrics"]["rel_res"])
               for i in log if isinstance(i, int)}
        out.append((to_np(W), rel, seen))
    return out


def test_fwht_is_exact_on_integers():
    rng = np.random.default_rng(1)
    for p in (1, 2, 64):
        x = torch.from_numpy(rng.integers(-9, 10, (p, 3)).astype(np.float64))
        assert torch.equal(fwht(x), hadamard_matrix(p, torch.float64) @ x)
        assert torch.equal(fwht(x.T, axis=1), (hadamard_matrix(p, torch.float64) @ x).T)
    assert next_pow2(100) == 128 and next_pow2(128) == 128 and next_pow2(1) == 1
    x = rng.standard_normal(256)
    assert _rel(fwht(torch.from_numpy(x)).numpy(), j_fwht(jnp.asarray(x))) <= 1e-12
    with pytest.raises(ValueError, match="power of 2"):
        fwht(torch.zeros(12))


@pytest.mark.parametrize("ndim", [1, 2])
def test_srht_apply_and_matrix_match_jax(ndim):
    """The same signs and rows in both packages: the fast transform and the
    materialized (s, d) matrix, to 1e-12; and the two agree."""
    d, s = 100, 40
    rng = np.random.default_rng(2)
    p = next_pow2(d)
    signs = rng.choice([-1.0, 1.0], p)
    rows = rng.permutation(p)[:s]
    A = rng.standard_normal(d if ndim == 1 else (d, 7))
    got = t_emb.srht_apply(torch.from_numpy(signs), torch.from_numpy(rows), torch.from_numpy(A))
    ref = j_emb.srht_apply(jnp.asarray(signs), jnp.asarray(rows), jnp.asarray(A))
    assert got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= 1e-12
    Theta = t_emb.srht_matrix(torch.from_numpy(signs), torch.from_numpy(rows), d)
    assert _rel(Theta.numpy(), j_emb.srht_matrix(jnp.asarray(signs), jnp.asarray(rows), d)) <= 1e-12
    assert _rel((Theta.numpy() @ A), got.numpy()) <= 1e-12


def test_skpre_update_and_applies_match_jax():
    rng = np.random.default_rng(3)
    Y = rng.standard_normal((S, N)) * np.logspace(0, -3, N)
    x = rng.standard_normal((N, 2))
    L = skpre_update(torch.from_numpy(Y), 1e-6)
    jL = j_skpre.skpre_update(jnp.asarray(Y), 1e-6)
    assert _rel(L.numpy(), jL) <= 1e-12
    assert _rel(skpre_apply(L, torch.from_numpy(x)).numpy(),
                j_skpre.skpre_apply(jL, jnp.asarray(x))) <= 1e-12
    for v in (x, x[:, 0]):
        assert _rel(skpre_apply_inv(L, torch.from_numpy(v)).numpy(),
                    j_skpre.skpre_apply_inv(jL, jnp.asarray(v))) <= 1e-10


@pytest.mark.parametrize("sparse", [False, True])
def test_lsqr_iterates_match_jax(sparse):
    """30 preconditioned LSQR steps, k = 2, the same L in both packages:
    every logged rel_res and every boundary's iterate to 1e-9."""
    A, _, B, L = _problem(k=2, sparse=sparse)
    (jW, jrel, jseen), (tW, trel, tseen) = _solve_both(A, B, L, sparse)
    assert sorted(trel) == sorted(jrel) == list(range(0, ITERS + 1, FREQ))
    assert np.all(trel[ITERS] > 1e-13)
    for i in jrel:
        assert _close(trel[i], jrel[i]), i
    assert len(tseen) == len(jseen)
    for t, j in zip(tseen[1:], jseen[1:]):
        assert _rel(t, j) <= 1e-9
    assert _rel(tW, jW) <= 1e-9


def test_damped_lsqr_matches_jax_and_scipy():
    """Damped LSQR: unpreconditioned (as the JAX package's own damped test
    runs it) against the JAX package and, at its limit, scipy's lsqr; with
    SkPre (whose damping acts on the preconditioned unknowns Lᵀ W) against
    the JAX package."""
    damp = 0.05
    A, dense, B, L = _problem(k=1, seed=4, decay=1)
    (jW, jrel, _), (tW, trel, _) = _solve_both(
        A, B, L, False, damp=damp, precond="identity", iters=20
    )
    for i in jrel:
        assert _close(trel[i], jrel[i]), i
    assert _rel(tW, jW) <= 1e-9
    (_, _, _), (tW, _, _) = _solve_both(
        A, B, L, False, damp=damp, precond="identity", iters=300, rtol=1e-12
    )
    ref = spla.lsqr(dense, B[:, 0], damp=damp, atol=0, btol=0, iter_lim=5000)[0]
    assert _rel(tW[:, 0], ref) <= 1e-8
    A, _, B, L = _problem(k=2, seed=4)
    (jW, jrel, _), (tW, trel, _) = _solve_both(A, B, L, False, damp=damp)
    for i in jrel:
        assert _close(trel[i], jrel[i]), i
    assert _rel(tW, jW) <= 1e-9


def test_identity_lsqr_matches_jax_and_scipy():
    A, dense, B, L = _problem(k=1, seed=5, decay=1)
    (jW, jrel, _), (tW, trel, _) = _solve_both(A, B, L, False, precond="identity", iters=20)
    for i in jrel:
        assert _close(trel[i], jrel[i]), i
    assert _rel(tW, jW) <= 1e-9
    ref = spla.lsqr(dense, B[:, 0], atol=0, btol=0, iter_lim=20)[0]
    assert _rel(tW[:, 0], ref) <= 1e-9


def test_lstsq_sparse_end_to_end_against_scipy():
    """The user path at test scale, as tests/sparse/test_sparse_linop.py runs
    it for the JAX package: ``LstSq(SparseCSRTensor(A), b)`` with the sparse
    SkPre sketch drawn by the port."""
    m, n = 2000, 120
    rng = np.random.default_rng(3)
    Msp = sp.random(m, n, density=0.05, format="csr", random_state=3)
    Msp = (Msp + sp.diags(np.ones(n), shape=(m, n), format="csr")).tocsr()
    b = rng.standard_normal(m)
    model = LstSq(SparseCSRTensor(Msp, device="cpu"), torch.from_numpy(b))
    cfg = LSQRConfig(
        max_iters=80, rtol=1e-10,
        precond_config=SkPreConfig(sketch_size=4 * n, rho=0.0, sketch="sparse"),
    )
    W, log = model.solve(cfg, torch.zeros((n, 1), dtype=torch.float64), callback_freq=10, key=0)
    ref = spla.lsqr(Msp, b, atol=0, btol=0, iter_lim=2000)[0]
    np.testing.assert_allclose(W[:, 0].numpy(), ref, atol=1e-6)
    last = max(i for i in log if isinstance(i, int))
    assert float(log[last]["metrics"]["internal_metrics"]["rel_res"][0]) <= 1e-10
    assert set(model.phase_walls) == {"solver_init", "train"}


def test_invalid_preconditioner_raises_type_error():
    A, _, B, _ = _problem()
    model = LstSq(torch.from_numpy(A), torch.from_numpy(B))
    cfg = LSQRConfig(max_iters=5, precond_config=NystromConfig(rank=4, rho=1.0))
    with pytest.raises(TypeError, match="Valid preconditioner configs for LSQR"):
        model.solve(cfg, torch.zeros((N, 1), dtype=torch.float64))


def test_lsqr_state_carries_over_from_jax():
    """Ten JAX steps, the state handed over (``interop.lsqr_state``), ten
    port steps: the twenty-step JAX iterate to 1e-9."""
    A, _, B, L = _problem(k=2, seed=6)
    jmodel = JLstSq(jnp.asarray(A), jnp.asarray(B))
    jP = JSkPre(JSkPreConfig(sketch_size=S, rho=0.0))
    jP.L = jnp.asarray(L)
    from rlaopt_tpu.solvers.lsqr import LSQR as JLSQR

    jsolver = JLSQR(jmodel, None, JSkPreConfig(sketch_size=S, rho=0.0), preconditioner=jP)
    jsolver._run_chunk(10)
    mid = [np.asarray(a) for a in jsolver.state]
    jsolver._run_chunk(10)

    from rlaopt_tpu_torch.solvers.lsqr import LSQR

    tmodel = LstSq(torch.from_numpy(A), torch.from_numpy(B))
    tsolver = LSQR(tmodel, None, SkPreConfig(sketch_size=S, rho=0.0),
                   preconditioner=interop.skpre_preconditioner(L))
    tsolver.state = interop.lsqr_state(*mid)
    tsolver._run_chunk(10)
    assert _rel(tsolver.W.numpy(), np.asarray(jsolver.W)) <= 1e-9


def test_skpre_warns_below_ncols_and_builds_its_factor():
    A, dense, _, _ = _problem(seed=7)
    P = SkPre(SkPreConfig(sketch_size=N - 4, rho=1e-3, sketch="gauss"))
    with pytest.warns(UserWarning, match="smaller than the number of columns"):
        P._update(torch.from_numpy(A), key=0)
    P = SkPre(SkPreConfig(sketch_size=S, rho=0.0))
    P._update(aslinop(torch.from_numpy(A)), key=0)
    # L Lᵀ = (ΩA)ᵀ(ΩA): the sketch of A preserves its column space's scale
    G = P.L.numpy() @ P.L.numpy().T
    ratio = np.diag(G) / np.diag(dense.T @ dense)
    assert np.all((ratio > 0.3) & (ratio < 3.0))


@pytest.mark.parametrize("name", ["gauss", "ortho", "sparse", "srht"])
def test_transposed_embedding_has_the_same_values(name):
    """Ωᵀ drawn in (d, s) layout for an operator is ``left_embedding(...).T``
    for the same generator, so the sketch of a LinOp equals Ω @ A."""
    d, s = 50, 12
    got = t_emb._left_embedding_t(name, torch.Generator().manual_seed(8), s, d, torch.float64)
    ref = t_emb.left_embedding(name, torch.Generator().manual_seed(8), s, d, torch.float64)
    assert got.is_contiguous() and got.shape == (d, s)
    assert torch.equal(got, ref.T)
    A = torch.from_numpy(np.random.default_rng(9).standard_normal((d, 5)))
    Y = t_emb.sketch_apply_left(name, torch.Generator().manual_seed(8), s, aslinop(A), torch.float64)
    assert _rel(Y.numpy(), (ref @ A).numpy()) <= 1e-12
