"""The pair product ``(c·K @ V2, c·Kᵀ @ V1)``, K = k(X1, X2) evaluated once:
the plain versions of K4, K4b and K6 (``kernel_plain.gram_pair``,
``gram_pair_tier``) and the routing of ``kernel_dispatch.kernel_pair``,
against the JAX package's ``kernel_pair_matmat`` (Pallas, interpret mode)
and its ``kernel_pair`` (the streaming route, float64), on the same numpy
inputs.

Shapes are ragged on purpose: n1 = 260 and n2 = 200 against the JAX
kernel's tile of 256, d = 5 (and n1 = 129, n2 = 301 and the other way
round, d = 28, in the exact tier). Bounds are max abs error over max|ref|:

* exact tier, float32: 2e-5, K2's and K5's contract (the JAX kernel's
  mirror is a 6-pass MXU contraction at k ≥ 3, the port's float32 FMAs);
* the bf16 tiers: both sides take the same bf16 roundings of the same
  points, so what is left is the order of the float32 sums and exp (1e-6),
  and the tier-matched mirror contraction at k ≥ 3: bf16x3's three-pass
  "split", whose hi/lo split of the kernel values moves with their float32
  round-off (3e-6), and bfloat16's one bf16 rounding of each kernel value,
  where a value one float bit apart now and then rounds the other way,
  2^-8 of that product (1.6e-4 measured; 5e-4, ``chip_smoke.py``'s bound of
  the same re-rounding);
* float64: 1e-10 against the JAX package's float64 streaming route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.ops.kernel_dispatch import kernel_pair as j_kernel_pair
from rlaopt_tpu.ops.kernel_pallas import kernel_pair_matmat
from rlaopt_tpu_torch.ops import kernel_dispatch, kernel_plain
from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand

N1, N2, D = 260, 200, 5
LS, C = 1.3, 0.9
EXACT_BOUND, F64_BOUND = 2e-5, 1e-10


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _data(k, dtype=np.float32, seed=0, n1=N1, n2=N2, d=D):
    rng = np.random.default_rng(seed + k)
    X1 = rng.standard_normal((n1, d)).astype(dtype)
    X2 = rng.standard_normal((n2, d)).astype(dtype)
    V2 = rng.standard_normal((n2, k)).astype(dtype)
    V1 = rng.standard_normal((n1, k)).astype(dtype)
    return X1, X2, V2, V1


def _pallas(kind, X1, X2, V2, V1, cd=None, ls=LS):
    return kernel_pair_matmat(
        kind, *(jnp.asarray(a) for a in (X1, X2, V2, V1)), ls, C,
        compute_dtype=cd, tile=256, interpret=True,
    )


@pytest.mark.parametrize(
    "kind,k",
    [("rbf", 1), ("rbf", 2), ("rbf", 10), ("matern12", 3), ("matern32", 16),
     ("matern52", 3), ("laplace", 1), ("laplace", 3), ("laplace", 10), ("laplace", 16)],
)
def test_plain_pair_matches_pallas_exact_tier(kind, k):
    """K4's and K6's plain version in float32 against the JAX pair kernel:
    both outputs of the ragged rectangle (no diagonal)."""
    X1, X2, V2, V1 = _data(k)
    r1, r2 = _pallas(kind, X1, X2, V2, V1)
    o1, o2 = kernel_plain.gram_pair(kind, *(torch.from_numpy(a) for a in (X1, X2, V2, V1)),
                                    LS, C)
    assert o1.shape == (N1, k) and o2.shape == (N2, k)
    assert _rel(o1, r1) <= EXACT_BOUND
    assert _rel(o2, r2) <= EXACT_BOUND


@pytest.mark.parametrize("n1,n2", [(129, 301), (301, 129)])
@pytest.mark.parametrize("kind,k", [("rbf", 3), ("matern52", 10), ("laplace", 3),
                                    ("laplace", 10)])
def test_plain_pair_matches_pallas_ragged(kind, k, n1, n2):
    """The exact pair's plain version (K4, K6) at n1 ≠ n2, neither a
    multiple of the JAX kernel's tile nor of the card's 128, at the HIGGS
    width (d = 28, lengthscale near the mean distance: Laplace 2d/√π, the
    others √d): both outputs within 2e-5 of max|ref|."""
    X1, X2, V2, V1 = _data(k, seed=3, n1=n1, n2=n2, d=28)
    ls = 2 * 28 / np.sqrt(np.pi) if kind == "laplace" else 28**0.5
    r1, r2 = _pallas(kind, X1, X2, V2, V1, ls=ls)
    o1, o2 = kernel_plain.gram_pair(kind, *(torch.from_numpy(a) for a in (X1, X2, V2, V1)),
                                    ls, C)
    assert o1.shape == (n1, k) and o2.shape == (n2, k)
    assert _rel(o1, r1) <= EXACT_BOUND
    assert _rel(o2, r2) <= EXACT_BOUND


@pytest.mark.parametrize("cd,k", [("bf16x3", 1), ("bf16x3", 3), ("bfloat16", 1),
                                  ("bfloat16", 3)])
def test_plain_pair_tier_matches_pallas(cd, k):
    """K4b's plain version on the tier parts against the JAX pair kernel on
    the same tier: the forward product in float32, the mirror in float32 at
    k ≤ 2 and tier-matched at k ≥ 3 in both packages."""
    X1, X2, V2, V1 = _data(k, seed=7)
    r1, r2 = _pallas("rbf", X1, X2, V2, V1, cd)
    A = tier_operand(torch.from_numpy(X1) / LS, cd)
    B = tier_operand(torch.from_numpy(X2) / LS, cd)
    o1, o2 = kernel_plain.gram_pair_tier(
        "rbf", A, B, torch.from_numpy(V2), torch.from_numpy(V1), C
    )
    assert _rel(o1, r1) <= 1e-6
    mirror_bound = {"bf16x3": 3e-6, "bfloat16": 5e-4}[cd] if k >= 3 else 1e-6
    assert _rel(o2, r2) <= mirror_bound


@pytest.mark.parametrize("kind", ["rbf", "matern12", "matern32", "matern52", "laplace"])
def test_plain_pair_f64_matches_jax(kind):
    """In float64 the plain pair against the JAX package's ``kernel_pair``
    (two float64 streaming products off the TPU)."""
    X1, X2, V2, V1 = _data(3, np.float64, seed=11)
    r1, r2 = j_kernel_pair(kind, *(jnp.asarray(a) for a in (X1, X2, V2, V1)), LS, C)
    o1, o2 = kernel_dispatch.kernel_pair(
        kind, *(torch.from_numpy(a) for a in (X1, X2, V2, V1)), LS, C
    )
    assert o1.dtype == torch.float64
    assert _rel(o1, r1) <= F64_BOUND
    assert _rel(o2, r2) <= F64_BOUND


def test_pair_routing_past_16_columns_and_1d(monkeypatch):
    """k > 16 takes two general products (the JAX package's route, which
    the half-ring's Nyström sketch and Hutchinson probes take), k ≤ 16 the
    pair; 1-D operands come back 1-D, equal to the first column of the 2-D
    product."""
    calls = {"pair": 0, "matmat": 0}
    real_pair, real_mm = kernel_plain.gram_pair, kernel_dispatch.kernel_matmat

    def pair(*a, **kw):
        calls["pair"] += 1
        return real_pair(*a, **kw)

    def mm(*a, **kw):
        calls["matmat"] += 1
        return real_mm(*a, **kw)

    monkeypatch.setattr(kernel_plain, "gram_pair", pair)
    monkeypatch.setattr(kernel_dispatch, "kernel_matmat", mm)
    X1, X2, V2, V1 = _data(20, np.float64, seed=3)
    args = [torch.from_numpy(a) for a in (X1, X2, V2, V1)]
    o1, o2 = kernel_dispatch.kernel_pair("matern32", *args, LS, C)
    assert calls == {"pair": 0, "matmat": 2}
    r1, r2 = j_kernel_pair("matern32", *(jnp.asarray(a) for a in (X1, X2, V2, V1)), LS, C)
    assert _rel(o1, r1) <= F64_BOUND and _rel(o2, r2) <= F64_BOUND
    s1, s2 = kernel_dispatch.kernel_pair("matern32", args[0], args[1], args[2][:, 0],
                                         args[3][:, 0], LS, C)
    assert calls == {"pair": 1, "matmat": 2}
    assert s1.shape == (N1,) and s2.shape == (N2,)
    w1, w2 = kernel_dispatch.kernel_pair("matern32", args[0], args[1], args[2][:, :1],
                                         args[3][:, :1], LS, C)
    torch.testing.assert_close(s1, w1[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(s2, w2[:, 0], rtol=0, atol=0)


def test_pair_tier_routing_and_triangle_identity():
    """The tier pair of one data set's two halves holds the off-diagonal
    blocks of the tier's triangle product: forward rows of the first half
    plus the mirror rows of the second equal K2b's plain version on the
    whole set (k = 2: float32 in both) to the order of the sums."""
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.standard_normal((256, D)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((256, 2)).astype(np.float32))
    P = tier_operand(X / LS, "bf16x3")
    top, bot = P.rows(slice(0, 128)), P.rows(slice(128, 256))
    o_top, o_bot = kernel_dispatch.kernel_pair_tier("rbf", top, bot, V[128:], V[:128], C)
    d_top = kernel_plain.gram_matvec_symmetric_tier("rbf", top, V[:128], C)
    d_bot = kernel_plain.gram_matvec_symmetric_tier("rbf", bot, V[128:], C)
    got = torch.cat([d_top + o_top, d_bot + o_bot])
    ref = kernel_plain.gram_matvec_symmetric_tier("rbf", P, V, C)
    assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("cd,k", [("bf16x3", 1), ("bf16x3", 3), ("bfloat16", 2)])
def test_tier_ring_reaches_the_pair_kernel(monkeypatch, cd, k):
    """The bf16 half-ring (E4's schedule) on a 4-position CPU mesh, with
    ragged shards (n = 203: 51 rows each, the last padded), on the card's
    route (``kernel_dispatch._on_card`` forced true; K4b and K2b replaced by
    recorders that compute with their plain versions): a matvec reaches
    K4b P(P − 1)/2 = 6 times and K2b P = 4 times. Each pair call of shards
    (p, q) is handed V2 = v_q and V1 = v_p, two different blocks, and its
    outputs equal the JAX pair kernel's on the same shards in interpret
    mode at the tier's bounds (:func:`test_plain_pair_tier_matches_pallas`),
    but for bf16x3's tier-matched mirror at k ≥ 3: a value whose float32
    round-off differs moves its bf16 lo part by up to 2^-17 of the product,
    and a shard's sums over 51 rows are small against that, so 2^-16 of
    max|ref| there (3.6e-6 measured); the ring's result equals the plain
    K2b on the whole set to the order of the sums, at the same bounds."""
    from rlaopt_tpu_torch.kernels import KernelConfig, ShardedRBFLinOp
    from rlaopt_tpu_torch.ops import kernel_cuda
    from rlaopt_tpu_torch.parallel import make_mesh

    pairs, triangles = [], []

    def pair(kind, A, B, V2, V1, const_scaling=1.0):
        out = kernel_plain.gram_pair_tier(kind, A, B, V2, V1, const_scaling)
        pairs.append((A, B, V2, V1, out))
        return out

    def triangle(kind, A, V, const_scaling=1.0):
        triangles.append(A)
        return kernel_plain.gram_matvec_symmetric_tier(kind, A, V, const_scaling)

    monkeypatch.setattr(kernel_cuda, "gram_pair_tier", pair)
    monkeypatch.setattr(kernel_cuda, "gram_matvec_symmetric_tier", triangle)
    monkeypatch.setattr(kernel_dispatch, "_on_card", lambda impl, t: True)
    n, P, loc = 203, 4, 51
    rng = np.random.default_rng(30 + k)
    X = rng.standard_normal((n, D)).astype(np.float32)
    v = rng.standard_normal((n, k)).astype(np.float32)
    Xt = torch.from_numpy(X)
    K = ShardedRBFLinOp(Xt, Xt, KernelConfig(lengthscale=LS, const_scaling=C),
                        mesh=make_mesh(devices=["cpu"] * P), memory_mode="ring", compute_dtype=cd)
    got = K @ torch.from_numpy(v)
    assert len(pairs) == P * (P - 1) // 2 and len(triangles) == P
    Xp = np.concatenate([X, np.zeros((P * loc - n, D), np.float32)])
    vp = np.concatenate([v, np.zeros((P * loc - n, k), np.float32)])
    shards = [tier_operand(torch.from_numpy(Xp[p * loc:(p + 1) * loc]) / LS, cd) for p in range(P)]

    def which(T):
        (p,) = [p for p, S in enumerate(shards) if torch.equal(S.hi, T.hi)]
        return p

    seen = set()
    mirror_bound = {"bf16x3": 2.0**-16, "bfloat16": 5e-4}[cd] if k >= 3 else 1e-6
    for A, B, V2, V1, (o1, o2) in pairs:
        p, q = which(A), which(B)
        assert p != q and frozenset((p, q)) not in seen
        seen.add(frozenset((p, q)))
        assert np.array_equal(V2.numpy(), vp[q * loc:(q + 1) * loc])
        assert np.array_equal(V1.numpy(), vp[p * loc:(p + 1) * loc])
        r1, r2 = kernel_pair_matmat(
            "rbf", *(jnp.asarray(a) for a in (Xp[p * loc:(p + 1) * loc], Xp[q * loc:(q + 1) * loc],
                                              V2.numpy(), V1.numpy())),
            LS, C, compute_dtype=cd, tile=256, interpret=True,
        )
        assert _rel(o1, r1) <= 1e-6
        assert _rel(o2, r2) <= mirror_bound
    whole = kernel_plain.gram_matvec_symmetric_tier(
        "rbf", tier_operand(torch.from_numpy(X) / LS, cd), torch.from_numpy(v), C)
    assert _rel(got, whole) <= (mirror_bound if k >= 3 else 1e-6)
