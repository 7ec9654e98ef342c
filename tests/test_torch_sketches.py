"""The port's sketch object shell (``Sketch``, ``Gauss``, ``Ortho``,
``Sparse``, ``SRHT``, ``get_sketch``) on the CPU: the JAX package's
``tests/sketches/test_sketches.py`` cases in the port, and the four applies
held against the JAX package's with its draws injected (the port draws
other numbers for the same seed): its ``Omega_mat``, or for the SRHT its
``signs`` and ``rows``, on dense inputs and on an ``aslinop`` operator.
Float64 to 1e-12 of max|ref|, float32 to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaopt_tpu.linops import aslinop as j_aslinop
from rlaopt_tpu.sketches import get_sketch as j_get_sketch
import rlaopt_tpu_torch.sketches as tsk
from rlaopt_tpu_torch.linops import aslinop
from rlaopt_tpu_torch.sketches import SRHT, Gauss, Ortho, Sketch, Sparse, get_sketch
from rlaopt_tpu_torch.sketches.embeddings import gauss_embedding

S, D = 20, 64
NAMES = ["gauss", "ortho", "sparse", "srht"]
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5), "f64": (torch.float64, jnp.float64, 1e-12)}
APPLIES = ["_apply_left", "_apply_right", "_apply_left_trans", "_apply_right_trans"]


def _sk(name, mode, dtype=torch.float64, key=0, s=S, d=D):
    return get_sketch(name, mode, s, d, dtype, key, device="cpu")


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


# -- JAX's cases, in the port ----------------------------------------------------
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_left(name, dt):
    sk = _sk(name, "left", DTYPES[dt][0])
    assert sk.Omega_mat.shape == (S, D)
    A = torch.ones((D, 3), dtype=DTYPES[dt][0])
    assert sk._apply_left(A).shape == (S, 3)
    assert sk._apply_left_trans(torch.ones((S, 3), dtype=DTYPES[dt][0])).shape == (D, 3)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_right(name, dt):
    sk = _sk(name, "right", DTYPES[dt][0])
    assert sk.Omega_mat.shape == (D, S)
    A = torch.ones((3, D), dtype=DTYPES[dt][0])
    assert sk._apply_right(A).shape == (3, S)
    assert sk._apply_right_trans(torch.ones((3, S), dtype=DTYPES[dt][0])).shape == (3, D)


def test_invalid_name_mode():
    with pytest.raises(ValueError):
        _sk("bogus", "left")
    with pytest.raises(ValueError):
        _sk("gauss", "sideways")


def test_invalid_size_raises_as_jax():
    with pytest.raises(ValueError) as terr:
        _sk("gauss", "left", s=-3)
    with pytest.raises(ValueError) as jerr:
        j_get_sketch("gauss", "left", -3, D, jnp.float32, jax.random.PRNGKey(0))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError):
        _sk("gauss", "left", s=2.5)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_ortho_orthonormal(dt):
    dtype, _, tol = DTYPES[dt]
    Q = _sk("ortho", "right", dtype).Omega_mat  # (D, S)
    assert torch.allclose(Q.T @ Q, torch.eye(S, dtype=dtype), atol=100 * max(tol, 1e-8))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_sparse_structure(dt):
    Om = _sk("sparse", "left", DTYPES[dt][0]).Omega_mat
    nnz_per_col = torch.sum(Om != 0, dim=0)
    assert torch.all(nnz_per_col <= 8) and torch.all(nnz_per_col >= 1)
    vals = torch.unique(torch.abs(Om[Om != 0]))
    assert torch.allclose(vals, torch.full_like(vals, 8**-0.5))


def test_gauss_isometry_in_expectation():
    d, n = 10, 200
    Oms = torch.stack([gauss_embedding(i, 30, d, torch.float64, "cpu") for i in range(n)])
    acc = torch.einsum("bsd,bse->de", Oms, Oms) / n
    assert torch.allclose(acc, torch.eye(d, dtype=torch.float64), atol=0.15)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_apply_to_linop(dt):
    dtype, _, tol = DTYPES[dt]
    M = torch.randn((D, 5), generator=torch.Generator().manual_seed(1), dtype=dtype)
    sk = _sk("gauss", "left", dtype, key=2)
    got = sk._apply_left(aslinop(M))
    assert torch.allclose(got, sk.Omega_mat @ M, rtol=10 * tol, atol=10 * tol)


@pytest.mark.parametrize("mode", ["left", "right"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_srht_all_four_applies(dt, mode):
    """JAX's ``TestSRHT.test_all_four_applies``: the fast transform against
    the materialized matrix."""
    dtype, _, tol = DTYPES[dt]
    sk = SRHT(mode, S, D, dtype, 0, "cpu")
    Om = sk.Omega_mat
    ones = lambda *shape: torch.ones(shape, dtype=dtype)  # noqa: E731
    r, c = Om.shape
    pairs = [(sk._apply_left(ones(c, 2)), Om @ ones(c, 2)),
             (sk._apply_right(ones(3, r)), ones(3, r) @ Om),
             (sk._apply_left_trans(ones(r, 2)), Om.T @ ones(r, 2)),
             (sk._apply_right_trans(ones(3, c)), ones(3, c) @ Om.T)]
    for got, want in pairs:
        assert torch.allclose(got, want, rtol=100 * tol, atol=100 * tol)


def test_srht_vector_operands():
    """A 1-D operand on the transform's row side gives a 1-D result."""
    sk = SRHT("right", S, D, torch.float64, 0, "cpu")
    x = torch.linspace(-1, 1, D, dtype=torch.float64)
    assert torch.allclose(sk._apply_right(x), x @ sk.Omega_mat, atol=1e-12)
    sk = SRHT("left", S, D, torch.float64, 0, "cpu")
    assert torch.allclose(sk._apply_right_trans(x), x @ sk.Omega_mat.T, atol=1e-12)


# -- the object shell ------------------------------------------------------------
def test_exports_match_jax():
    import rlaopt_tpu.sketches as jsk

    for name in ("Sketch", "Gauss", "Ortho", "Sparse", "SRHT", "get_sketch"):
        assert name in tsk.__all__ and name in jsk.__all__
    assert set(jsk.__all__) <= set(tsk.__all__)


@pytest.mark.parametrize("name,cls", [("gauss", Gauss), ("ortho", Ortho), ("sparse", Sparse),
                                      ("srht", SRHT)])
def test_factory_classes_and_attributes(name, cls):
    sk = _sk(name, "left", key=5)
    assert type(sk) is cls and isinstance(sk, Sketch)
    assert (sk.s, sk.d, sk.dtype) == (S, D, torch.float64)
    assert sk.device == torch.device("cpu") and sk.Omega_mat.device.type == "cpu"
    assert isinstance(sk.key, torch.Generator)
    again = _sk(name, "left", key=5)
    assert torch.equal(sk.Omega_mat, again.Omega_mat)
    other = _sk(name, "left", key=6)
    assert not torch.equal(sk.Omega_mat, other.Omega_mat)
    right = _sk(name, "right", key=5)
    assert torch.equal(right.Omega_mat, sk.Omega_mat.T)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the card here")
def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        get_sketch("gauss", "left", S, D, torch.float32, 0)


def test_srht_omega_setter_and_lazy_matrix():
    sk = SRHT("left", S, D, torch.float64, 0, "cpu")
    assert sk._materialized is None
    Om = sk.Omega_mat
    assert sk._materialized is Om
    sk.Omega_mat = torch.zeros_like(Om)
    assert torch.equal(sk.Omega_mat, torch.zeros_like(Om))


# -- parity with the JAX package, its draws injected -----------------------------
def _inject(jsk, sk):
    if isinstance(sk, SRHT):
        sk.signs = torch.from_numpy(np.array(jsk.signs))
        sk.rows = torch.from_numpy(np.array(jsk.rows)).to(torch.int64)
        sk.Omega_mat = None
    else:
        sk.Omega_mat = torch.from_numpy(np.array(jsk.Omega_mat))


def _operands(shape_of, dtype, seed):
    """Dense inputs of each apply: (numpy array) by apply name."""
    rng = np.random.default_rng(seed)
    return {a: rng.standard_normal(shape_of[a]).astype(dtype) for a in APPLIES}


@pytest.mark.parametrize("operand", ["dense", "linop"])
@pytest.mark.parametrize("mode", ["left", "right"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_applies_match_jax_with_its_draws(name, dt, mode, operand):
    tdtype, jdtype, tol = DTYPES[dt]
    jsk = j_get_sketch(name, mode, S, 50 if name == "srht" else D, jdtype,
                       jax.random.PRNGKey(3))
    d = jsk.d
    sk = get_sketch(name, mode, S, d, tdtype, 0, device="cpu")
    _inject(jsk, sk)
    r, c = (S, d) if mode == "left" else (d, S)
    shape_of = {"_apply_left": (c, 3), "_apply_right": (4, r),
                "_apply_left_trans": (r, 3), "_apply_right_trans": (4, c)}
    np_dtype = np.float64 if dt == "f64" else np.float32
    xs = _operands(shape_of, np_dtype, seed=11)
    for apply, x in xs.items():
        if operand == "dense":
            jx, tx = jnp.asarray(x), torch.from_numpy(x)
        else:
            jx, tx = j_aslinop(jnp.asarray(x)), aslinop(torch.from_numpy(x))
        ref = np.asarray(getattr(jsk, apply)(jx))
        got = getattr(sk, apply)(tx)
        assert got.dtype == tdtype and tuple(got.shape) == ref.shape, apply
        assert _rel(got.numpy(), ref) <= tol, (apply, _rel(got.numpy(), ref))
    assert _rel(sk.Omega_mat.numpy(), np.asarray(jsk.Omega_mat)) <= tol
