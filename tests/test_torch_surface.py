"""The port's public surface against the JAX package's, called as a JAX
caller calls it, on the same numpy inputs:

* ``impl=`` on the kernel operators (the single-device classes, the sharded
  ones and ``KernelLinOp``/``ShardedKernelLinOp`` themselves): ``"auto"``
  and ``"xla"`` agree with the JAX operator built with the same ``impl`` to
  1e-8 of max|ref| in float64; ``"pallas"`` on CPU tensors and an unknown
  value raise ``ValueError`` in both packages;
* ``parallel.shard_rows(x, mesh, axis)`` on 2-D meshes: each position holds
  the block JAX's sharding puts on the device at that position;
* ``ops``' exports (``fwht``, ``fwht_butterfly``, ``hadamard_matrix``,
  ``next_pow2``): the same names and values;
* ``solvers._get_solver_name``: the same name for every config class;
* the names a JAX caller calls with JAX's parameters in JAX's order:
  ``LinOp``, ``TwoSidedLinOp`` and ``SymmetricLinOp`` with ``data=`` (the
  callables take the payload first), ``ShardedLinOp`` and its aliases with
  ``data`` and ``data_specs`` (rows cut over the named axes, block for
  block as JAX places them, on a 2-position and a 2 x 2 mesh), the sparse
  products and ``gather_rows`` with ``impl=``, ``pcg_init`` / ``pcg_step``
  with ``inv_fn(pstate, R)``, the three embeddings with ``key`` first, and
  ``kernel_tile`` with ``precision=``: float64 results to 1e-12 of max|ref|
  of the JAX call's (the embeddings draw other numbers from a seed: their
  shape, type and structure);
* nine more names: ``key`` on ``srht_params``,
  ``left_embedding``, ``right_embedding`` and ``sketch_apply_left``;
  ``KernelConfig.lengthscale_array``; ``sparse.native_available``;
  ``SAPState``'s fields; ``kernel_matmat`` and ``kernel_pair`` in JAX's
  positional order with ``compute_dtype`` (the bf16x3 tier within its
  bound); ``precision`` and ``chunk`` on the distance tiles;
  ``ShardedKernelLinOp.shutdown``; ``devices`` on
  ``kernel_matmat_value64``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlaopt_tpu.kernels as jk
import rlaopt_tpu.ops as jops
import rlaopt_tpu.solvers as jsolvers
import rlaopt_tpu_torch.kernels as tk
import rlaopt_tpu_torch.ops as tops
import rlaopt_tpu_torch.solvers as tsolvers
from rlaopt_tpu.parallel import make_mesh as j_make_mesh
from rlaopt_tpu.parallel import make_mesh_2d as j_make_mesh_2d
from rlaopt_tpu.parallel import shard_rows as j_shard_rows
from rlaopt_tpu_torch.parallel import make_mesh, make_mesh_2d, shard_rows
import rlaopt_tpu.linops as jl
import rlaopt_tpu.sketches.embeddings as jemb
import rlaopt_tpu.sparse as jsp
import rlaopt_tpu_torch.linops as tl
import rlaopt_tpu_torch.sketches.embeddings as temb
import rlaopt_tpu_torch.sparse as tsp
from rlaopt_tpu_torch import interop
from jax.sharding import NamedSharding, PartitionSpec as P
from rlaopt_tpu.kernels.functions import kernel_tile as j_kernel_tile
from rlaopt_tpu.solvers import pcg as j_pcg
from rlaopt_tpu_torch.kernels.functions import kernel_tile as t_kernel_tile
from rlaopt_tpu_torch.solvers import pcg as t_pcg

F64 = 1e-8
FAMILIES = ("RBF", "Laplace", "Matern12", "Matern32", "Matern52")
CFG = dict(lengthscale=0.9, const_scaling=1.1)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _data(n1=48, n2=40, d=3, k=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n1, d)), rng.standard_normal((n2, d)),
            rng.standard_normal((n2, k)), rng.standard_normal((n1, k)))


def _single(pkg, family, X1, X2, **kw):
    cfg = (jk if pkg == "jax" else tk).KernelConfig(**CFG)
    return getattr(jk if pkg == "jax" else tk, f"{family}LinOp")(X1, X2, cfg, **kw)


def _sharded(pkg, family, X1, X2, **kw):
    if pkg == "jax":
        return getattr(jk, f"Sharded{family}LinOp")(
            X1, X2, jk.KernelConfig(**CFG), mesh=j_make_mesh(), **kw)
    return getattr(tk, f"Sharded{family}LinOp")(
        X1, X2, tk.KernelConfig(**CFG), mesh=make_mesh(devices=["cpu"] * 8), **kw)


def _pair(build, family, impl, same):
    """The JAX and port operators of one family and impl, on one data set
    (``same``) or two."""
    X1, X2, V2, V1 = _data()
    J1, T1 = jnp.asarray(X1), torch.from_numpy(X1)
    J2, T2 = (J1, T1) if same else (jnp.asarray(X2), torch.from_numpy(X2))
    return (build("jax", family, J1, J2, impl=impl),
            build("torch", family, T1, T2, impl=impl),
            V1 if same else V2, V1)


@pytest.mark.parametrize("same", [True, False], ids=["one-set", "two-sets"])
@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("build", [_single, _sharded], ids=["single", "sharded"])
def test_impl_matches_jax(build, family, impl, same):
    J, T, V, U = _pair(build, family, impl, same)
    assert T.impl == impl
    assert _rel((T @ torch.from_numpy(V)).numpy(), J @ jnp.asarray(V)) <= F64
    assert _rel((T.T @ torch.from_numpy(U)).numpy(), J.T @ jnp.asarray(U)) <= F64


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("kind", ["rbf", "laplace"])
def test_impl_on_the_base_classes_and_oracles(kind, impl):
    """``KernelLinOp(A1, A2, cfg, kind, impl)`` positionally, as the JAX
    signature reads, and the oracles keep the operator's impl."""
    X1, X2, V2, _ = _data()
    J = jk.KernelLinOp(jnp.asarray(X1), jnp.asarray(X2), jk.KernelConfig(**CFG), kind, impl)
    T = tk.KernelLinOp(torch.from_numpy(X1), torch.from_numpy(X2), tk.KernelConfig(**CFG),
                       kind, impl)
    assert _rel((T @ torch.from_numpy(V2)).numpy(), J @ jnp.asarray(V2)) <= F64
    blk = np.arange(5, 30, 3)
    R = T.row_oracle(torch.from_numpy(blk))
    assert R.impl == impl
    assert _rel((R @ torch.from_numpy(V2)).numpy(),
                J.row_oracle(jnp.asarray(blk)) @ jnp.asarray(V2)) <= F64


@pytest.mark.parametrize("build", [_single, _sharded], ids=["single", "sharded"])
def test_pallas_on_cpu_raises_in_both(build):
    J, T, V, _ = _pair(build, "RBF", "pallas", True)
    with pytest.raises(ValueError):
        J @ jnp.asarray(V)
    with pytest.raises(ValueError, match="pallas"):
        T @ torch.from_numpy(V)


@pytest.mark.parametrize("build", [_single, _sharded], ids=["single", "sharded"])
def test_unknown_impl_raises_in_both(build):
    X1, _, _, V1 = _data()
    with pytest.raises(ValueError, match="impl"):
        J = build("jax", "RBF", jnp.asarray(X1), jnp.asarray(X1), impl="triton")
        J @ jnp.asarray(V1)
    with pytest.raises(ValueError, match="impl"):
        build("torch", "RBF", torch.from_numpy(X1), torch.from_numpy(X1), impl="triton")


@pytest.mark.parametrize("axis", ["i", "dcn", ("dcn", "i")], ids=["i", "dcn", "both"])
@pytest.mark.parametrize("grid", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_shard_rows_on_a_2d_mesh_matches_jax(grid, axis):
    n_dcn, n_ici = grid
    x = np.random.default_rng(3).standard_normal((16, 3))
    jmesh = j_make_mesh_2d(n_dcn, n_ici, devices=jax.devices()[: n_dcn * n_ici])
    placed = j_shard_rows(jnp.asarray(x), jmesh, axis=axis)
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    tmesh = make_mesh_2d(n_dcn, n_ici, devices=["cpu"] * (n_dcn * n_ici))
    got = shard_rows(torch.from_numpy(x), tmesh, axis=axis)
    assert len(got) == n_dcn * n_ici
    for p, dev in enumerate(jmesh.devices.flat):
        np.testing.assert_array_equal(got[p].numpy(), by_device[dev])


def test_shard_rows_refuses_rows_that_do_not_divide_and_unknown_axes():
    mesh = make_mesh_2d(2, 2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="divide"):
        shard_rows(torch.zeros(6, 2), mesh, axis=("dcn", "i"))
    with pytest.raises(ValueError, match="axis"):
        shard_rows(torch.zeros(8, 2), mesh, axis="j")


def test_ops_exports_the_jax_names():
    assert tops.__all__ == jops.__all__
    for name in jops.__all__:
        assert callable(getattr(tops, name))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("name", ["fwht", "fwht_butterfly"])
def test_fwht_exports_match_jax(name, axis):
    x = np.random.default_rng(4).standard_normal((64, 64))
    got = getattr(tops, name)(torch.from_numpy(x), axis=axis).numpy()
    ref = np.asarray(getattr(jops, name)(jnp.asarray(x), axis=axis))
    assert _rel(got, ref) <= 1e-12


@pytest.mark.parametrize("p", [1, 2, 16, 128])
def test_hadamard_and_next_pow2_match_jax(p):
    np.testing.assert_array_equal(
        tops.hadamard_matrix(p, dtype=torch.float64, device="cpu").numpy(),
        np.asarray(jops.hadamard_matrix(p, dtype=jnp.float64)))
    for n in (p, p + 1, 3 * p):
        assert tops.next_pow2(n) == jops.next_pow2(n)


def _configs(pkg):
    return [pkg.PCGConfig(), pkg.SAPConfig(blk_sz=8, accel=False), pkg.LSQRConfig()]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["pcg", "sap", "lsqr"])
def test_get_solver_name_matches_jax(which):
    got = tsolvers._get_solver_name(_configs(tsolvers)[which])
    assert got == jsolvers._get_solver_name(_configs(jsolvers)[which])
    assert got == ("pcg", "sap", "lsqr")[which]


def test_get_solver_name_of_a_subclass_is_none_in_both():
    class TMine(tsolvers.PCGConfig):
        pass

    class JMine(jsolvers.PCGConfig):
        pass

    assert tsolvers._get_solver_name(TMine()) is None
    assert jsolvers._get_solver_name(JMine()) is None
    assert "_get_solver_name" in tsolvers.__all__


# -- the JAX parameters in JAX's places -------------------------------------
F64_EXACT = 1e-12


@pytest.mark.parametrize("cls", ["LinOp", "TwoSidedLinOp", "SymmetricLinOp"])
def test_linops_take_data_as_jax_does(cls):
    """``data=`` in JAX's place: the callables are ``f(data, x)``, the
    derived matmat too; ``device`` is the port's keyword after JAX's."""
    rng = np.random.default_rng(30)
    M = rng.standard_normal((6, 6))
    M = M + M.T
    x, X = rng.standard_normal(6), rng.standard_normal((6, 3))

    def mv(d, v):
        return d @ v

    args = {"LinOp": ((6, 6), mv, None), "TwoSidedLinOp": ((6, 6), mv, mv, None, None),
            "SymmetricLinOp": ((6, 6), mv, None)}[cls]
    J = getattr(jl, cls)(*args, jnp.float64, jnp.asarray(M), 2.0)
    T = getattr(tl, cls)(*args, torch.float64, torch.from_numpy(M), 2.0)
    assert T.data is not None and T.device == torch.device("cpu")
    assert _rel((T @ torch.from_numpy(x)).numpy(), J @ jnp.asarray(x)) <= F64_EXACT
    assert _rel((T @ torch.from_numpy(X)).numpy(), J @ jnp.asarray(X)) <= F64_EXACT
    if cls != "LinOp":
        assert _rel((torch.from_numpy(x) @ T).numpy(), jnp.asarray(x) @ J) <= F64_EXACT
    with pytest.raises(TypeError):
        getattr(tl, cls)(*args, torch.float64, torch.from_numpy(M), 2.0, "cpu", "extra")


def _sharded_data():
    rng = np.random.default_rng(31)
    return rng.standard_normal((8, 5)), rng.standard_normal(5), rng.standard_normal((5, 2))


@pytest.mark.parametrize("cls", ["ShardedLinOp", "DistributedLinOp",
                                 "DistributedTwoSidedLinOp"])
def test_sharded_linop_takes_data_specs_as_jax_does(cls):
    """``data, data_specs`` in JAX's places on a 2-position mesh: the
    payload ``(M, w)`` with ``(P("i"), P())`` cuts M's rows and replicates
    w; each position holds JAX's block, and the row-mode products match
    JAX's."""
    M, w, X = _sharded_data()

    def mv(d, x):
        A, s = d
        return (A * s) @ x

    def rmv(d, y):
        A, s = d
        return (A * s).T @ y

    jmesh = j_make_mesh(devices=jax.devices()[:2])
    J = getattr(jl, cls)((8, 5), mv, rmv, jmesh, (jnp.asarray(M), jnp.asarray(w)),
                         (P("i"), P()), "row", "i", jnp.float64)
    T = getattr(tl, cls)((8, 5), mv, rmv, make_mesh(devices=["cpu"] * 2),
                         (torch.from_numpy(M), torch.from_numpy(w)), (P("i"), P()), "row", "i",
                         torch.float64)
    for p in range(2):
        np.testing.assert_array_equal(T._data[p][0].numpy(), M[4 * p: 4 * p + 4])
        np.testing.assert_array_equal(T._data[p][1].numpy(), w)
    assert _rel((T @ torch.from_numpy(X)).numpy(), J @ jnp.asarray(X)) <= F64_EXACT
    y = np.random.default_rng(32).standard_normal(8)
    assert _rel((torch.from_numpy(y) @ T).numpy(), jnp.asarray(y) @ J) <= F64_EXACT


@pytest.mark.parametrize("spec", [P("i"), P("dcn"), P(("dcn", "i")), P(), None],
                         ids=["i", "dcn", "both", "replicated", "none"])
def test_data_specs_place_blocks_as_jax_on_a_2x2_mesh(spec):
    """On a 2 x 2 mesh each position's block of a payload leaf is the one
    JAX's ``NamedSharding(mesh, spec)`` puts on the device at that position
    (rows cut over the named axes, replicated over the others), as
    ``shard_rows`` is tested; a dict payload keeps its keys."""
    x = np.random.default_rng(33).standard_normal((8, 3))
    jmesh = j_make_mesh_2d(2, 2, devices=jax.devices()[:4])
    placed = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, spec or P()))
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    tmesh = make_mesh_2d(2, 2, devices=["cpu"] * 4)
    T = tl.ShardedLinOp((8, 3), lambda d, v: d["x"] @ v, lambda d, v: d["x"].T @ v, tmesh,
                        {"x": torch.from_numpy(x)}, {"x": spec}, axis=("dcn", "i"))
    for p, dev in enumerate(jmesh.devices.flat):
        np.testing.assert_array_equal(T._data[p]["x"].numpy(), by_device[dev])


def test_data_specs_refuse_a_sharded_second_dimension():
    tmesh = make_mesh(devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="first dimension"):
        tl.ShardedLinOp((4, 4), lambda d, v: d @ v, lambda d, v: d.T @ v, tmesh,
                        torch.zeros(4, 4), P(None, "i"))


def _csr(seed=34, n=9, m=7):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, m)) * (rng.random((n, m)) < 0.4)
    indptr = np.concatenate([[0], np.cumsum((M != 0).sum(1))]).astype(np.int32)
    rows, cols = np.nonzero(M)
    return M, M[rows, cols], indptr, cols.astype(np.int32)


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("name", ["csr_matvec", "csr_matmat", "csc_matvec", "csc_matmat"])
def test_sparse_products_take_impl_as_jax_does(name, impl):
    """``impl`` in JAX's place on the sparse products: ``"auto"`` and
    ``"xla"`` give JAX's values; the port's ``plan`` comes after it."""
    M, v, p, c = _csr()
    csc = name.startswith("csc")
    if csc:  # the CSC buffers of Mᵀ (7 x 9) are the CSR ones of M
        n_rows, k_in = M.shape[1], M.shape[0]
    else:
        n_rows, k_in = M.shape
    x = np.random.default_rng(35).standard_normal(k_in if name.endswith("vec") else (k_in, 3))
    jargs = (jnp.asarray(v), jnp.asarray(p), jnp.asarray(c), jnp.asarray(x),
             n_rows, impl)
    targs = (torch.from_numpy(v), torch.from_numpy(p), torch.from_numpy(c),
             torch.from_numpy(x), n_rows, impl)
    assert _rel(getattr(tsp, name)(*targs).numpy(), getattr(jsp, name)(*jargs)) <= F64_EXACT


@pytest.mark.parametrize("name", ["csr_matvec", "csr_matmat", "csc_matvec", "csc_matmat",
                                  "gather_rows"])
def test_sparse_native_and_unknown_impls_raise(name):
    """``"native"`` (the JAX package's OpenMP kernels, not carried over)
    raises what JAX raises without them; an unknown ``impl`` raises
    ``ValueError``. ``gather_rows(..., impl)`` otherwise gathers JAX's rows."""
    M, v, p, c = _csr()
    t = (torch.from_numpy(v), torch.from_numpy(p), torch.from_numpy(c))
    last = (torch.tensor([4, 0, 8]),) if name == "gather_rows" else (
        torch.ones(M.shape[1], dtype=torch.float64), M.shape[0])
    with pytest.raises(RuntimeError, match="native sparse kernels unavailable"):
        getattr(tsp, name)(*t, *last, "native")
    with pytest.raises(ValueError, match="impl"):
        getattr(tsp, name)(*t, *last, "triton")
    if name == "gather_rows":
        got = tsp.gather_rows(*t, torch.tensor([4, 0, 8]), "xla")
        want = jsp.gather_rows(jnp.asarray(v), jnp.asarray(p), jnp.asarray(c),
                               np.array([4, 0, 8]), "xla")
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_pcg_takes_inv_fn_and_pstate_as_jax_does():
    """``pcg_init(A, B, reg, W, inv_fn, pstate, w_zero)`` and
    ``pcg_step(A, reg, inv_fn, pstate, state, mask)`` with a diagonal
    preconditioner ``inv_fn(pstate, R) = R / pstate``: every field of the
    state matches JAX's after three steps."""
    rng = np.random.default_rng(36)
    G = rng.standard_normal((30, 30))
    A = G @ G.T / 30 + np.eye(30)
    B, W0 = rng.standard_normal((30, 2)), rng.standard_normal((30, 2))
    diag = np.diag(A) + 0.3

    def inv_fn(pstate, R):
        return R / pstate[:, None]

    js = j_pcg.pcg_init(jnp.asarray(A), jnp.asarray(B), 0.3, jnp.asarray(W0), inv_fn,
                        jnp.asarray(diag), False)
    ts = t_pcg.pcg_init(torch.from_numpy(A), torch.from_numpy(B), 0.3, torch.from_numpy(W0),
                        inv_fn, torch.from_numpy(diag), False)
    for _ in range(3):
        js = j_pcg.pcg_step(jnp.asarray(A), 0.3, inv_fn, jnp.asarray(diag), js,
                            jnp.ones((2,), bool))
        ts = t_pcg.pcg_step(torch.from_numpy(A), 0.3, inv_fn, torch.from_numpy(diag), ts,
                            torch.ones((2,), dtype=torch.bool))
    for name in ("W", "R", "Z", "P_", "RZ"):
        assert _rel(getattr(ts, name).numpy(), getattr(js, name)) <= 1e-10, name


@pytest.mark.parametrize("name", ["gauss_embedding", "ortho_embedding", "sparse_sign_embedding"])
def test_embeddings_take_key_first_as_jax_does(name):
    """``(key, s, d, dtype)`` positionally, the key an int seed or a
    generator (JAX: a PRNG key): JAX's shape and type; the same seed the
    same draw; the structure of JAX's embedding (orthonormal columns;
    sparse-sign ±ζ^(-1/2) entries, at most ζ = 8 a column)."""
    s, d = 12, 20
    J = np.asarray(getattr(jemb, name)(jax.random.PRNGKey(0), s, d, jnp.float64))
    T = getattr(temb, name)(5, s, d, torch.float64, "cpu")
    assert T.shape == J.shape and T.dtype == torch.float64
    assert torch.equal(T, getattr(temb, name)(key=torch.Generator().manual_seed(5), s=s, d=d,
                                              dtype=torch.float64, device="cpu"))
    if name == "ortho_embedding":
        for Q in (J, T.numpy()):
            np.testing.assert_allclose(Q.T @ Q, np.eye(Q.shape[1]), atol=1e-12)
    if name == "sparse_sign_embedding":
        for O in (J, T.numpy()):
            nz = O[O != 0]
            np.testing.assert_allclose(np.abs(nz), 8**-0.5, rtol=1e-12)
            assert ((O != 0).sum(0) <= 8).all()


# Entry points that make tensors from sizes or numpy arrays: the CUDA card by
# default, the host only where the caller names it.
_DEVICE_DEFAULTS = {
    "gauss_embedding": lambda **kw: temb.gauss_embedding(0, 4, 6, torch.float64, **kw),
    "ortho_embedding": lambda **kw: temb.ortho_embedding(0, 4, 6, torch.float64, **kw),
    "sparse_sign_embedding": lambda **kw: temb.sparse_sign_embedding(0, 4, 6, torch.float64,
                                                                     **kw),
    "srht_params": lambda **kw: temb.srht_params(torch.Generator().manual_seed(0), 4, 6,
                                                 torch.float64, **kw)[0],
    "left_embedding": lambda **kw: temb.left_embedding("gauss", torch.Generator().manual_seed(0),
                                                       4, 6, torch.float64, **kw),
    "right_embedding": lambda **kw: temb.right_embedding("ortho", torch.Generator().manual_seed(0),
                                                         4, 6, torch.float64, **kw),
    "hadamard_matrix": lambda **kw: tops.hadamard_matrix(4, torch.float64, **kw),
    "interop.pcg_state": lambda **kw: interop.pcg_state(*[np.ones(3)] * 5, True, **kw).W,
    "interop.sparse_tensor": lambda **kw: interop.sparse_tensor(
        np.ones(2), np.array([0, 1]), np.array([0, 1, 2]), (2, 2), **kw).values,
}


@pytest.mark.parametrize("name", sorted(_DEVICE_DEFAULTS))
def test_entry_points_default_to_the_card(monkeypatch, name):
    """With no ``device`` the tensors go to the CUDA card: without one the
    call raises and names ``device='cpu'``; asked for the host, it runs there."""
    make = _DEVICE_DEFAULTS[name]
    assert make(device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


@pytest.mark.parametrize("kind", ["rbf", "laplace", "matern12", "matern32", "matern52"])
def test_kernel_tile_takes_precision_as_jax_does(kind):
    """``kernel_tile(kind, Xs, Ys, precision)``: taken and ignored in the
    port (float64 here, TF32 off on a card); JAX's values at HIGHEST."""
    rng = np.random.default_rng(37)
    Xs, Ys = rng.standard_normal((7, 4)), rng.standard_normal((5, 4))
    J = j_kernel_tile(kind, jnp.asarray(Xs), jnp.asarray(Ys), jax.lax.Precision.HIGHEST)
    T = t_kernel_tile(kind, torch.from_numpy(Xs), torch.from_numpy(Ys), "highest")
    assert _rel(T.numpy(), J) <= F64_EXACT


# -- key, lengthscale_array, native_available, SAPState, the dispatch order,
# -- the distance tiles' keywords, shutdown, devices ----------------------------
@pytest.mark.parametrize("how", ["keywords", "positional"])
def test_srht_params_takes_key_as_jax_does(how):
    """``srht_params(key, s, d, dtype)``: JAX's shapes and types, signs ±1
    over p = next_pow2(d), s distinct rows below p; the same seed the same
    draw."""
    s, d = 5, 12
    if how == "keywords":
        js, jr = jemb.srht_params(key=jax.random.PRNGKey(0), s=s, d=d, dtype=jnp.float64)
        ts, tr = temb.srht_params(key=3, s=s, d=d, dtype=torch.float64, device="cpu")
    else:
        js, jr = jemb.srht_params(jax.random.PRNGKey(0), s, d, jnp.float64)
        ts, tr = temb.srht_params(3, s, d, torch.float64, "cpu")
    assert ts.shape == js.shape == (16,) and tr.shape == jr.shape == (s,)
    assert ts.dtype == torch.float64
    for signs, rows in ((np.asarray(js), np.asarray(jr)), (ts.numpy(), tr.numpy())):
        assert set(np.unique(signs)) <= {-1.0, 1.0}
        assert len(set(rows.tolist())) == s and rows.min() >= 0 and rows.max() < 16
    again = temb.srht_params(torch.Generator().manual_seed(3), s, d, torch.float64, "cpu")
    assert torch.equal(again[0], ts) and torch.equal(again[1], tr)


@pytest.mark.parametrize("sketch", ["gauss", "ortho", "sparse", "srht"])
@pytest.mark.parametrize("name", ["left_embedding", "right_embedding", "sketch_apply_left"])
def test_embedding_entry_points_take_key_as_jax_does(name, sketch):
    """``left_embedding(name, key, s, d, dtype)``, ``right_embedding`` and
    ``sketch_apply_left(name, key, s, A, dtype)`` with ``key=``: JAX's
    shape and type; ``sketch_apply_left`` is the left embedding of the same
    key times A in both packages (float64, 1e-12 of max|ref|)."""
    s, d = 6, 16
    A = np.random.default_rng(36).standard_normal((d, 5))
    jkey = jax.random.PRNGKey(1)
    if name == "sketch_apply_left":
        J = jemb.sketch_apply_left(sketch, key=jkey, s=s, A=jnp.asarray(A), dtype=jnp.float64)
        T = temb.sketch_apply_left(sketch, key=4, s=s, A=torch.from_numpy(A),
                                   dtype=torch.float64)
        jO = jemb.left_embedding(sketch, jkey, s, d, jnp.float64)
        tO = temb.left_embedding(sketch, 4, s, d, torch.float64, "cpu")
        assert _rel(J, np.asarray(jO) @ A) <= F64_EXACT
        assert _rel(T.numpy(), tO.numpy() @ A) <= F64_EXACT
    else:
        J = getattr(jemb, name)(sketch, key=jkey, s=s, d=d, dtype=jnp.float64)
        T = getattr(temb, name)(sketch, key=4, s=s, d=d, dtype=torch.float64, device="cpu")
        again = getattr(temb, name)(sketch, torch.Generator().manual_seed(4), s, d,
                                    torch.float64, "cpu")
        assert torch.equal(T, again)
    assert T.shape == J.shape and T.dtype == torch.float64


@pytest.mark.parametrize("ls", [0.7, np.array([0.5, 1.5, 2.5])], ids=["scalar", "ARD"])
def test_lengthscale_array_as_jax(monkeypatch, ls):
    """``KernelConfig.lengthscale_array(dtype)``: JAX's values and shape for
    a float and an ARD lengthscale, of the dtype asked for (a numpy dtype as
    JAX callers pass, or a torch one). A tensor lengthscale's array lies on
    its device; a float or a numpy array on the card, the host where the
    caller names it."""
    J = jk.KernelConfig(lengthscale=ls).lengthscale_array(jnp.float64)
    cfg = tk.KernelConfig(lengthscale=ls)
    for dtype in (np.float64, torch.float64):
        T = cfg.lengthscale_array(dtype, device="cpu")
        assert T.dtype == torch.float64 and T.shape == J.shape
        assert np.array_equal(T.numpy(), np.asarray(J))
    assert cfg.lengthscale_array(np.float32, device="cpu").dtype == torch.float32
    if isinstance(ls, np.ndarray):
        on = tk.KernelConfig(lengthscale=torch.from_numpy(ls)).lengthscale_array(jnp.float32)
        assert on.device.type == "cpu" and on.dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.lengthscale_array(np.float64)


def test_native_available_agrees_with_impl_native():
    """``sparse.native_available()`` in both ``__all__``s, a bool that says
    whether ``impl="native"`` runs: the port never carries the native
    kernels, so False, and its ``"native"`` raises; JAX's answer holds for
    its own ``"native"`` the same way."""
    assert "native_available" in jsp.__all__ and "native_available" in tsp.__all__
    M, v, p, c = _csr()
    x = np.ones(M.shape[1])
    for pkg, arrays in ((jsp, (jnp.asarray(v), jnp.asarray(p), jnp.asarray(c),
                               jnp.asarray(x))),
                        (tsp, (torch.from_numpy(v), torch.from_numpy(p), torch.from_numpy(c),
                               torch.from_numpy(x)))):
        available = pkg.native_available()
        assert isinstance(available, bool)
        if available:
            got = pkg.csr_matvec(*arrays, M.shape[0], "native")
            assert _rel(np.asarray(got), M @ x) <= F64_EXACT
        else:
            with pytest.raises(RuntimeError, match="native sparse kernels unavailable"):
                pkg.csr_matvec(*arrays, M.shape[0], "native")
    assert tsp.native_available() is False


def test_sap_state_has_the_jax_fields():
    """``SAPState(W, V, Y, key, t)`` positionally binds as JAX's does, and a
    solver's key has a JAX key's layout: ``PRNGKey(s)``'s two words for an
    int seed s (the streams drawn from it differ by design)."""
    assert tsolvers.SAPState._fields == jsolvers.SAPState._fields == ("W", "V", "Y", "key", "t")
    W = torch.ones((4, 1), dtype=torch.float64)
    key = torch.tensor([0, 5])
    st = tsolvers.SAPState(W, 2 * W, 3 * W, key, 7)
    assert st.key is key and st.t == 7 and torch.equal(st.Y, 3 * W)
    X = np.random.default_rng(37).standard_normal((32, 3))
    B = np.random.default_rng(38).standard_normal((32, 1))
    K = tk.RBFLinOp(torch.from_numpy(X), torch.from_numpy(X), tk.KernelConfig(lengthscale=1.0))
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.preconditioners import NewtonConfig

    sys_ = LinSys(K, torch.from_numpy(B), 0.1, K.row_oracle, K.blk_oracle)
    solver = tsolvers.SAP(sys_, torch.zeros((32, 1), dtype=torch.float64),
                          NewtonConfig(rho=0.1), blk_sz=8, accel=False, accel_config=None,
                          power_iters=3, key=5)
    assert np.array_equal(solver.state.key.numpy(), np.asarray(jax.random.PRNGKey(5)))
    solver._run_chunk(2)
    assert solver.state.t == 2 and torch.equal(solver.state.key, torch.tensor([0, 5]))


def _tier_bound(form, kind):
    """The bf16x3 tier's bound against the exact product on the ragged data:
    3x the JAX tier's own error there against float64 (``chip_smoke.py``'s
    ``JAX_TIER_ERR``, which holds K1b, K2b and K4b to the same)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return 3 * smoke.JAX_TIER_ERR[("ragged", "bf16x3", form, kind)], smoke


@pytest.mark.parametrize("kind", ["rbf", "matern32"])
def test_kernel_matmat_takes_jax_positional_order(monkeypatch, kind):
    """``kernel_matmat(kind, X1, X2, V, ls, c, impl, compute_dtype,
    symmetric)`` positionally: ``"bf16x3"`` in eighth place takes the tier
    route (parts made for the call: the plain tier product here) and meets
    the tier's bound against
    JAX's call (exact here: off the TPU JAX's XLA route takes no tier);
    None there is the exact tier, 1e-5 of JAX's (float32); ``True`` in
    ninth place is ``symmetric``, the triangle's plain version."""
    bound, smoke = _tier_bound("gen", kind)
    A1, A2, W, S = smoke.ragged_data()
    ls, c = 1.3, 0.9
    calls = []
    real = tops.kernel_plain.gram_matmat_tier
    monkeypatch.setattr(tops.kernel_plain, "gram_matmat_tier",
                        lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    J = jops.kernel_dispatch.kernel_matmat(kind, jnp.asarray(A1), jnp.asarray(A2),
                                           jnp.asarray(W), ls, c, "auto", "bf16x3")
    T = tops.kernel_dispatch.kernel_matmat(kind, torch.from_numpy(A1), torch.from_numpy(A2),
                                           torch.from_numpy(W), ls, c, "auto", "bf16x3")
    assert calls == [kind] and T.dtype == torch.float32
    assert _rel(T.numpy(), J) <= bound
    T = tops.kernel_dispatch.kernel_matmat(kind, torch.from_numpy(A1), torch.from_numpy(A2),
                                           torch.from_numpy(W), ls, c, "xla", None)
    assert len(calls) == 1 and _rel(T.numpy(), J) <= 1e-5
    X = torch.from_numpy(A1)
    Js = jops.kernel_dispatch.kernel_matmat(kind, jnp.asarray(A1), jnp.asarray(A1),
                                            jnp.asarray(S), ls, c, "auto", None, True)
    Ts = tops.kernel_dispatch.kernel_matmat(kind, X, X, torch.from_numpy(S), ls, c, "auto",
                                            None, True)
    assert _rel(Ts.numpy(), Js) <= 1e-5
    with pytest.raises(TypeError):
        tops.kernel_dispatch.kernel_matmat(kind, X, X, torch.from_numpy(S), ls, c, "auto",
                                           None, True, None)


@pytest.mark.parametrize("kind", ["rbf", "matern12"])
def test_kernel_pair_takes_jax_positional_order(monkeypatch, kind):
    """``kernel_pair(kind, X1, X2, V2, V1, ls, c, impl, compute_dtype)``
    positionally: ``"bf16x3"`` in ninth place takes the tier pair, both
    outputs within the tier's bound of JAX's call (exact off the TPU); no
    parameter past JAX's."""
    bound, smoke = _tier_bound("pair", kind)
    A1, A2, _, _ = smoke.ragged_data()
    V2, V1 = smoke.pair_ragged_rhs(3)
    calls = []
    real = tops.kernel_plain.gram_pair_tier
    monkeypatch.setattr(tops.kernel_plain, "gram_pair_tier",
                        lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    J = jops.kernel_dispatch.kernel_pair(kind, *(jnp.asarray(a) for a in (A1, A2, V2, V1)),
                                         1.3, 0.9, "auto", "bf16x3")
    T = tops.kernel_dispatch.kernel_pair(kind, *(torch.from_numpy(a) for a in (A1, A2, V2, V1)),
                                         1.3, 0.9, "auto", "bf16x3")
    assert calls == [kind]
    for t, j in zip(T, J):
        assert t.shape == j.shape and _rel(t.numpy(), j) <= bound
    with pytest.raises(TypeError):
        tops.kernel_dispatch.kernel_pair(kind, *(torch.from_numpy(a) for a in (A1, A2, V2, V1)),
                                         1.3, 0.9, "auto", None, None)
    for name in ("kernel_matmat", "kernel_pair"):
        assert (list(inspect.signature(getattr(tops.kernel_dispatch, name)).parameters)
                == list(inspect.signature(getattr(jops.kernel_dispatch, name)).parameters))


@pytest.mark.parametrize("chunk", [1, 3, 16, 64])
def test_distance_tiles_take_precision_and_chunk_as_jax_does(chunk):
    """``sqdist_tile(Xs, Ys, precision)`` and ``l1dist_tile(Xs, Ys,
    chunk)``: JAX's values (float64, 1e-12 of max|ref|) at every chunk
    width, below, at and past d = 20."""
    from rlaopt_tpu.kernels.functions import l1dist_tile as j_l1, sqdist_tile as j_sq
    from rlaopt_tpu_torch.kernels.functions import l1dist_tile as t_l1, sqdist_tile as t_sq

    rng = np.random.default_rng(39)
    Xs, Ys = rng.standard_normal((9, 20)), rng.standard_normal((7, 20))
    J = j_sq(jnp.asarray(Xs), jnp.asarray(Ys), precision=jax.lax.Precision.HIGHEST)
    T = t_sq(torch.from_numpy(Xs), torch.from_numpy(Ys), precision="highest")
    assert _rel(T.numpy(), J) <= F64_EXACT
    J = j_l1(jnp.asarray(Xs), jnp.asarray(Ys), chunk=chunk)
    T = t_l1(torch.from_numpy(Xs), torch.from_numpy(Ys), chunk=chunk)
    assert _rel(T.numpy(), J) <= F64_EXACT
    assert _rel(t_l1(torch.from_numpy(Xs), torch.from_numpy(Ys), chunk).numpy(), J) <= F64_EXACT


def test_sharded_kernel_operator_shutdown_as_jax():
    """``ShardedKernelLinOp.shutdown()``: a no-op returning None in both;
    the operator still applies JAX's product afterwards."""
    X1, X2, V2, _ = _data()
    J = _sharded("jax", "RBF", jnp.asarray(X1), jnp.asarray(X2))
    T = _sharded("torch", "RBF", torch.from_numpy(X1), torch.from_numpy(X2))
    assert J.shutdown() is None and T.shutdown() is None
    assert _rel((T @ torch.from_numpy(V2)).numpy(), J @ jnp.asarray(V2)) <= F64


def test_value64_takes_devices_as_jax_does():
    """``kernel_matmat_value64(..., devices=[...])`` spreads X1's rows over
    the devices: on two host positions the bits of ``devices=None``; JAX's
    call with its two CPU devices within its ~3e-9 contract of the port's
    float64 product; the TPU tiling knobs are not taken."""
    from rlaopt_tpu.ops.kernel_value64 import kernel_matmat_value64 as j_v64
    from rlaopt_tpu_torch.ops.kernel_value64 import kernel_matmat_value64 as t_v64

    rng = np.random.default_rng(40)
    X1 = rng.standard_normal((300, 5)).astype(np.float32)
    X2 = rng.standard_normal((280, 5)).astype(np.float32)
    V = rng.standard_normal((280, 3)).astype(np.float32)
    args = (torch.from_numpy(X1), torch.from_numpy(X2), torch.from_numpy(V), 1.6, 0.8)
    ref = t_v64(*args, kind="matern32")
    got = t_v64(*args, kind="matern32", devices=[torch.device("cpu")] * 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    jhi, jlo = j_v64(jnp.asarray(X1), jnp.asarray(X2), V, 1.6, 0.8, kind="matern32",
                     interpret=True, devices=jax.devices("cpu")[:2])
    J = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    assert _rel(got[0].double() + got[1].double(), J) <= 3e-9
    with pytest.raises(TypeError):
        t_v64(*args, kind="matern32", tile_m=64)
