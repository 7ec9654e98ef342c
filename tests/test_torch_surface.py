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
* ``solvers._get_solver_name``: the same name for every config class.
"""

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
        tops.hadamard_matrix(p, dtype=torch.float64).numpy(),
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
