"""The ceiling probes (TPU kernels #10–#13) against the JAX package's probe
bodies, on the CPU.

On a CPU tensor each probe of :mod:`rlaopt_tpu_torch.ops.probes` runs its
plain version, which the card's kernels (``csrc/probes.cu``) are held to in
``chip_smoke.py`` and ``tests/test_torch_cuda.py``. Here the plain versions
are held to the Pallas bodies of ``benchmarks/vpu_probe_study.py``
(``_body_bcast``, the body of #10 and #12's broadcast probe, and
``_body_elem``) and ``benchmarks/exp_probe_study.py`` (``_body``), run in
interpret mode on small tiles from the same numpy inputs. The body of #11
(``bench.py::_make_vmem_chain_probe``) is a closure that no module exposes,
so its plain version is held to a numpy statement of that body, quoted from
the JAX source.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rlaopt_tpu_torch.ops import probes

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "benchmarks"))
import exp_probe_study  # noqa: E402
import vpu_probe_study  # noqa: E402


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _chain_call(body, tm, tn, grid):
    """The probe studies' pallas_call of an elementwise body, in interpret
    mode: (grid * tm, tn) operands in (tm, tn) blocks."""
    spec = pl.BlockSpec((tm, tn), lambda b: (b, 0))
    return pl.pallas_call(
        body, grid=(grid,), in_specs=[spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((grid * tm, tn), jnp.float32), interpret=True,
    )


@pytest.mark.parametrize("nb,tm,tn,fb", [(3, 16, 128, 8), (2, 8, 256, 4), (1, 24, 128, 12)])
def test_l1_matches_the_bcast_body(nb, tm, tn, fb):
    """#10 and #12's broadcast probe: the plain L1 matrix summed over nb
    feature blocks against ``_body_bcast`` (the body ``make_vpu_peak``
    inlines), same float32 order: bit for bit."""
    X, Y = _normal(nb + fb, nb, tm, fb), _normal(tm + tn, nb, fb, tn)
    call = pl.pallas_call(
        functools.partial(vpu_probe_study._body_bcast, nb=nb, fb=fb), grid=(nb,),
        in_specs=[pl.BlockSpec((1, tm, fb), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, fb, tn), lambda b: (b, 0, 0))],
        out_specs=pl.BlockSpec((tm, tn), lambda b: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((tm, tn), jnp.float32),
        scratch_shapes=[pltpu.VMEM((tm, tn), jnp.float32)], interpret=True,
    )
    want = np.asarray(call(X, Y))
    got = probes.probe_l1(torch.from_numpy(X), torch.from_numpy(Y))
    assert got.dtype == torch.float32 and got.shape == (tm, tn)
    np.testing.assert_array_equal(got.numpy(), want)


def test_l1_instances_are_independent():
    """A leading axis holds independent instances: each is the probe of its
    own operands (the card runs many at once to fill its SMs)."""
    X, Y = _normal(1, 3, 2, 16, 8), _normal(2, 3, 2, 8, 32)
    got = probes.probe_l1(torch.from_numpy(X), torch.from_numpy(Y))
    for i in range(3):
        one = probes.probe_l1(torch.from_numpy(X[i]), torch.from_numpy(Y[i]))
        assert torch.equal(got[i], one)


@pytest.mark.parametrize("tm,tn,grid", [(16, 128, 2), (8, 256, 3)])
def test_elem_matches_its_body(tm, tn, grid):
    """#12's elementwise probe, ``acc = |acc − x| + y`` 64 times from acc =
    y, against ``_body_elem`` at the port's 64 reps: bit for bit."""
    X, Y = _normal(3, grid * tm, tn), _normal(4, grid * tm, tn)
    call = _chain_call(functools.partial(vpu_probe_study._body_elem, reps=probes.REPS),
                       tm, tn, grid)
    want = np.asarray(call(X, Y))
    got = probes.probe_elem(torch.from_numpy(X), torch.from_numpy(Y))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tm,tn,grid", [(16, 128, 2), (8, 256, 3)])
def test_exp_chain_matches_its_body(tm, tn, grid):
    """#13, ``acc = exp(−|acc − x|)`` 64 times from acc = y, against
    ``exp_probe_study._body`` with the native exp: the two exps differ in
    their last bit now and then, and a step's derivative is at most 1 in
    size, so 64 steps stay within 1e-6 (absolute; values in (0, 1])."""
    X, Y = _normal(5, grid * tm, tn), _normal(6, grid * tm, tn)
    call = _chain_call(
        functools.partial(exp_probe_study._body, reps=probes.REPS, expfn=jnp.exp), tm, tn, grid)
    want = np.asarray(call(X, Y))
    got = probes.probe_exp_chain(torch.from_numpy(X), torch.from_numpy(Y)).numpy()
    assert np.abs(got - want).max() <= 1e-6


def _vmem_chain_body(x, y, step):
    """``bench.py::_make_vmem_chain_probe``'s body, in numpy, as the JAX
    source states it (reps = 64)::

        acc = jnp.zeros_like(x)
        for r in range(reps):
            acc = acc + body_step(x, y, 0.25 + 0.01 * r)

    with ``make_exp_peak``'s step ``jnp.exp(x * (-c))`` and
    ``make_epilogue_bound``'s ``t = x - y; k = jnp.exp(t - c); return k *
    y``, float32 throughout (the Python constant takes the array's type)."""
    acc = np.zeros_like(x)
    for r in range(64):
        c = np.float32(0.25 + 0.01 * r)
        if step == "exp":
            acc = acc + np.exp(x * (-c))
        else:
            t = x - y
            acc = acc + np.exp(t - c) * y
    return acc


@pytest.mark.parametrize("step", ["exp", "epilogue"])
def test_vmem_chain_matches_its_body(step):
    """#11 on uniform operands in [0, 1), as the TPU probe draws them:
    numpy's and PyTorch's float32 exp may differ in the last bit, so the
    64-term sums agree to 1e-6 of their size."""
    rng = np.random.default_rng(7)
    X = rng.random((64, 128), dtype=np.float32)
    Y = rng.random((64, 128), dtype=np.float32)
    want = _vmem_chain_body(X, Y, step)
    got = probes.probe_vmem_chain(torch.from_numpy(X), torch.from_numpy(Y), step).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_events_are_the_tpu_probes_counts():
    """Each probe's events a call, by the TPU probe's own count: #12's and
    #13's factories return their count times the chain; #10's (``bench.py``,
    not imported here: it reconfigures JAX's compilation cache at import)
    returns ``tile_m * tile_n * fb * nb`` and #11's ``tile_m * tile_n * reps
    * grid`` (times 1.0 events an element and rep)."""
    spec = probes.SPECS["bcast_256x256"]
    _, pairs = vpu_probe_study.probe_pallas_bcast(tile_m=8, tile_n=128, fb=8, nb=2, chain=3)
    assert pairs == 3 * probes.events(dict(spec, tm=8, tn=128, fb=8, nb=2))
    _, pairs = vpu_probe_study.probe_pallas_elem(tile_m=8, tile_n=128, reps=64, grid=2, chain=5)
    assert pairs == 5 * probes.events(dict(probes.SPECS["elem_256x256"], tm=8, tn=128, grid=2))
    _, n_exp = exp_probe_study.probe(jnp.exp, tile_m=8, tile_n=128, reps=64, grid=2, chain=2,
                                     interpret=True)
    assert n_exp == 2 * probes.events(dict(probes.SPECS["exp_chain_512x1024"], tm=8, tn=128,
                                           grid=2))
    assert probes.events(probes.SPECS["vpu_peak"]) == 512 * 1024 * 64 * 16
    assert probes.events(probes.SPECS["exp_peak"], 3) == 3 * 512 * 1024 * 64 * 8
    assert {s["number"] for s in probes.SPECS.values()} == {10, 11, 12, 13}


def test_probes_refuse_what_they_cannot_take():
    X = torch.zeros((2, 8, 4))
    with pytest.raises(ValueError):
        probes.probe_l1(X, torch.zeros((2, 5, 16)))
    with pytest.raises(NotImplementedError):
        probes.probe_elem(X.half(), X.half())
    with pytest.raises(ValueError):
        probes.probe_vmem_chain(X, X, "sqrt")
    with pytest.raises(ValueError):
        probes.probe_exp_chain(X, X[:1])


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


def test_probe_bounds():
    """``chip_smoke.probe_bound_ms``: the L1 probe's pairs at two float32
    operations each over the data sheet's 67 TFLOP/s (half the FP32 pipes'
    instruction rate for two unfused FADDs; float64 over 34), the exp probes' exp
    on the SFU, the elementwise chain by its 12 bytes an element."""
    spec = probes.SPECS["vpu_peak"]
    ms, by = SMOKE.probe_bound_ms(spec, 33)
    assert by == "operations"
    assert ms == pytest.approx(2 * probes.events(spec, 33) / SMOKE.PEAK["fp32"] * 1e3)
    ms, _ = SMOKE.probe_bound_ms(spec, 17, "float64")
    assert ms == pytest.approx(2 * probes.events(spec, 17) / SMOKE.PEAK["fp64"] * 1e3)
    spec = probes.SPECS["exp_peak"]
    ms, by = SMOKE.probe_bound_ms(spec)
    assert by == "operations" and ms == pytest.approx(probes.events(spec) / SMOKE.PEAK["sfu"] * 1e3)
    spec = probes.SPECS["elem_512x1024"]
    ms, by = SMOKE.probe_bound_ms(spec)
    assert by == "bytes"
    assert ms == pytest.approx(12 * 8 * 512 * 1024 / SMOKE.HBM_BYTES_PER_S * 1e3)
    assert set(SMOKE.PROBES) == {"probe_l1", "probe_elem", "probe_exp_chain", "probe_vmem_chain"}
    assert {n for _, names in SMOKE.PROBES.values() for n in names} == set(probes.SPECS)


@pytest.mark.parametrize("name,instances", [
    ("vpu_peak", 33), ("bcast_512x1024", 33), ("bcast_256x1024", 33), ("bcast_256x256", 132)])
def test_probe_instances_fill_whole_rounds(name, instances):
    """``chip_smoke.probe_instances`` on an H100 (132 SMs, one probe block
    an SM): four or more whole rounds of the card's blocks, the fewest
    instances that give them."""
    spec = probes.SPECS[name]
    assert SMOKE.probe_instances(spec, 132) == instances
    blocks = instances * spec["tm"] // 128 * spec["tn"] // 128
    assert blocks % 132 == 0 and blocks >= 4 * 132


@pytest.mark.parametrize("name,group", [
    ("laplace_forward<1>(float const*, float const*, float const*, float*, float*, int, int, "
     "int, int, int, int, int, double)", "gram_matmat"),
    ("laplace_forward<16>(float const*)", "gram_matmat"),
    ("gram_comp_symmetric<4, 1>(double const*, float const*, double*, int, int, int, int, int)",
     "gram_matvec_symmetric_comp"),
    ("gram_wide_tf32<4, 8, 4>(float const*, float const*, float4 const*)", "gram_matmat"),
    ("probe_l1<float>(float const*, float const*, float*, int, int, int, int)", "probe_l1"),
    ("probe_chain<2>(float const*, float const*, float*, unsigned long)", "probe_chain"),
])
def test_profile_groups_of_this_slices_kernels(name, group):
    """``chip_smoke.py`` groups K3's tile (under the names of earlier builds
    too), the triangle K3c and the probes by name in a profile, K3 with
    the wrapper of every family (past 16 columns the 3xTF32 wide kernel)."""
    assert SMOKE._kernel_group("void (anonymous namespace)::" + name) == group


def test_ceiling_shares_read_each_laplace_row():
    """``chip_smoke.ceiling_shares``: a Laplace row's measured ceiling is
    its pairs (n·m·d; n²/2·d on a triangle) over the L1 probe's rate, the
    float64 probe's for the compensated kernels, and its pipe time the
    same pairs over the FP32 (FP64) pipes' pair rate; other families are
    skipped."""
    rates = {"vpu_peak float32": 1e13, "vpu_peak float64": 5e12}
    pipes = {"float32": 1.6e13, "float64": 8e12}
    t = {"gram_matmat": [SMOKE.timing_entry("gram_matmat", "a", 50.0, None,
                                            10_000, 1_000_000, 50, 1, "laplace")],
         "gram_matvec_symmetric_comp": [
             SMOKE.timing_entry("gram_matvec_symmetric_comp", "b", 40.0, None, 100_000, 100_000,
                                28, 1, "laplace"),
             SMOKE.timing_entry("gram_matvec_symmetric_comp", "c", 40.0, None, 100_000, 100_000,
                                28, 1, "rbf")]}
    SMOKE.ceiling_shares(t, rates, pipes)
    assert t["gram_matmat"][0]["ceiling_ms"] == pytest.approx(1e4 * 1e6 * 50 / 1e13 * 1e3)
    assert t["gram_matmat"][0]["pipe_ms"] == pytest.approx(1e4 * 1e6 * 50 / 1.6e13 * 1e3)
    tri = t["gram_matvec_symmetric_comp"]
    assert tri[0]["ceiling_ms"] == pytest.approx(1e10 / 2 * 28 / 5e12 * 1e3)
    assert tri[0]["pipe_ms"] == pytest.approx(1e10 / 2 * 28 / 8e12 * 1e3)
    assert "ceiling_ms" not in tri[1] and "pipe_ms" not in tri[1]
