"""The port's ``utils`` against the JAX package's, on the CPU: the debug
helpers' messages, ``debug_nans``, the profiler, ``annotate`` and
``trace``, the wandb mirror (a stub ``wandb`` module), the checkers and the
exported names."""

import json
import sys
import time
import types
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlaopt_tpu.utils as jutils
import rlaopt_tpu_torch.utils as tutils
from rlaopt_tpu.kernels import KernelConfig as JKernelConfig
from rlaopt_tpu.kernels import RBFLinOp as JRBFLinOp
from rlaopt_tpu.models import LinSys as JLinSys
from rlaopt_tpu.models.model import Model as JModel
from rlaopt_tpu.preconditioners import NystromConfig as JNystromConfig
from rlaopt_tpu.preconditioners import SkPreConfig as JSkPreConfig
from rlaopt_tpu.solvers import LSQRConfig as JLSQRConfig
from rlaopt_tpu.solvers import PCGConfig as JPCGConfig
from rlaopt_tpu.solvers import SAPAccelConfig as JSAPAccelConfig
from rlaopt_tpu.solvers import SAPConfig as JSAPConfig
from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
from rlaopt_tpu_torch.models import LinSys, LstSq
from rlaopt_tpu_torch.models.model import Model
from rlaopt_tpu_torch.preconditioners import NystromConfig, SkPreConfig
from rlaopt_tpu_torch.solvers import LSQRConfig, PCGConfig, SAPAccelConfig, SAPConfig
from rlaopt_tpu_torch.utils import (
    Logger,
    Profiler,
    annotate,
    assert_finite_tree,
    check_finite,
    debug_nans,
    set_wandb_api_key,
    trace,
)
from rlaopt_tpu_torch.utils import checkers as tc


class _State(NamedTuple):
    W: object
    t: object


def _trees(bad: str):
    """The same nested state as numpy arrays, with one non-finite value in
    the leaf named by ``bad`` (or none)."""
    W = np.ones((3, 2))
    m0, m1 = np.zeros(2), np.ones(1)
    if bad == "W":
        W[1, 0] = np.nan
    elif bad == "mask0":
        m0[1] = np.inf
    elif bad == "nested":
        m1[0] = -np.inf
    tree = {"state": _State(W=W, t=3), "mask": [m0, (m1,)], "none": None,
            "ints": np.arange(3)}
    return tree


# -- debug --------------------------------------------------------------------
@pytest.mark.parametrize("bad", ["W", "mask0", "nested"])
def test_assert_finite_tree_message_matches_jax(bad):
    """The same numpy tree: the same message, path as ``keystr`` writes it."""
    tree = _trees(bad)
    with pytest.raises(FloatingPointError) as jerr:
        jutils.assert_finite_tree(jax.tree_util.tree_map(jnp.asarray, tree), "S")
    with pytest.raises(FloatingPointError) as terr:
        assert_finite_tree(tree, "S")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(FloatingPointError) as terr2:
        assert_finite_tree(
            jax.tree_util.tree_map(
                lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x, tree), "S")
    assert str(terr2.value) == str(jerr.value)


def test_assert_finite_tree_passes_a_finite_tree():
    jutils.assert_finite_tree(jax.tree_util.tree_map(jnp.asarray, _trees("none")))
    assert_finite_tree(_trees("none"))
    assert_finite_tree({"i": torch.arange(3), "x": torch.ones(2)})


@pytest.mark.parametrize("value", [np.nan, np.inf, 1.0])
def test_check_finite_prints_jax_message(value, capsys):
    x = np.array([0.0, value])
    jutils.check_finite(jnp.asarray(x), "grad")
    jax.effects_barrier()
    jout = capsys.readouterr().out
    t = torch.from_numpy(x)
    assert check_finite(t, "grad") is t
    tout = capsys.readouterr().out
    assert tout == jout.replace("[rlaopt_tpu]", "[rlaopt_tpu_torch]")
    assert ("non-finite values detected in grad" in tout) is (not np.isfinite(value))


def test_debug_nans_raises_like_jax():
    """An op that makes a NaN raises FloatingPointError in both packages;
    an Inf passes in both (JAX's flag is NaN only)."""
    with jutils.debug_nans():
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.asarray([-1.0])).block_until_ready()
        jnp.log(jnp.asarray([0.0])).block_until_ready()
    with debug_nans():
        with pytest.raises(FloatingPointError, match="nan"):
            torch.log(torch.tensor([-1.0]))
        assert torch.isinf(torch.log(torch.tensor([0.0])))[0]
    assert torch.isnan(torch.log(torch.tensor([-1.0])))[0]  # off again


def test_debug_nans_skips_uninitialized_outputs(monkeypatch):
    """``empty`` and its kin are not checked: uninitialized memory may hold
    NaN bit patterns until it is written."""
    nan_empty = torch.full((4,), float("nan"))
    with debug_nans():
        for make in (lambda: torch.empty(4), lambda: torch.empty_like(nan_empty),
                     lambda: nan_empty.new_empty((4,)),
                     lambda: torch.empty_strided((2, 2), (2, 1))):
            out = make()
            out.fill_(1.0)
            assert torch.all(out == 1.0)
        with pytest.raises(FloatingPointError):
            torch.empty(4).fill_(float("nan"))


def test_debug_nans_skips_constant_sentinels():
    """A NaN the code writes as a constant is a sentinel (the port's
    ``cholesky_or_nan`` fallback): not checked until an op carries it into
    a result. Writing a NaN into a tensor raises."""
    L = torch.eye(3, dtype=torch.float64)
    with debug_nans():
        nan = torch.tensor(float("nan"), dtype=torch.float64)
        fallback = torch.full_like(L, float("nan"))
        assert torch.equal(torch.where(torch.tensor(True), L, fallback), L)
        assert torch.equal(torch.where(torch.tensor(True), L, nan), L)
        with pytest.raises(FloatingPointError):
            torch.where(torch.tensor(False), L, nan)
        V = torch.ones((4, 2))
        with pytest.raises(FloatingPointError):
            V[1, 0] = float("nan")


def test_debug_nans_nests_and_restores():
    bad = lambda: torch.sqrt(torch.tensor([-1.0]))  # noqa: E731
    with debug_nans():
        with debug_nans(False):
            assert torch.isnan(bad())[0]
            with debug_nans(True):
                with pytest.raises(FloatingPointError):
                    bad()
            assert torch.isnan(bad())[0]
        with pytest.raises(FloatingPointError):
            bad()
    assert torch.isnan(bad())[0]
    with debug_nans(False):
        assert torch.isnan(bad())[0]


def test_debug_nans_around_a_solve():
    """A healthy solve on the CPU raises nothing inside the context (the
    plain kernel versions' outputs are checked op by op)."""
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((64, 3)))
    y = torch.from_numpy(rng.standard_normal(64))
    sys_ = LinSys(RBFLinOp(X, X, KernelConfig(lengthscale=1.5)), y, 1e-2)
    cfg = PCGConfig(max_iters=5, precond_config=NystromConfig(rank=8, rho=1e-2))
    with debug_nans():
        W, _ = sys_.solve(cfg, torch.zeros((64, 1), dtype=torch.float64), key=0)
    assert torch.all(torch.isfinite(W))


# -- profiling ----------------------------------------------------------------
def test_profiler_phase_accumulation():
    """JAX's ``TestProfiler.test_phase_accumulation``, in the port."""
    for prof in (jutils.Profiler(), Profiler()):
        with prof.phase("a"):
            time.sleep(0.01)
        with prof.phase("a"):
            time.sleep(0.01)
        with prof.phase("b") as out:
            out["sync"] = {"x": [torch.ones(3) * 2], "none": None} \
                if isinstance(prof, Profiler) else jnp.ones(3) * 2
        with prof.phase("c", result=(torch.ones(2), 3)):
            pass
        s = prof.summary()
        assert s["a"]["count"] == 2 and s["a"]["total_s"] >= 0.02
        assert s["b"]["count"] == 1 and s["c"]["count"] == 1
        prof.reset()
        assert prof.summary() == {}


def test_profiler_synchronizes_cuda_leaves(monkeypatch):
    """On exit of a phase: one synchronize per CUDA device among the leaves
    of ``"sync"`` (``result`` without it), none for CPU tensors or with
    ``block=False``."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))

    class _Fake(torch.Tensor):
        pass

    a = torch.ones(2).as_subclass(_Fake)
    monkeypatch.setattr(_Fake, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_Fake, "device", property(lambda self: torch.device("cuda", 0)))
    prof = Profiler()
    with prof.phase("p", result=[a, torch.ones(1)]):
        pass
    assert calls == [torch.device("cuda", 0)]
    with prof.phase("q", result=a) as out:
        out["sync"] = torch.ones(1)
    assert len(calls) == 1
    with Profiler(block=False).phase("r", result=a):
        pass
    assert len(calls) == 1


def test_annotate_context():
    with annotate("phase-x"):
        _ = torch.ones(3) + 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("phase-y"):
            _ = torch.ones(3) * 2
    assert any(e.key == "phase-y" for e in prof.key_averages())


def test_trace_writes_a_chrome_trace(tmp_path):
    """JAX's ``test_profiler_trace``: a file under the directory; here a
    Chrome trace (Perfetto opens it) naming the annotated span, and beside it
    the program's record of spans, which holds the same span."""
    with trace(str(tmp_path / "tr"), create_perfetto_link=True):
        with annotate("rlaopt-span"):
            _ = (torch.ones(8) * 2).sum()
    files = list((tmp_path / "tr").rglob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "rlaopt-span" for e in events)
    (record,) = (tmp_path / "tr").rglob("spans_*.json")
    assert [s["name"] for s in json.loads(record.read_text())["spans"]] == ["rlaopt-span"]


# -- wandb ---------------------------------------------------------------------
def _wandb_stub(monkeypatch):
    calls = {"init": [], "log": [], "finish": 0}
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: calls["init"].append(kw)
    stub.log = lambda d, step=None: calls["log"].append((step, d))
    stub.finish = lambda: calls.__setitem__("finish", calls["finish"] + 1)
    monkeypatch.setitem(sys.modules, "wandb", stub)
    return calls


def test_logger_wandb_plumbing(monkeypatch):
    """JAX's ``TestLoggerWandb.test_wandb_plumbing``, in the port."""
    calls = _wandb_stub(monkeypatch)
    lg = Logger(log_freq=2, log_fn=lambda w: {"m": 1},
                wandb_kwargs={"project": "p", "config": {"a": 1}})
    assert calls["init"][0]["project"] == "p"
    assert lg._compute_log(1, torch.zeros(())) is None
    lg._compute_log(2, torch.zeros(()))
    assert calls["log"][0][0] == 2 and calls["log"][0][1]["metrics"] == {"m": 1}
    lg._terminate()
    assert calls["finish"] == 1
    plain = Logger(log_freq=2, log_fn=lambda w: {})
    plain._compute_log(2, torch.zeros(()))
    plain._terminate()
    assert len(calls["log"]) == 1 and calls["finish"] == 1


def _config_pairs():
    return {
        "pcg": (JPCGConfig(precond_config=JNystromConfig(rank=10, rho=1e-3)),
                PCGConfig(precond_config=NystromConfig(rank=10, rho=1e-3))),
        "sap": (JSAPConfig(blk_sz=8, precond_config=JNystromConfig(rank=4, rho=1e-3),
                           accel_config=JSAPAccelConfig(mu=0.1, nu=2.0)),
                SAPConfig(blk_sz=8, precond_config=NystromConfig(rank=4, rho=1e-3),
                          accel_config=SAPAccelConfig(mu=0.1, nu=2.0))),
        "lsqr": (JLSQRConfig(precond_config=JSkPreConfig(sketch_size=8, rho=0.0)),
                 LSQRConfig(precond_config=SkPreConfig(sketch_size=8, rho=0.0))),
    }


@pytest.mark.parametrize("user", [None, {"project": "p", "tags": ["x"]},
                                  {"config": {"callback_freq": 7, "extra": 1}, "name": "n"}])
@pytest.mark.parametrize("solver", ["pcg", "sap", "lsqr"])
def test_get_wandb_kwargs_matches_jax(solver, user):
    jcfg, tcfg = _config_pairs()[solver]
    args = dict(log_in_wandb=True, wandb_init_kwargs=user, solver_name=solver,
                callback_freq=5)
    with _maybe_warns(user):
        ref = JModel._get_wandb_kwargs(None, solver_config=jcfg, **args)
    with _maybe_warns(user):
        got = Model._get_wandb_kwargs(None, solver_config=tcfg, **args)
    assert got == ref
    assert got["config"]["solver_name"] == solver
    assert Model._get_wandb_kwargs(None, **{**args, "log_in_wandb": False},
                                   solver_config=tcfg) is None


def _maybe_warns(user):
    import contextlib

    if user and "config" in user:
        return pytest.warns(UserWarning, match="config")
    return contextlib.nullcontext()


def _krr(n=48, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)), rng.standard_normal(n)


def test_linsys_mirrors_to_wandb_as_jax(monkeypatch):
    """One PCG solve in each package with the stub: the same ``init``
    keywords, rounds logged at the same steps, one ``finish``."""
    X, y = _krr()
    seen = {}
    for pkg in ("jax", "torch"):
        calls = _wandb_stub(monkeypatch)
        if pkg == "jax":
            Xj = jnp.asarray(X)
            sys_ = JLinSys(JRBFLinOp(Xj, Xj, JKernelConfig(lengthscale=1.5)), jnp.asarray(y), 1e-2)
            cfg = JPCGConfig(max_iters=6, rtol=1e-14,
                             precond_config=JNystromConfig(rank=8, rho=1e-2))
            W0 = jnp.zeros((48, 1))
        else:
            Xt = torch.from_numpy(X)
            sys_ = LinSys(RBFLinOp(Xt, Xt, KernelConfig(lengthscale=1.5)), torch.from_numpy(y),
                          1e-2)
            cfg = PCGConfig(max_iters=6, rtol=1e-14, precond_config=NystromConfig(rank=8, rho=1e-2))
            W0 = torch.zeros((48, 1), dtype=torch.float64)
        sys_.solve(cfg, W0, callback_freq=2, key=0, log_in_wandb=True,
                   wandb_init_kwargs={"project": "krr", "mode": "offline"})
        seen[pkg] = calls
    assert seen["torch"]["init"] == seen["jax"]["init"]
    assert [s for s, _ in seen["torch"]["log"]] == [s for s, _ in seen["jax"]["log"]]
    assert seen["torch"]["finish"] == seen["jax"]["finish"] == 1


def test_lstsq_mirrors_to_wandb(monkeypatch):
    calls = _wandb_stub(monkeypatch)
    rng = np.random.default_rng(1)
    A = torch.from_numpy(rng.standard_normal((40, 6)))
    b = torch.from_numpy(rng.standard_normal(40))
    cfg = LSQRConfig(max_iters=4, rtol=1e-14, precond_config=SkPreConfig(sketch_size=24, rho=0.0))
    LstSq(A, b).solve(cfg, torch.zeros((6, 1), dtype=torch.float64), callback_freq=2, key=0,
                      log_in_wandb=True, wandb_init_kwargs={"project": "ls"})
    assert calls["init"][0]["config"]["solver_name"] == "lsqr"
    assert calls["init"][0]["project"] == "ls"
    assert [s for s, _ in calls["log"]] == [0, 2, 4] and calls["finish"] == 1
    with pytest.raises(ValueError, match="wandb_init_kwargs"):
        LstSq(A, b).solve(cfg, torch.zeros((6, 1), dtype=torch.float64), log_in_wandb=True)


def test_set_wandb_api_key(monkeypatch):
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    set_wandb_api_key("k-123")
    import os

    assert os.environ["WANDB_API_KEY"] == "k-123"


# -- checkers -------------------------------------------------------------------
@pytest.mark.parametrize("name,good,bad", [
    ("_is_dict", {"a": 1}, [1]),
    ("_is_list", [1], (1,)),
    ("_is_set", {1}, [1]),
])
def test_container_checkers_match_jax(name, good, bad):
    getattr(tc, name)(good, "p")
    getattr(jutils, name)(good, "p")
    with pytest.raises(TypeError) as terr:
        getattr(tc, name)(bad, "p")
    with pytest.raises(TypeError) as jerr:
        getattr(jutils, name)(bad, "p")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("tdt,jdt,err", [
    (torch.float32, jnp.float32, None),
    (torch.float64, jnp.float64, None),
    (torch.float16, jnp.float16, ValueError),
    (torch.int32, jnp.int32, ValueError),
])
def test_dtype_checkers_match_jax(tdt, jdt, err):
    tc._is_dtype(tdt, "dtype")
    if err is None:
        tc._is_dtype_f32_f64(tdt, "dtype")
        jutils._is_dtype_f32_f64(jdt, "dtype")
    else:
        with pytest.raises(err) as terr:
            tc._is_dtype_f32_f64(tdt, "dtype")
        with pytest.raises(err) as jerr:
            jutils._is_dtype_f32_f64(jdt, "dtype")
        assert str(terr.value).split("(got")[0] == str(jerr.value).split("(got")[0]


def test_is_dtype_refuses_a_non_dtype():
    with pytest.raises(TypeError, match="torch.dtype"):
        tc._is_dtype("float32", "dtype")
    with pytest.raises(TypeError):
        tc._is_dtype_f32_f64(3, "dtype")


# -- exports --------------------------------------------------------------------
# JAX's key and array helpers and their counterparts in the port.
EXPORT_MAP = {
    "_is_array": "_is_tensor",
    "_is_array_1d_2d": "_is_tensor_1d_2d",
    "_is_key": "_is_generator",
    "_as_key": "_as_generator",
    "next_key": "next_generator",
}


@pytest.mark.parametrize("jname", jutils.__all__)
def test_utils_exports_every_jax_name(jname):
    tname = EXPORT_MAP.get(jname, jname)
    assert tname in tutils.__all__
    assert callable(getattr(tutils, tname))


def test_utils_all_is_built_from_its_modules():
    mods = (tutils.checkers, tutils.logger, tutils.rng, tutils.wandb_, tutils.profiling,
            tutils.checkpoint, tutils.debug, tutils.linalg)
    assert tutils.__all__ == [n for m in mods for n in m.__all__]
    assert len(set(tutils.__all__)) == len(tutils.__all__)
