"""The program's spans and counters (``rlaopt_tpu_torch.utils.profiling``)
over a solve: on while a ``torch.profiler`` profile records, nested with
one solve id per outer solve, closed by an exception, absent (and no
``record_function`` entered) with no profile, written beside the Chrome
trace by ``utils.trace``, and a sync span at every host read that waits for
the card. One test, marked ``cuda``, runs a solve on a card under
``torch.cuda.set_sync_debug_mode("warn")``: every synchronizing operation
PyTorch reports must fall inside an ``rlaopt.sync.*`` span. This file
imports no JAX:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -q
"""

import json
import traceback
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
from rlaopt_tpu_torch.linops import aslinop
from rlaopt_tpu_torch.models import LinSys
from rlaopt_tpu_torch.preconditioners import NewtonConfig, Nystrom, NystromConfig
from rlaopt_tpu_torch.solvers import SAP, PCGConfig, SAPAccelConfig, SAPConfig
from rlaopt_tpu_torch.utils import profiling, trace

N, D, RANK = 512, 8, 32
REG = 1e-4 * N


def _system(device="cpu", n=N, k=1):
    g = torch.Generator().manual_seed(0)
    X = torch.randn((n, D), generator=g).to(device)
    y = torch.tanh(X @ torch.randn(D, generator=g).to(device))[:, None]
    y = y + 0.1 * torch.randn((n, k), generator=g).to(device)
    K = RBFLinOp(X, X, KernelConfig(lengthscale=D**0.5))
    return K, LinSys(K, y, REG)


def _cfg(iters, rtol=1e-7):
    return PCGConfig(max_iters=iters, rtol=rtol,
                     precond_config=NystromConfig(rank=RANK, rho=REG))


def _solve(system, cfg, **kw):
    W0 = torch.zeros_like(system.B)
    return system.solve(cfg, W0, key=0, **kw)


@pytest.fixture(autouse=True)
def _clean_record():
    profiling.reset()
    yield
    profiling.reset()
    assert profiling._stack() == []


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.spans()


def _check_nesting(spans):
    """Every parent is in the record, opened before and closed after its
    child, and of the child's solve."""
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["parent"] is None:
            continue
        p = by_id[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        assert s["solve"] == p["solve"]
    return by_id


def test_spans_nest_in_one_solve_correction_solves_included():
    """A refined CPU solve with a callback: the outer ``rlaopt.linsys.solve``
    is its own solve id and every span inside carries it, the correction
    solves' too; each layer's span sits under the one that calls it."""
    _, system = _system()
    seen = []
    (_, log), spans = _traced(lambda: _solve(
        system, _cfg(40), callback_fn=lambda W, m: seen.append(W.shape), callback_freq=10,
        f64_refine_rounds=2, f64_refine_device="accel"))
    by_id = _check_nesting(spans)
    names = {s["name"] for s in spans}
    outer = [s for s in spans if s["name"] == "rlaopt.linsys.solve" and s["parent"] is None]
    assert len(outer) == 1 and outer[0]["solve"] == outer[0]["id"]
    assert {s["solve"] for s in spans} == {outer[0]["id"]}
    assert not any(s["error"] for s in spans)

    def parents(name):
        return {by_id[s["parent"]]["name"] for s in spans
                if s["name"] == name and s["parent"] is not None}

    inner = [s for s in spans if s["name"] == "rlaopt.linsys.solve" and s["parent"] is not None]
    assert inner and parents("rlaopt.linsys.solve") == {"rlaopt.refine.correction"}
    assert len(inner) == len(log["f64_refine"]["phase_walls"]["correction_solve"])
    assert parents("rlaopt.linsys.init") == {"rlaopt.linsys.solve"}
    assert parents("rlaopt.nystrom.build") == {"rlaopt.linsys.init"}
    assert parents("rlaopt.model.chunk") == {"rlaopt.linsys.solve"}
    assert parents("rlaopt.model.boundary") == {"rlaopt.linsys.solve"}
    assert parents("rlaopt.pcg.step") == {"rlaopt.model.chunk"}
    assert parents("rlaopt.linsys.metrics") == {"rlaopt.model.boundary"}
    assert parents("rlaopt.linop.matmat_compensated") == {"rlaopt.linsys.metrics"}
    assert parents("rlaopt.refine") == {"rlaopt.linsys.solve"}
    assert parents("rlaopt.refine.residual") == {"rlaopt.refine"}
    assert parents("rlaopt.refine.correction") == {"rlaopt.refine"}
    assert parents("rlaopt.linop.matmat_f64") == {"rlaopt.refine.residual"}
    assert "rlaopt.pcg.step" in parents("rlaopt.linop.matmat")
    assert "rlaopt.pcg.step" in parents("rlaopt.nystrom.apply")
    assert parents("rlaopt.sync.safe_solve") == {"rlaopt.pcg.step"}
    assert {"rlaopt.sync.is_zero", "rlaopt.sync.breakdown", "rlaopt.sync.termination",
            "rlaopt.sync.refine"} <= names
    # one boundary a logging round (iteration 0 included) of every solve
    bounds = [s for s in spans if s["name"] == "rlaopt.model.boundary"]
    solves = [s for s in spans if s["name"] == "rlaopt.linsys.solve"]
    chunks = [s for s in spans if s["name"] == "rlaopt.model.chunk"]
    assert len(bounds) == len(chunks) + len(solves)
    assert len(seen) == sum(1 for k in log if k != "f64_refine")
    walls = log["f64_refine"]["phase_walls"]
    assert sum(s["name"] == "rlaopt.refine.residual" for s in spans) == len(walls["residual_f64"])
    # the summary counts every span; self time is the span's less its children's
    summary = profiling.summary()
    for name in names:
        mine = [s for s in spans if s["name"] == name]
        assert summary[name]["calls"] == len(mine)
        total = sum(s["end_ns"] - s["start_ns"] for s in mine)
        kids = sum(s["end_ns"] - s["start_ns"] for s in spans
                   if s["parent"] is not None and by_id[s["parent"]]["name"] == name)
        assert summary[name]["total_s"] == pytest.approx(total / 1e9)
        assert summary[name]["self_s"] == pytest.approx((total - kids) / 1e9)
    assert profiling.counters()["rlaopt.metrics.true"] == len(bounds)


class _Stop(Exception):
    pass


def test_an_exception_from_a_callback_closes_every_span():
    """A callback that raises at the second boundary: every open span closes
    (marked ``error``), none stays open, and the record still nests."""
    _, system = _system()
    calls = []

    def callback(W, model):
        calls.append(1)
        if len(calls) == 2:
            raise _Stop

    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(_Stop):
            _solve(system, _cfg(40), callback_fn=callback, callback_freq=10)
        assert profiling._stack() == []
    spans = profiling.spans()
    _check_nesting(spans)
    failed = {s["name"] for s in spans if s["error"]}
    assert failed == {"rlaopt.linsys.solve", "rlaopt.model.boundary"}
    assert sum(s["name"] == "rlaopt.model.boundary" for s in spans) == 2
    assert sum(s["name"] == "rlaopt.pcg.step" for s in spans) == 10


def test_without_a_profiler_a_solve_records_nothing(monkeypatch):
    """No profile: no span, no counter, and ``record_function`` never
    entered; the span of the off path is one shared object."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _, system = _system()
    _solve(system, _cfg(20), callback_freq=10, f64_refine_rounds=1, f64_refine_device="accel")
    assert entered == [] and profiling.spans() == [] and profiling.counters() == {}
    assert profiling.annotate("a") is profiling.annotate_sync("b", system.B)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("rlaopt.test"):
            pass
    assert entered == ["rlaopt.test"]


def test_trace_writes_the_spans_beside_the_chrome_trace(tmp_path):
    """``utils.trace``: the record starts empty, and on exit
    ``spans_<pid>_<ns>.json`` (spans, counters, summary) lies beside the
    Chrome trace, which holds the ``rlaopt.*`` ranges."""
    _, system = _system()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("rlaopt.before"):
            pass
    with trace(str(tmp_path)):
        _solve(system, _cfg(20), callback_freq=10)
    (chrome,) = tmp_path.glob("trace_*.json")
    (record,) = tmp_path.glob("spans_*.json")
    assert chrome.name[len("trace_"):] == record.name[len("spans_"):]
    rec = json.loads(record.read_text())
    names = {s["name"] for s in rec["spans"]}
    assert "rlaopt.before" not in names
    assert {"rlaopt.linsys.solve", "rlaopt.pcg.step", "rlaopt.model.boundary"} <= names
    assert rec["dropped"] == 0 and rec["counters"]["rlaopt.metrics.true"] == 3
    assert rec["summary"]["rlaopt.pcg.step"]["calls"] == 20
    ranges = {e.get("name") for e in json.loads(chrome.read_text())["traceEvents"]}
    assert names <= ranges


def test_pcg_passes_the_safe_solve_site_twice_a_step():
    """s PCG steps pass ``_safe_solve`` 2s times (α and β), each recorded
    as a sync of the tensor's device type, here ``cpu``."""
    _, system = _system()
    steps = 25
    _, spans = _traced(lambda: _solve(system, _cfg(steps, rtol=1e-12), callback_freq=10))
    safe = [s for s in spans if s["name"] == "rlaopt.sync.safe_solve"]
    assert sum(s["name"] == "rlaopt.pcg.step" for s in spans) == steps
    assert len(safe) == 2 * steps and {s["device"] for s in safe} == {"cpu"}


def test_recurrence_metrics_are_counted():
    """With recurrence metrics every boundary's source is counted: an
    estimate reported, or a true residual that confirms a claim."""
    _, system = _system()
    _traced(lambda: _solve(system, _cfg(60, rtol=1e-4), callback_freq=5, metrics="recurrence"))
    c = profiling.counters()
    assert c["rlaopt.metrics.recurrence"] >= 1 and c["rlaopt.metrics.confirm"] >= 1
    # a true residual each confirm, and the one replacing the last estimate if any
    assert c["rlaopt.metrics.true"] >= c["rlaopt.metrics.confirm"]


def test_the_raw_spans_are_capped_and_the_summary_stays_exact(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with profiling.annotate("rlaopt.a"):
                profiling.count("rlaopt.n", 2)
                profiling.add_ns("rlaopt.t", 7)
    assert len(profiling.spans()) == 3 and profiling.dropped() == 2
    assert profiling.summary()["rlaopt.a"]["calls"] == 5
    assert profiling.counters() == {"rlaopt.n": 10, "rlaopt.t": 35}


# -- SAP -----------------------------------------------------------------------

SAP_PHASES = ("rlaopt.sap.precond", "rlaopt.sap.stepsize", "rlaopt.sap.row_oracle",
              "rlaopt.sap.update")


def _sap_system(device="cpu", n=N, k=2):
    g = torch.Generator().manual_seed(1)
    X = torch.randn((n, D), generator=g).to(device)
    y = torch.randn((n, k), generator=g).to(device)
    K = RBFLinOp(X, X, KernelConfig(lengthscale=D**0.5))
    return LinSys(K, y, REG, A_row_oracle=K.row_oracle, A_blk_oracle=K.blk_oracle)


def _sap_cfg(iters, **kw):
    return SAPConfig(max_iters=iters, rtol=1e-9, blk_sz=64, power_iters=4, accel=True,
                     accel_config=SAPAccelConfig(mu=1e-3, nu=N / 64),
                     precond_config=NystromConfig(rank=8, rho=REG), **kw)


def test_sap_records_each_phase_once_a_step_the_block_uploads_and_both_counters():
    """Ten accelerated SAP steps in chunks of 5 with host-drawn blocks and
    sampled metrics: one ``rlaopt.sap.step`` a step under the model's chunk,
    each phase once inside every step, the row oracle's one operator apply
    inside its span, one ``rlaopt.sync.sap_blocks`` (the CPU's) a chunk,
    and the counters: 10 steps, no degenerate block."""
    system = _sap_system()
    steps = 10
    _, spans = _traced(lambda: _solve(system, _sap_cfg(steps, sampling="host"),
                                      callback_freq=5, metrics="sampled"))
    by_id = _check_nesting(spans)
    step = [s for s in spans if s["name"] == "rlaopt.sap.step"]
    assert len(step) == steps
    assert {by_id[s["parent"]]["name"] for s in step} == {"rlaopt.model.chunk"}
    for name in SAP_PHASES:
        mine = [s for s in spans if s["name"] == name]
        assert sorted(s["parent"] for s in mine) == sorted(s["id"] for s in step), name
    oracle = {s["id"] for s in spans if s["name"] == "rlaopt.sap.row_oracle"}
    applies = [s for s in spans if s["name"] == "rlaopt.linop.matmat" and s["parent"] in oracle]
    assert sorted(s["parent"] for s in applies) == sorted(oracle)
    uploads = [s for s in spans if s["name"] == "rlaopt.sync.sap_blocks"]
    assert len(uploads) == steps // 5 and {s["device"] for s in uploads} == {"cpu"}
    assert {by_id[s["parent"]]["name"] for s in uploads} == {"rlaopt.model.chunk"}
    assert all(s["device_ms"] is None for s in spans)  # no card: no device time
    c = profiling.counters()
    assert c["rlaopt.sap.steps"] == steps and c["rlaopt.sap.degenerate_blocks"] == 0
    # boundaries 0, 5 and 10; the last one's estimate is then replaced by a true residual
    assert c["rlaopt.metrics.sampled"] == 3 and c["rlaopt.metrics.true"] == 1


def test_sap_counts_a_degenerate_block():
    """The skip path of ``test_torch_sap.py::test_degenerate_block_is_skipped_not_fatal``
    (Newton at rho 0 on an indefinite first block): one degenerate block in
    two steps, counted on the tensor and read with the counters."""
    n, blk_sz = 40, 10
    rng = torch.Generator().manual_seed(6)
    G = torch.randn((n, n), generator=rng, dtype=torch.float64)
    A = G @ G.T / n + torch.eye(n, dtype=torch.float64)
    A[0, 0] = -1.0
    system = LinSys(A, torch.randn((n, 1), generator=rng, dtype=torch.float64), 0.0,
                    lambda blk: aslinop(A[blk, :]), lambda blk: aslinop(A[blk][:, blk]))
    sched = torch.stack([torch.arange(0, 10), torch.arange(10, 20)])
    solver = SAP(system, torch.zeros((n, 1), dtype=torch.float64), NewtonConfig(rho=0.0),
                 blk_sz=blk_sz, accel=False, accel_config=None, power_iters=5,
                 _block_schedule=sched)
    with profile(activities=[ProfilerActivity.CPU]):
        solver._run_chunk(2)
    assert profiling.counters() == {"rlaopt.sap.steps": 2, "rlaopt.sap.degenerate_blocks": 1}
    assert torch.all(solver.W[:10] == 0) and torch.any(solver.W[10:20] != 0)


@pytest.mark.parametrize("blk_dense", [None, False], ids=["dense_block", "matrix_free"])
def test_sap_dense_block_span_nests_in_precond_and_is_counted(blk_dense):
    """Ten SAP steps, blocks of 64 (a tile that fits SAP's budget, so
    materialized by default) or matrix-free: on the dense path one
    ``rlaopt.linop.blk_dense`` inside each step's ``rlaopt.sap.precond`` and
    ``rlaopt.sap.dense_blocks`` equal to the steps; matrix-free, neither."""
    steps = 10
    _, spans = _traced(lambda: _solve(_sap_system(), _sap_cfg(steps, blk_dense=blk_dense),
                                      callback_freq=5, metrics="sampled"))
    by_id = _check_nesting(spans)
    dense = [s for s in spans if s["name"] == "rlaopt.linop.blk_dense"]
    c = profiling.counters()
    assert c["rlaopt.sap.steps"] == steps
    if blk_dense is False:
        assert dense == [] and "rlaopt.sap.dense_blocks" not in c
        return
    precond = [s for s in spans if s["name"] == "rlaopt.sap.precond"]
    assert sorted(s["parent"] for s in dense) == sorted(s["id"] for s in precond)
    assert len(precond) == steps and {by_id[s["parent"]]["name"] for s in precond} == {
        "rlaopt.sap.step"}
    assert c["rlaopt.sap.dense_blocks"] == steps


def test_sap_iterates_are_bit_equal_traced_and_not_and_untraced_records_nothing():
    """The same SAP solve with no profile and under one: equal bits in W and
    every logged rel_res; with no profile no span and no counter."""
    def run():
        W, log = _solve(_sap_system(), _sap_cfg(10), callback_freq=5, metrics="sampled")
        return W, [log[i]["metrics"]["internal_metrics"]["rel_res"] for i in (0, 5, 10)]

    W0, rel0 = run()
    assert profiling.spans() == [] and profiling.counters() == {}
    (W1, rel1), spans = _traced(run)
    assert sum(s["name"] == "rlaopt.sap.step" for s in spans) == 10
    assert torch.equal(W0, W1) and all(torch.equal(a, b) for a, b in zip(rel0, rel1))


def test_oracles_take_the_parent_lengthscale_and_copy_nothing_to_the_card(monkeypatch):
    """A row or block oracle takes its parent's lengthscale tensors: making
    them anew copies a host value to the card, a wait for the card at every
    SAP step (found by the card test below)."""
    from rlaopt_tpu_torch.kernels.configs import KernelConfig as Config

    made = []
    real = Config.lengthscale_tensor
    monkeypatch.setattr(Config, "lengthscale_tensor",
                        lambda self, *a, **k: made.append(a) or real(self, *a, **k))
    K = _sap_system().A
    made.clear()
    blk = torch.arange(0, N, 7)
    for op in (K.row_oracle(blk), K.blk_oracle(blk)):
        assert op.lengthscale is K.lengthscale and op.lengthscale64 is K.lengthscale64
    assert made == []
    ones = torch.ones((N, 1))
    assert torch.allclose(K.row_oracle(blk) @ ones, (K @ ones)[blk], rtol=1e-5)


def test_counters_hold_tensor_increments_until_read():
    """A 0-d tensor increment is kept and added when the counters are read;
    with no profile it is not kept."""
    profiling.count("rlaopt.t", torch.tensor(True))
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        profiling.count("rlaopt.t", torch.tensor(True))
        profiling.count("rlaopt.t", torch.tensor(0))
        profiling.count("rlaopt.t", 2)
    assert not profiling.recording()
    assert profiling.counters() == {"rlaopt.t": 3}
    profiling.reset()
    assert profiling.counters() == {}


# -- on a card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(stack):
    return "".join(line for line in stack if "rlaopt_tpu_torch" in line or "tests/" in line)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["true_refined", "recurrence_prebuilt"])
def test_every_synchronizing_operation_lies_in_a_sync_span(cuda_device, case):
    """A k = 1 PCG solve on the card (config 3's path: true metrics and float64
    refinement on the card; config 6's: recurrence metrics on a prebuilt
    preconditioner): each synchronizing operation that
    ``set_sync_debug_mode("warn")`` reports is inside an ``rlaopt.sync.*``
    span, and the ``_safe_solve`` ones are among them. The card's side of
    each ``rlaopt.*`` range is a user annotation, never busy device time."""
    n = 4096
    K, system = _system(cuda_device, n=n)
    cfg = _cfg(60)
    kw = {"callback_freq": 10}
    if case == "true_refined":
        kw.update(metrics="true", f64_refine_rounds=2, f64_refine_device="accel")
    else:
        P = Nystrom(cfg.precond_config)
        P._update(K, key=0)
        P._update_damping(baseline_rho=REG)
        kw.update(metrics="recurrence", preconditioner=P)
    _solve(system, cfg, **kw)  # warm: the library's build and load
    torch.cuda.synchronize()
    reports = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            inside = any(s.name.startswith("rlaopt.sync.") for s in profiling._stack())
            reports.append((inside, traceback.format_stack()))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _solve(system, cfg, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    spans = profiling.spans()
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name.startswith("rlaopt.")]
    assert not [e.name for e in on_card if not getattr(e, "is_user_annotation", False)]
    outside = [_frames(stack) for inside, stack in reports if not inside]
    assert not outside, "synchronizing outside any rlaopt.sync span:\n" + "\n".join(outside)
    safe = [s for s in spans if s["name"] == "rlaopt.sync.safe_solve"]
    assert safe and {s["device"] for s in safe} == {"cuda"}
    assert len(reports) >= len(safe)
    steps = sum(s["name"] == "rlaopt.pcg.step" for s in spans)
    syncs = sum(1 for s in spans if s["name"].startswith("rlaopt.sync.") and s["device"] == "cuda")
    print(f"{case}: {len(reports)} reported, {syncs} sync spans on cuda over {steps} steps, "
          f"{len(on_card)} rlaopt ranges on the card, "
          f"by site {json.dumps({k: v['calls'] for k, v in profiling.summary().items() if k.startswith('rlaopt.sync.')})}")


@pytest.mark.cuda
def test_every_synchronizing_operation_of_sap_lies_in_a_sync_span(cuda_device):
    """Config 9's path at a small size on the card (bf16x3 operator,
    matrix-free blocks, host-drawn blocks, accelerated, sampled metrics):
    each synchronizing operation that ``set_sync_debug_mode("warn")``
    reports is inside an ``rlaopt.sync.*`` span, one block upload a chunk
    among them; each step and phase span carries the card's time, the
    phases' within their step's."""
    n, k, blk = 1 << 17, 3, 2048
    g = torch.Generator(device=cuda_device).manual_seed(0)
    X = torch.randn((n, 50), generator=g, device=cuda_device) / 50**0.5
    y = torch.randn((n, k), generator=g, device=cuda_device)
    K = RBFLinOp(X, X, KernelConfig(lengthscale=1.0), compute_dtype="bf16x3")
    system = LinSys(K, y, 1e-5 * n, A_row_oracle=K.row_oracle, A_blk_oracle=K.blk_oracle)
    cfg = SAPConfig(max_iters=10, rtol=1e-9, blk_sz=blk, power_iters=10, blk_dense=False,
                    accel=True, accel_config=SAPAccelConfig(mu=1e-3, nu=n / blk),
                    precond_config=NystromConfig(rank=100, rho=1e-5 * n))
    kw = {"callback_freq": 5, "metrics": "sampled"}
    _solve(system, cfg, **kw)  # warm: the library's build and load
    torch.cuda.synchronize()
    reports = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            inside = any(s.name.startswith("rlaopt.sync.") for s in profiling._stack())
            reports.append((inside, traceback.format_stack()))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _solve(system, cfg, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    spans = profiling.spans()
    outside = [_frames(stack) for inside, stack in reports if not inside]
    assert not outside, "synchronizing outside any rlaopt.sync span:\n" + "\n".join(outside)
    uploads = [s for s in spans if s["name"] == "rlaopt.sync.sap_blocks"]
    assert len(uploads) == 2 and {s["device"] for s in uploads} == {"cuda"}
    steps = sum(s["name"] == "rlaopt.sap.step" for s in spans)
    syncs = sum(1 for s in spans if s["name"].startswith("rlaopt.sync.") and s["device"] == "cuda")
    assert steps == 10 and profiling.counters()["rlaopt.sap.degenerate_blocks"] == 0
    timed = [s for s in spans if s["name"] in SAP_PHASES + ("rlaopt.sap.step",)]
    assert len(timed) == 50 and all(s["device_ms"] > 0 for s in timed)
    step_ms = sum(s["device_ms"] for s in timed if s["name"] == "rlaopt.sap.step")
    assert sum(s["device_ms"] for s in timed if s["name"] in SAP_PHASES) <= 1.01 * step_ms
    sites = {k: v["calls"] for k, v in profiling.summary().items() if k.startswith("rlaopt.sync.")}
    print(f"sap: {len(reports)} reported, {syncs} sync spans on cuda over {steps} steps, "
          f"by site {json.dumps(sites)}")
