"""The benchmark's cells ``krr10m-askotch-iters`` (config 9's ASkotch
iterations, program ``krr_sap``) and ``krr100k-exact-sweep`` (config 3's
grid search, program ``krr_pcg_sweep``) on the CPU at small sizes: their
parts load and their readers declare what ``BENCHMARK.json`` says, the
readers of SAP's spans read what records built by hand hold (None where
nothing is there), and one short window of each program yields every
check number finite. ``python -m pytest`` from the root of the checkout
puts ``portbench`` on the path."""

import copy
import dataclasses
import math

import pytest

from portbench import harness, spec
from portbench.harness import Run

SAP_CELL, SWEEP_CELL = "krr10m-askotch-iters", "krr100k-exact-sweep"
SAP_METRICS = ("oracle_roofline.sap", "blkprecond_s.sap", "syncs.sap")
SEED = 2**31 + 7


def _quiet(*_):
    pass


def _reader(name):
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == name)
    return spec.metric(entry).read


def test_both_cells_load_with_the_metrics_benchmark_json_names():
    """Each new cell reports ``setup_s`` and its one other end-to-end metric
    with ``--trace 0``, and with ``--trace 1`` the per-layer metrics that
    name it: SAP's three readers (each declaring BENCHMARK.json's unit,
    layer and ``moves``, which ``spec.metric`` checks) and the accepted
    ones the cell is appended to."""
    bench = spec.benchmark()
    sap, sweep = spec.cell(SAP_CELL), spec.cell(SWEEP_CELL)
    assert sap.chips == sweep.chips == 1
    assert [m.name for m in sap.end_to_end] == ["iter_s", "setup_s"]
    assert [m.name for m in sweep.end_to_end] == ["solve_s", "setup_s"]
    assert sap.config["program"] == "krr_sap" and sap.config["reference"] == "askotch_krr"
    assert sweep.traffic["program"] == "krr_pcg_sweep"
    assert {m.name for m in sap.per_layer} == set(SAP_METRICS) | {"idle_share.iters"}
    assert {m.name for m in sweep.per_layer} == {
        "precond_s.solve", "iters.solve", "sketch_roofline.solve", "idle_share.solve"}
    for name in SAP_METRICS:
        entry = next(m for m in bench["per_layer"] if m["name"] == name)
        # config 4's Laplace cell reads SAP's metrics too
        assert entry["workloads"] == [SAP_CELL, "krr1m-laplace-askotch-iters"]
        assert entry["moves"] == "iter_s"
    # the widths of config 9 as published
    c = sap.config
    assert (c["n"], c["d"], c["k"], c["solver"]["blk_sz"], c["preconditioner"]["rank"],
            c["solver"]["power_iters"], c["compute_dtype"]) == (
        10**7, 50, 10, 10**5, 100, 10, "bf16x3")


# -- the readers on records built by hand -------------------------------------

MS = 1_000_000


def _sap_record(steps=3, phase_ms=(40.0, 60.0), on_card=True):
    """``steps`` SAP steps, each a precond and a stepsize span with device
    times, two block-Nyström syncs on the card and a sync on the CPU; one
    block upload and one metrics sync outside the steps."""
    spans, t = [], 0

    def add(name, device=None, device_ms=None, parent=None):
        nonlocal t
        spans.append({"name": name, "start_ns": t * MS, "end_ns": (t + 1) * MS,
                      "id": len(spans) + 1, "parent": parent, "solve": None, "device": device,
                      "error": False, "device_ms": device_ms})
        t += 1
        return len(spans)

    add("rlaopt.sync.sap_blocks", "cuda" if on_card else "cpu")
    for _ in range(steps):
        step = add("rlaopt.sap.step", device_ms=200.0 if on_card else None)
        add("rlaopt.sap.precond", device_ms=phase_ms[0] if on_card else None, parent=step)
        add("rlaopt.sap.stepsize", device_ms=phase_ms[1] if on_card else None, parent=step)
        add("rlaopt.sync.nystrom", "cuda" if on_card else "cpu", parent=step)
        add("rlaopt.sync.nystrom", "cuda" if on_card else "cpu", parent=step)
        add("rlaopt.sync.refine", "cpu", parent=step)
        add("rlaopt.sap.row_oracle", device_ms=90.0 if on_card else None, parent=step)
    add("rlaopt.sync.metrics", "cuda" if on_card else "cpu")
    return spans


@pytest.fixture
def record(monkeypatch):
    from rlaopt_tpu_torch.utils import profiling

    def use(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))

    return use


def test_sap_span_readers_on_a_record_built_by_hand(record):
    record(_sap_record())
    run = Run("iterations", iterations=3)
    # (40 + 60) ms of the card's time a step
    assert _reader("blkprecond_s.sap")(run) == pytest.approx(0.1)
    # 2 syncs on the card a step, the upload and the metrics' besides, over 3 steps
    assert _reader("syncs.sap")(run) == pytest.approx((2 * 3 + 2) / 3)


def test_sap_span_readers_read_none_where_nothing_is_recorded(record, monkeypatch):
    run = Run("iterations", iterations=3)
    record([])
    assert _reader("blkprecond_s.sap")(run) is None and _reader("syncs.sap")(run) is None
    # a PCG record (no SAP step), and SAP spans without the card's time (the CPU)
    record([s for s in _sap_record() if s["name"] != "rlaopt.sap.step"])
    assert _reader("blkprecond_s.sap")(run) is None and _reader("syncs.sap")(run) is None
    record(_sap_record(on_card=False))
    assert _reader("blkprecond_s.sap")(run) is None and _reader("syncs.sap")(run) == 0
    # a port that keeps no record
    from rlaopt_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert _reader("blkprecond_s.sap")(run) is None and _reader("syncs.sap")(run) is None


def test_oracle_roofline_reads_the_row_oracle_applies():
    """343.28 ms of bound (the float32 contraction at 10^5 x 10^7, d = 50,
    k = 10, bf16x3) over a mean of 2,500 ms; other applies do not count;
    None without a row-oracle apply."""
    op = {"op": "row_oracle", "kernel": "gram_matmat_tier", "kind": "rbf", "cd": "bf16x3",
          "n": 100_000, "m": 10**7, "d": 50, "k": 10}
    other = dict(op, op="matvec", device_ms=1.0)
    run = Run("iterations", ops=[dict(op, device_ms=2400.0), dict(op, device_ms=2600.0), other])
    assert _reader("oracle_roofline.sap")(run) == pytest.approx(100 * 343.2835820895522 / 2500)
    assert _reader("oracle_roofline.sap")(Run("iterations", ops=[other])) is None


# -- short windows of the programs on the CPU -----------------------------------

def _small(name, **config):
    cell = spec.cell(name)
    cfg = copy.deepcopy(cell.config)
    for key, value in config.items():
        if isinstance(value, dict):
            cfg[key].update(value)
        else:
            cfg[key] = value
    return dataclasses.replace(cell, config=cfg)


def test_krr_sap_window_on_the_cpu_gives_every_check_number():
    """n = 20,000, blocks of 200, rank 20, the widths otherwise config 9's:
    a 1-second window runs on to iteration 10 (``res_at.10``), keeps two
    row-oracle applies past the first step and every number is finite."""
    cell = _small(SAP_CELL, n=20_000, solver={"blk_sz": 200, "nu": 100.0},
                  preconditioner={"rank": 20})
    cell = dataclasses.replace(cell, check=dict(cell.check, rows=1024, oracle_rows=200))
    prog = spec.program("krr_sap").Program(cell, SEED, "cpu", False, _quiet)
    prog.warm_up()
    prog.window(1.0, traced=False)
    assert prog.run.iterations >= 10 and prog.failed == 0
    assert len(prog.applies) == 2 and all(float(V.abs().max()) > 0 for _, V, _ in prog.applies)
    values = prog.numbers(spec.reference("askotch_krr"), list(cell.check["limits"]))
    assert set(values) == set(cell.check["limits"])
    assert all(math.isfinite(v) and v >= 0 for v in values.values()), values


def test_krr_pcg_sweep_window_on_the_cpu_runs_whole_sweeps():
    """n = 4,000, rank 100: the window ends on a whole sweep of the 9
    pairs, and the check's numbers are
    finite, the program's within the limits and the TF32 control's not."""
    cell = _small(SWEEP_CELL, n=4_000, preconditioner={"rank": 100})
    res = harness.run(cell, SEED, 1.0, False, device="cpu", control=True, log=_quiet)
    assert res["attempted"] % 9 == 0 and res["attempted"] >= 9 and res["failed"] == 0
    values = {k: v["value"] for k, v in res["checks"].items()}
    assert all(math.isfinite(v) for v in values.values()), values
    assert res["correct"] and not res["control_correct"], (values, res["control"])
    assert res["metrics"]["solve_s"]["value"] > 0
