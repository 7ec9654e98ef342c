"""The benchmark's cell ``krr1m-laplace-askotch-iters`` (config 4's path A:
Laplace ASkotch at n = 10^6, program ``krr_sap_exact``, reference
``laplace_krr``) on the CPU at small sizes: its parts load with the metrics
``BENCHMARK.json`` names, its configuration holds the published widths,
``blkdense_s.sap`` reads what span records built by hand hold (None where
nothing carries the card's time), and one short window of the program
yields every check number finite, for the program and for its control.
``python -m pytest`` from the root of the checkout puts ``portbench`` on
the path."""

import copy
import dataclasses
import math

import pytest

from portbench import harness, spec
from portbench.harness import Run

CELL = "krr1m-laplace-askotch-iters"
PER_LAYER = ("oracle_roofline.sap", "blkprecond_s.sap", "syncs.sap", "idle_share.iters",
             "blkdense_s.sap")
SEED = 2**31 + 11
MS = 1_000_000


def _reader(name):
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == name)
    return spec.metric(entry).read


def test_the_cell_loads_with_the_metrics_benchmark_json_names():
    """``iter_s`` and ``setup_s`` untraced; traced, SAP's three readers,
    the device's idle share and the dense block's reader, each declaring
    BENCHMARK.json's unit, layer and ``moves`` (``spec.metric`` checks)."""
    cell = spec.cell(CELL)
    assert cell.chips == 1 and cell.traffic["loop"] == "iterations"
    assert [m.name for m in cell.end_to_end] == ["iter_s", "setup_s"]
    assert {m.name for m in cell.per_layer} == set(PER_LAYER)
    assert cell.config["program"] == "krr_sap_exact"
    assert cell.config["reference"] == "laplace_krr"
    assert cell.check["control"] == "tf32_reference"
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == "blkdense_s.sap")
    assert entry == {"name": "blkdense_s.sap", "unit": "s/iter", "better": "lower",
                     "source": "program_span", "layer": "operator", "moves": "iter_s",
                     "workloads": [CELL]}


def test_the_configuration_holds_config_4s_published_widths():
    """n = 10^6 (config 4's cut of the source's 10^7), d = 50, k = 10,
    blocks of n/100, rank 100, 10 power iterations, Laplace at ℓ = 8 on the
    exact tier, accelerated with ν = n/blk and a μ from the pilot."""
    c = spec.cell(CELL).config
    s, p = c["solver"], c["preconditioner"]
    assert (c["n"], c["d"], c["k"], s["blk_sz"], p["rank"], s["power_iters"]) == (
        10**6, 50, 10, 10**4, 100, 10)
    assert (c["kernel"], c["lengthscale"], c["compute_dtype"], c["key"]) == (
        "laplace", 8.0, None, 0)
    assert s["accel"] and s["nu"] == c["n"] / s["blk_sz"] and 0 < s["mu"] * s["nu"] < 1
    bench = next(b for b in spec.benchmark()["configs"] if b["name"] == c["name"])
    assert set(bench["reduced"]) == set(c["reduced"]) == {"n", "max_iters", "pilot",
                                                          "certificate"}
    assert bench["source"] == c["source"] and len(c["source"]) <= 200
    assert {"mu", "lengthscale", "reg_per_n", "key"} <= set(c["assumed"])


def _sap_record(steps=3, dense_ms=(120.0, 125.0, 130.0), on_card=True):
    """``steps`` SAP steps, each a precond span with a dense block inside
    and a stepsize span, device times on a card."""
    spans, t = [], 0

    def add(name, device_ms=None, parent=None):
        nonlocal t
        spans.append({"name": name, "start_ns": t * MS, "end_ns": (t + 1) * MS,
                      "id": len(spans) + 1, "parent": parent, "solve": None, "device": None,
                      "error": False, "device_ms": device_ms if on_card else None})
        t += 1
        return len(spans)

    for i in range(steps):
        step = add("rlaopt.sap.step", 250.0)
        pre = add("rlaopt.sap.precond", 150.0, parent=step)
        if dense_ms:
            add("rlaopt.linop.blk_dense", dense_ms[i], parent=pre)
        add("rlaopt.sap.stepsize", 5.0, parent=step)
    return spans


@pytest.fixture
def record(monkeypatch):
    from rlaopt_tpu_torch.utils import profiling

    def use(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))

    return use


def test_blkdense_reads_the_dense_blocks_card_time_per_step(record):
    record(_sap_record())
    run = Run("iterations", iterations=3)
    assert _reader("blkdense_s.sap")(run) == pytest.approx((120 + 125 + 130) / 3 / 1e3)
    # the dense block sits inside the preconditioner's span, which it does not replace
    assert _reader("blkprecond_s.sap")(run) == pytest.approx(0.155)


def test_blkdense_reads_none_where_nothing_carries_the_cards_time(record, monkeypatch):
    run = Run("iterations", iterations=3)
    record([])
    assert _reader("blkdense_s.sap")(run) is None
    record(_sap_record(dense_ms=()))  # matrix-free blocks, or a port without the span
    assert _reader("blkdense_s.sap")(run) is None
    record(_sap_record(on_card=False))  # the CPU: no device time
    assert _reader("blkdense_s.sap")(run) is None
    record([s for s in _sap_record() if s["name"] != "rlaopt.sap.step"])
    assert _reader("blkdense_s.sap")(run) is None
    from rlaopt_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert _reader("blkdense_s.sap")(run) is None


def test_krr_sap_exact_window_on_the_cpu_gives_every_check_number_and_its_control():
    """n = 20,000, blocks of 200, rank 20, the widths otherwise config 4's:
    a 1-second window runs on to iteration 10 (``res_at.10``) on the dense
    block path, and the program's numbers and the control's are finite;
    the control's ``oracle_err`` and ``blk_err`` are over their limits, and
    its ``res_gap`` and ``res_at.10`` are the program's."""
    cell = spec.cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["n"] = 20_000
    cfg["solver"].update(blk_sz=200)
    cfg["preconditioner"]["rank"] = 20
    cell = dataclasses.replace(cell, config=cfg,
                               check=dict(cell.check, rows=1024, oracle_rows=200))
    res = harness.run(cell, SEED, 1.0, False, device="cpu", control=True, log=lambda *_: None)
    assert res["failed"] == 0 and res["attempted"] >= 1
    values = {k: v["value"] for k, v in res["checks"].items()}
    assert set(values) == set(res["control"]) == set(cell.check["limits"])
    for got in (values, res["control"]):
        assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
    for name in ("oracle_err", "blk_err"):
        limit = cell.check["limits"][name]
        assert values[name] < limit < res["control"][name], name
    for name in ("res_gap", "res_at.10"):
        assert res["control"][name] == values[name]
    assert not res["control_correct"]
    assert res["metrics"]["iter_s"]["value"] > 0
