"""The harness on the CPU at small sizes: parts found by name (a program
among them), the check passing the program and failing its control and
planted faults, a check number that does not depend on the program's pace,
and (on a card only) one whole run of each cell through the command and its
control judged not correct."""

import copy
import dataclasses
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import checks, harness, spec, taps

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("krr100k-exact-solve", "krr1m-bf16x3-iters")
SEED = 2**31 + 5


def small(name, n=1500, rank=100, **config):
    """The cell at n points and Nyström rank ``rank``, widths unchanged, with
    a logging boundary every 5 iterations: a window of a second on a busy
    CPU then still logs boundaries before the one that closes it. Rank 100
    preconditions n = 1,500 about as rank 500 does the cells' n: PCG's
    residual at iteration 20 is at the tier's floor in both."""
    c = spec.cell(name)
    cfg = copy.deepcopy(c.config)
    cfg.update(n=n, **config)
    cfg["preconditioner"]["rank"] = rank
    cfg["solver"]["callback_freq"] = 5
    return dataclasses.replace(c, config=cfg)


def _quiet(*_):
    pass


# -- parts found by name ---------------------------------------------------

def _copy(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    root = _copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    cfg = json.loads((pb / "configs/higgs100k-rbf-exact.json").read_text())
    cfg.update(name="higgs50k-rbf-exact", n=50_000)
    (pb / "configs/higgs50k-rbf-exact.json").write_text(json.dumps(cfg))
    (pb / "traffic/two-targets.json").write_text(json.dumps(
        {"loop": "solves", "columns": 2, "preconditioner": "per_solve"}))
    (pb / "checks/krr50k-two.json").write_text(
        (pb / "checks/krr100k-exact-solve.json").read_text())
    (pb / "metrics/solves.two.py").write_text(
        'UNIT = "solves"\nLAYER = "model"\nMOVES = "solve_s"\n\n\n'
        "def read(run):\n    return len(run.solves)\n")
    bench["configs"].append({"name": "higgs50k-rbf-exact", "source": "x",
                             "file": "portbench/configs/higgs50k-rbf-exact.json",
                             "reduced": ["n"], "why": "x"})
    bench["workloads"].append({"name": "krr50k-two", "config": "higgs50k-rbf-exact",
                               "traffic": "two-targets", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("krr50k-two")
    bench["per_layer"].append({"name": "solves.two", "unit": "solves", "better": "higher",
                               "source": "program_counter", "layer": "model",
                               "moves": "solve_s", "workloads": ["krr50k-two"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("krr50k-two", root)
    assert cell.config["n"] == 50_000 and cell.traffic["columns"] == 2
    assert [m.name for m in cell.end_to_end] == ["solve_s", "setup_s"]
    assert [m.name for m in cell.per_layer] == ["solves.two"]
    run = harness.Run("solves", solves=[{}, {}])
    assert cell.per_layer[0].read(run) == 2
    # an existing cell is untouched by the new entries
    old = spec.cell("krr100k-exact-solve", root)
    assert "solves.two" not in [m.name for m in old.per_layer]


TOY_PROGRAM = '''
"""A program of the test: the window counts steps of its own."""
import time

from portbench.harness import Run


class Program:
    def __init__(self, cell, seed, device, traced, log=print):
        self.run, self.failed, self.seed = Run("solves"), 0, seed

    def warm_up(self):
        pass

    def window(self, seconds, traced):
        t0 = time.perf_counter()
        while not self.run.solves or time.perf_counter() - t0 < seconds:
            self.run.solves.append({"j": len(self.run.solves), "completed": True})
        self.run.window_s = time.perf_counter() - t0

    def timed_ops(self):
        return []

    def release(self):
        pass

    def numbers(self, reference, names, control=False):
        error = getattr(reference, "error", lambda seed: 0.0)
        return {name: error(self.seed) for name in names}
'''


def test_a_new_program_is_new_files_and_entries(tmp_path):
    """A configuration that names a program and a reference of its own runs
    through the harness with no edit of a file already there."""
    root = _copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    (pb / "programs/toy.py").write_text(TOY_PROGRAM)
    (pb / "reference/toy.py").write_text("def error(seed):\n    return 0.0\n")
    (pb / "configs/toy.json").write_text(json.dumps({"program": "toy", "reference": "toy"}))
    (pb / "traffic/steps.json").write_text(json.dumps({"loop": "solves"}))
    (pb / "checks/toy-steps.json").write_text(json.dumps({"limits": {"err": 0.0}}))
    bench["configs"].append({"name": "toy", "source": "x", "file": "portbench/configs/toy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toy-steps", "config": "toy", "traffic": "steps",
                               "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("toy-steps")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.run(spec.cell("toy-steps", root), SEED, 0.01, False, device="cpu",
                      log=_quiet)
    assert res["correct"] is True and res["attempted"] >= 1
    assert res["checks"] == {"err": {"value": 0.0, "limit": 0.0}}
    assert set(res["metrics"]) == {"solve_s", "setup_s"}
    # traffic that names a program of its own runs it on an existing configuration
    (pb / "traffic/toy-loop.json").write_text(json.dumps({"loop": "solves", "program": "toy"}))
    (pb / "checks/krr100k-toy.json").write_text(json.dumps({"limits": {"err": 0.0}}))
    bench["workloads"].append({"name": "krr100k-toy", "config": "higgs100k-rbf-exact",
                               "traffic": "toy-loop", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("krr100k-toy")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.run(spec.cell("krr100k-toy", root), SEED, 0.01, False, device="cpu",
                      log=_quiet)
    assert res["correct"] is True and res["checks"]["err"]["value"] == 0.0


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_loads(name):
    cell = spec.cell(name)
    assert cell.chips == 1
    assert "setup_s" in [m.name for m in cell.end_to_end]
    assert len(cell.end_to_end) == 2 and cell.per_layer


def test_unknown_names_fail(tmp_path):
    with pytest.raises(spec.SpecError):
        spec.cell("no-such-cell")
    root = _copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"][0]["traffic"] = "no-such-traffic"
    bench["per_layer"][0]["unit"] = "ms"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(spec.SpecError, match="no-such-traffic"):
        spec.cell(bench["workloads"][0]["name"], root)
    with pytest.raises(spec.SpecError, match="declares unit"):
        spec.metric(bench["per_layer"][0], root)
    with pytest.raises(spec.SpecError):
        spec.reference("../harness")


def test_command_refuses_without_a_card_and_unknown_cells():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal without one is not reachable")
    for argv, rc in ((["--workload", CELLS[0]], 1), (["--workload", "nope"], 2)):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", *argv, "--seed", "1", "--seconds", "1"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert out.returncode == rc and out.stdout == ""


# -- the check: program, control, faults -------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_separates(name):
    """At a small size the program passes its cell's limits and the control
    reads one number at least 30 times the program's. The limits themselves
    are set from the card's readings at the cell's size, where the control
    fails them (PERF.md); the errors scale with n, so the control is held
    here to its distance from the program, not to those limits."""
    cell = small(name)
    res = harness.run(cell, SEED, 1.0, False, device="cpu", control=True, log=_quiet)
    values = {k: v["value"] for k, v in res["checks"].items()}
    limits = cell.check["limits"]
    assert checks.judge(values, limits), values
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-3:] == ["control", "control_correct", "checks"]
    if cell.check["control"] == "tf32_reference":
        control = res["control"]
    else:  # the program's own lower tier
        low = dataclasses.replace(cell, config={**cell.config, **cell.check["control"]})
        control = harness.run(low, SEED, 1.0, False, device="cpu", log=_quiet)["checks"]
        control = {k: v["value"] for k, v in control.items()}
    assert max(control[k] / max(values[k], 1e-300) for k in limits) >= 30, (values, control)


def test_res_at_reads_each_solve_at_its_depth():
    """``res_at.<i>`` reads each solve's iterate at iteration i, or its last
    where it ran to its end before i, and leaves out a solve the window cut
    short of i: how far the window got does not move it."""
    from portbench.programs.krr_pcg import _at_depth

    kept = [{"solve": 0, "i": i} for i in (10, 20, 30)] + [
        {"solve": 1, "i": 10}, {"solve": 2, "i": 10}]
    assert _at_depth(kept, {0: False, 1: True, 2: False}, 20) == [1, 3]
    assert _at_depth(kept, {0: True, 1: True}, 40) == [2, 3]


def test_window_holds_until_the_deepest_boundary_checked():
    """An iterations window shorter than its first solve's path to the
    deepest ``res_at`` boundary runs on to it."""
    cell = small(CELLS[1])
    depth = max(int(k.split(".")[1]) for k in cell.check["limits"] if k.startswith("res_at."))
    res = harness.run(cell, SEED, 0.0, False, device="cpu", log=_quiet)
    assert math.isfinite(res["checks"][f"res_at.{depth}"]["value"])
    assert res["correct"], res["checks"]


def test_observer_closes_at_the_first_boundary_past_deadline_and_hold():
    class System:
        def _compute_internal_metrics(self, W, force_true=False):
            return {"rel_res": torch.ones(1)}

    kept = []
    obs = taps.Observer(System(), 0, 5, 60, kept, deadline=0.0, hold=15)
    W = torch.zeros(3, 1)
    for i in (0, 5, 10):
        obs(W, None)
    with pytest.raises(taps.WindowClosed):
        obs(W, None)
    assert [k["i"] for k in kept] == [0, 5, 10, 15]


def _stalled_step(monkeypatch):
    from rlaopt_tpu_torch.solvers import pcg

    monkeypatch.setattr(pcg, "pcg_step", lambda A, reg, inv, ps, state, mask: state)


def _altered_apply(monkeypatch):
    from rlaopt_tpu_torch.kernels.linop import KernelLinOp

    matmat = KernelLinOp.matmat

    def altered(self, X):
        Y = matmat(self, X)
        return Y * (1.0 + 1e-2 * (torch.arange(Y.shape[0]) % 7 == 0)[:, None])

    monkeypatch.setattr(KernelLinOp, "matmat", altered)


@pytest.mark.parametrize("fault", [_stalled_step, _altered_apply])
@pytest.mark.parametrize("name", CELLS)
def test_faults_come_out_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    res = harness.run(small(name), SEED, 1.0, False, device="cpu", log=_quiet)
    assert res["correct"] is False, res["checks"]


# -- on a card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name):
    """One run of the cell as the benchmark runs it, ``run_seconds`` long."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seconds = spec.benchmark()["run_seconds"]
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed", str(SEED),
         "--seconds", str(seconds), "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name):
    """At the cell's own size, the program passes the check and its control,
    judged by the same limits, does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seconds = spec.benchmark()["run_seconds"]
    out = subprocess.run(
        [sys.executable, "portbench/limits.py", "--workload", name, "--seconds", str(seconds),
         "--seeds", str(SEED + 1), "--control-seeds", str(SEED + 2)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert [line["correct"] for line in lines if not line["control"]] == [True], lines
    control = [line["correct"] for line in lines if line["control"]]
    assert control == [False], lines
