"""The readers of the program's spans (``boundary_s.*``, ``syncs.solve``,
``apply_host_us.solve``) on records built by hand, on an empty record and on
a program that keeps none, and on the record of a real window on the CPU."""

import pytest
import torch

from portbench import spec
from portbench.harness import Run
from portbench.tests.test_portbench_harness import SEED, _quiet, small

NAMES = ("boundary_s.solve", "boundary_s.iters", "syncs.solve", "apply_host_us.solve")
MS = 1_000_000


def _reader(name):
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == name)
    return spec.metric(entry).read


class _Rec:
    """Spans built by hand: ``add(name, start_ms, end_ms, parent, ...)``."""

    def __init__(self):
        self.spans = []

    def add(self, name, start, end, parent=None, device=None, error=False):
        up = next((s for s in self.spans if s["id"] == parent), None)
        sid = len(self.spans) + 1
        solve = up["solve"] if up else (sid if name == "rlaopt.linsys.solve" else None)
        self.spans.append({"name": name, "start_ns": start * MS, "end_ns": end * MS, "id": sid,
                           "parent": parent, "solve": solve, "device": device, "error": error})
        return sid


def _window():
    """Two outer solves, the first refined (a correction solve inside), the
    second closed by the harness's ``WindowClosed`` at its second boundary."""
    r = _Rec()
    s1 = r.add("rlaopt.linsys.solve", 0, 100)
    r.add("rlaopt.model.boundary", 0, 10, s1)
    chunk = r.add("rlaopt.model.chunk", 10, 50, s1)
    for t in (10, 30):
        step = r.add("rlaopt.pcg.step", t, t + 20, chunk)
        mm = r.add("rlaopt.linop.matmat", t, t + 4, step)
        r.add("rlaopt.sync.tile", t + 1, t + 2, mm, "cuda")  # a sync inside the apply
        r.add("rlaopt.sync.safe_solve", t + 5, t + 6, step, "cuda")
        r.add("rlaopt.sync.safe_solve", t + 7, t + 8, step, "cuda")
    r.add("rlaopt.model.boundary", 50, 70, s1)
    ref = r.add("rlaopt.refine", 70, 100, s1)
    r.add("rlaopt.sync.refine", 70, 71, ref, "cpu")  # not a sync with the card
    corr = r.add("rlaopt.refine.correction", 71, 100, ref)
    c = r.add("rlaopt.linsys.solve", 71, 100, corr)
    r.add("rlaopt.model.boundary", 71, 76, c)
    step = r.add("rlaopt.pcg.step", 76, 96, c)
    r.add("rlaopt.linop.matmat", 76, 84, step)
    r.add("rlaopt.model.boundary", 96, 100, c)
    s2 = r.add("rlaopt.linsys.solve", 100, 150, error=True)
    r.add("rlaopt.model.boundary", 100, 110, s2)
    r.add("rlaopt.pcg.step", 110, 130, s2)
    r.add("rlaopt.model.boundary", 130, 150, s2, error=True)
    return r.spans


@pytest.fixture
def record(monkeypatch):
    from rlaopt_tpu_torch.utils import profiling

    def use(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))

    return use


def test_readers_on_a_record_built_by_hand(record):
    record(_window())
    run = Run("solves", iterations=7)
    # solve 1 ran to its end: 10 + 20 + its correction solve's 5 + 4 ms;
    # solve 2 was closed by WindowClosed and does not count
    assert _reader("boundary_s.solve")(run) == pytest.approx(0.039)
    # every boundary of the window, the closing one included, over 7 iterations
    assert _reader("boundary_s.iters")(run) == pytest.approx((0.039 + 0.030) / 7)
    # on cuda, a sync in each of two applies and two safe solves in each of
    # their steps, over 4 steps; the cpu one does not count
    assert _reader("syncs.solve")(run) == pytest.approx(6 / 4)
    # applies of 4, 4 and 8 ms, the first two less their 1 ms sync
    assert _reader("apply_host_us.solve")(run) == pytest.approx(1e3 * (3 + 3 + 8) / 3)


def test_readers_read_none_on_an_empty_record(record):
    record([])
    for name in NAMES:
        assert _reader(name)(Run("solves", iterations=7)) is None


def test_readers_read_none_where_the_program_keeps_no_record(monkeypatch):
    from rlaopt_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    for name in NAMES:
        assert _reader(name)(Run("solves", iterations=7)) is None


def test_readers_read_none_without_what_they_divide_by(record):
    spans = [s for s in _window() if s["name"] not in ("rlaopt.pcg.step", "rlaopt.linop.matmat")]
    spans = [dict(s, error=True) if s["name"] == "rlaopt.linsys.solve" else s for s in spans]
    record(spans)
    run = Run("solves", iterations=0)
    for name in NAMES:
        assert _reader(name)(run) is None


@pytest.mark.parametrize("name", ["krr100k-exact-solve", "krr1m-bf16x3-iters"])
def test_readers_find_their_spans_in_a_window_on_the_cpu(name):
    """A small window of each cell under a CPU profile: the port's
    record holds what each reader of the cell reads (a CPU solve has no sync
    with a card: ``syncs.solve`` reads 0)."""
    from rlaopt_tpu_torch.utils import profiling

    cell = small(name)
    prog = spec.program(cell.config["program"], cell.root).Program(cell, SEED, "cpu", False, _quiet)
    prog.warm_up()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        prog.window(0.5, traced=False)
    got = {m.name: m.read(prog.run) for m in cell.per_layer if m.name in NAMES}
    profiling.reset()
    if name == "krr100k-exact-solve":
        assert set(got) == {"boundary_s.solve", "syncs.solve", "apply_host_us.solve"}
        assert got["boundary_s.solve"] > 0 and got["apply_host_us.solve"] > 0
        assert got["syncs.solve"] == 0
    else:
        assert set(got) == {"boundary_s.iters"} and got["boundary_s.iters"] > 0
