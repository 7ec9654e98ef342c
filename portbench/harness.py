"""One run of one cell: set-up, the measured window, the check, the result.

The cell's configuration names its program (``"program"``; traffic that
names one of its own, such as a loop that builds a new operator per solve,
overrides it), a module ``programs/<name>.py``. Its ``Program(cell, seed,
device, traced, log)`` makes the data from the seed and builds the
program's objects (set-up), and then has ``warm_up()``, ``window(seconds, traced)``, ``run`` (the
:class:`Run` the metric readers read), ``failed``, ``timed_ops()`` (the
traced applies, each with the work ``peaks.bound_ms`` counts), ``release()``
and ``numbers(reference, names, control)`` (the check's numbers of what the
window produced, judged by the configuration's plain reference). The
harness runs those steps in that order: ``setup_s`` runs from the start of
the process to the start of the window; in the traced run the profiler
covers the window alone. After the window it reads the peak memory, frees
the program's state and runs the check; ``correct`` is every number of the
cell's ``checks/<cell>.json`` within its limit.
"""

import argparse
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

from . import checks, spec, tracing
from .smi import Sampler, card_line

# Top-level module names the process may not hold once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "rlaopt_tpu")


def process_start() -> float:
    """The ``time.perf_counter()`` reading at which this process started
    (from ``/proc``, to 10 ms), or the present one where that is unreadable."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``)."""

    loop: str
    setup_s: float = 0.0
    window_s: float = 0.0
    # per solve: j, iters (base iterations), phase_walls, refine_s, completed
    solves: list = field(default_factory=list)
    iterations: int = 0  # base iterations in the window
    # traced: per operator apply, op (a name of the program's), kernel (the
    # work it counts as), kind, cd, n, m, d, k, device_ms (CUDA events)
    ops: list = field(default_factory=list)
    busy_s: float = None
    trace_window_s: float = None
    breakdown: dict = None


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start=None, control=False, log=print, extra=()):
    """One run; returns the result dict (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` when traced,
    ``checks`` last). With ``control``, also the control's numbers under
    ``control`` and whether they pass the limits under ``control_correct``;
    with ``extra``, further numbers of the program under ``readings``."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()  # the peak's reset needs an initialized device
        torch.cuda.reset_peak_memory_stats(dev)
    program = spec.program(cell.traffic.get("program", cell.config["program"]), cell.root)
    prog = program.Program(cell, seed, dev, trace, log)
    t = time.perf_counter()
    prog.warm_up()
    log(f"set-up: warm-up {time.perf_counter() - t:.3f} s")
    sampler = Sampler() if cuda else None
    if sampler:
        sampler.start()
    try:
        if trace:
            with tracing.profiler() as prof:
                with torch.profiler.record_function(tracing.WINDOW):
                    prog.run.setup_s = time.perf_counter() - t_start
                    prog.window(seconds, traced=True)
        else:
            prog.run.setup_s = time.perf_counter() - t_start
            prog.window(seconds, traced=False)
    finally:
        samples = sampler.stop() if sampler else []
    if trace:
        traced = tracing.read(prof)
        if traced:
            prog.run.busy_s = traced["busy_s"]
            prog.run.trace_window_s = traced["window_s"]
            prog.run.breakdown = traced["breakdown"]
        prog.run.ops = prog.timed_ops()
    if samples:
        mhz, watts = zip(*samples)
        log(f"smi: {len(samples)} samples, SM clock {min(mhz):.0f}-{max(mhz):.0f} MHz "
            f"(median {sorted(mhz)[len(mhz) // 2]:.0f}), power {min(watts):.1f}-"
            f"{max(watts):.1f} W (median {sorted(watts)[len(watts) // 2]:.1f})")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    r = prog.run
    log(f"window: {r.window_s:.6f} s, {len(r.solves)} solves, {r.iterations} iterations, "
        f"solves {json.dumps(r.solves)}")
    prog.release()
    if cuda:
        torch.cuda.empty_cache()

    reference = spec.reference(cell.config["reference"], cell.root)
    limits = cell.check["limits"]
    names = list(limits) + [e for e in extra if e not in limits]
    t = time.perf_counter()
    values = prog.numbers(reference, names)
    out_control = prog.numbers(reference, list(limits), control=True) if control else None
    log(f"check: {time.perf_counter() - t:.3f} s")
    correct = (prog.failed == 0 and bool(r.solves) and checks.judge(values, limits))

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(r)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    device_rec = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": cell.chips,
                  "memory_peak_bytes": peak}
    if trace:
        device_rec["busy_s"] = r.busy_s
        device_rec["window_s"] = r.trace_window_s
    result = {"correct": correct, "attempted": len(r.solves), "failed": prog.failed,
              "metrics": metrics, "device": device_rec}
    if trace and r.breakdown:
        result["breakdown"] = r.breakdown
    if extra:
        result["readings"] = {k: values[k] for k in names if k not in limits}
    if out_control is not None:
        result["control"] = out_control
        result["control_correct"] = checks.judge(out_control, limits)
    result["checks"] = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    return result


def finite(obj):
    """``obj`` with every non-finite float as None (JSON has no infinity)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_env(root):
    """Every build and kernel cache of the process inside the checkout, at
    fixed paths (the program's own library goes to ``build/`` there)."""
    base = root / "build" / "portbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        cell = spec.cell(args.workload)
    except spec.SpecError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    cache_env(spec.ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"card: {card_line()}")
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start, log=log)
    found = forbidden_modules()
    if found:
        log(f"portbench: the process holds {', '.join(found)}")
        return 3
    log(f"correct: {result['correct']}")
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(finite(result)), flush=True)
    return 0
