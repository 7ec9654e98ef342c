"""What the traced run reads from the program's own record of spans and
counters (``rlaopt_tpu_torch.utils.profiling``: ``spans()``, ``counters()``).

The port records while a ``torch.profiler`` profile records in its process,
and the traced run's profiler covers the window alone, so the record holds
the window's spans and nothing else. A program that keeps no such record
(an older port) or a record that is empty reads as None.
"""

from collections import defaultdict

SOLVE = "rlaopt.linsys.solve"
BOUNDARY = "rlaopt.model.boundary"
STEP = "rlaopt.pcg.step"
MATMAT = "rlaopt.linop.matmat"
SYNC = "rlaopt.sync."


def record():
    """The program's spans (dicts of ``name``, ``start_ns``, ``end_ns``,
    ``id``, ``parent``, ``solve``, ``device``, ``error``), or None."""
    try:
        from rlaopt_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return (spans() or None) if spans is not None else None


def seconds(span) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e9


def boundary_s_per_solve(spans):
    """Mean over the record's outer solves that ran to their end (a solve's
    own span, not closed by an exception) of the seconds of their logging
    boundaries, a correction solve's counted in its outer solve; None
    without such a solve."""
    done = {s["id"] for s in spans if s["name"] == SOLVE and s["solve"] == s["id"]
            and not s["error"]}
    if not done:
        return None
    total = defaultdict(float)
    for s in spans:
        if s["name"] == BOUNDARY and s["solve"] in done:
            total[s["solve"]] += seconds(s)
    return sum(total[j] for j in done) / len(done)


def boundary_s(spans) -> float:
    """Seconds of every logging boundary in the record."""
    return sum(seconds(s) for s in spans if s["name"] == BOUNDARY)


def syncs_per_step(spans):
    """Host syncs with the card (``rlaopt.sync.*`` spans on CUDA) over PCG
    steps; None without a step."""
    steps = sum(1 for s in spans if s["name"] == STEP)
    if not steps:
        return None
    return sum(1 for s in spans if s["name"].startswith(SYNC) and s["device"] == "cuda") / steps


def apply_host_us(spans):
    """Mean host microseconds of an operator apply (``rlaopt.linop.matmat``)
    less the host syncs inside it (the outermost ``rlaopt.sync.*`` spans
    under it); None without an apply."""
    by_id = {s["id"]: s for s in spans}
    applies = {s["id"]: seconds(s) for s in spans if s["name"] == MATMAT}
    if not applies:
        return None
    for s in spans:
        if not s["name"].startswith(SYNC):
            continue
        up = by_id.get(s["parent"])
        while up is not None and not up["name"].startswith(SYNC) and up["id"] not in applies:
            up = by_id.get(up["parent"])
        if up is not None and up["id"] in applies:
            applies[up["id"]] -= seconds(s)
    return 1e6 * sum(applies.values()) / len(applies)
