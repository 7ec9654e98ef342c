"""syncs.sap: the program's host syncs with the card (``rlaopt.sync.*`` spans
on CUDA: the block uploads, the block Nystrom's, the sampled metrics' and
the logger's) per SAP step (``rlaopt.sap.step``) in the window. Read from
the program's spans."""

from portbench.spans import SYNC, record

UNIT = "syncs/iter"
LAYER = "solvers"
MOVES = "iter_s"


def per_step(spans):
    """Syncs on CUDA over SAP steps; None without a step."""
    steps = sum(1 for s in spans if s["name"] == "rlaopt.sap.step")
    if not steps:
        return None
    return sum(1 for s in spans if s["name"].startswith(SYNC) and s["device"] == "cuda") / steps


def read(run):
    spans = record()
    return per_step(spans) if spans else None
