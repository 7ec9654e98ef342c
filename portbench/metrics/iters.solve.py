"""iters.solve: PCG iterations per solve of the window (the base solve's,
its last logging boundary)."""

from portbench.readers import mean

UNIT = "iters"
LAYER = "solvers"
MOVES = "solve_s"


def read(run):
    return mean(s["iters"] for s in run.solves if s["completed"])
