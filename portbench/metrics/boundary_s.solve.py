"""boundary_s.solve: the seconds a whole solve spends at its logging
boundaries (``rlaopt.model.boundary``: the logger's sync, the callback, the
true residual through K1c, the termination check), its correction solves'
included, mean over the window's solves that ran to their end. Read from
the program's spans."""

from portbench.spans import boundary_s_per_solve, record

UNIT = "s"
LAYER = "metrics"
MOVES = "solve_s"


def read(run):
    spans = record()
    return boundary_s_per_solve(spans) if spans else None
