"""boundary_s.iters: the seconds of the window's logging boundaries
(``rlaopt.model.boundary``: the recurrence residual and the confirms' K1c
triangles) over its PCG iterations. Read from the program's spans."""

from portbench.spans import boundary_s, record

UNIT = "s/iter"
LAYER = "metrics"
MOVES = "iter_s"


def read(run):
    spans = record()
    if not spans or not run.iterations:
        return None
    return boundary_s(spans) / run.iterations
