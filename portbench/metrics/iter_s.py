"""iter_s: the window's seconds over all the PCG iterations done in it,
the work at its logging boundaries included."""

UNIT = "s/iter"


def read(run):
    return run.window_s / run.iterations if run.iterations else None
