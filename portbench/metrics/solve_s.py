"""solve_s: the window's seconds, from its start to the end of its last
solve, over the solves in it (every solve that starts finishes)."""

UNIT = "s"


def read(run):
    if run.loop != "solves" or not run.solves:
        return None
    return run.window_s / len(run.solves)
