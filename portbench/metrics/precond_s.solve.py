"""precond_s.solve: mean ``phase_walls["solver_init"]`` of the window's
solves: the Nyström sketch K(X, X)Ω, its QR, Cholesky and eigh."""

from portbench.readers import mean

UNIT = "s"
LAYER = "preconditioners"
MOVES = "solve_s"


def read(run):
    return mean(s.get("phase_walls", {}).get("solver_init") for s in run.solves)
