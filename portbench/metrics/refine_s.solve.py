"""refine_s.solve: mean seconds of the float64 refinement per solve
(``log["f64_refine"]["phase_walls"]``: residuals and correction solves)."""

from portbench.readers import mean

UNIT = "s"
LAYER = "refinement"
MOVES = "solve_s"


def read(run):
    return mean(s.get("refine_s") for s in run.solves)
