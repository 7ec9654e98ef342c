"""sketch_roofline.solve: the Nyström sketch K(X, X)Ω at k = rank, its
least time over its device time. The TF32 tensor cores' contraction, the
rate that meets the exact tier with three passes, bounds it (60.606 ms at
n = 100,000, k = 500)."""

from portbench.readers import roofline

UNIT = "%"
LAYER = "kernels"
MOVES = "solve_s"


def read(run):
    return roofline(run, "sketch")
