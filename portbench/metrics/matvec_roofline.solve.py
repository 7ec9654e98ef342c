"""matvec_roofline.solve: the window's symmetric Gram matvecs (PCG's and
the correction solves'), their least time over their device time. At the
exact tier and k = 1 the float32 operations outside the tensor cores bound
it (6.567 ms at n = 100,000)."""

from portbench.readers import roofline

UNIT = "%"
LAYER = "kernels"
MOVES = "solve_s"


def read(run):
    return roofline(run, "matvec")
