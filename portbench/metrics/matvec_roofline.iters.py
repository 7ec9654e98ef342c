"""matvec_roofline.iters: the window's symmetric Gram matvecs at the bf16x3
tier, their least time over their device time. The special-function unit's
exps bound it (119.567 ms at n = 1,000,000, k = 1)."""

from portbench.readers import roofline

UNIT = "%"
LAYER = "kernels"
MOVES = "iter_s"


def read(run):
    return roofline(run, "matvec")
