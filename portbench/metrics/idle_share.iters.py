"""idle_share.iters: the share of the traced window in which the device ran
no operation (1 − the union of its busy intervals over the window)."""

from portbench.readers import idle_share

UNIT = "%"
LAYER = "device"
MOVES = "iter_s"


def read(run):
    return idle_share(run)
