"""oracle_roofline.sap: SAP's row-oracle applies K[blk, :] @ V (one per
``rlaopt.sap.row_oracle`` span: 10^5 rows against 10^7 columns, k = 10, at
the bf16x3 tier), their least time over their mean device time (CUDA events
around each apply of the window). The float32 contraction bounds it
(343.3 ms)."""

from portbench.readers import roofline

UNIT = "%"
LAYER = "kernels"
MOVES = "iter_s"


def read(run):
    return roofline(run, "row_oracle")
