"""syncs.solve: the program's host syncs with the card (``rlaopt.sync.*``
spans on CUDA: each ``torch.linalg.solve`` of PCG's α and β, the breakdown
check, the logger, the metrics, the refinement's reads) per PCG step
(``rlaopt.pcg.step``), base and correction solves, in the window."""

from portbench.spans import record, syncs_per_step

UNIT = "syncs/iter"
LAYER = "solvers"
MOVES = "solve_s"


def read(run):
    spans = record()
    return syncs_per_step(spans) if spans else None
