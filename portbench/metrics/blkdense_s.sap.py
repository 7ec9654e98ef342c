"""blkdense_s.sap: the card's seconds inside the operator's dense block
(``rlaopt.linop.blk_dense``: K[blk, blk] materialized once a step, inside
SAP's ``rlaopt.sap.precond``, where the block's tile fits SAP's budget) per
SAP step (``rlaopt.sap.step``). The span carries the card's time between
CUDA events recorded at its entry and exit. Read from the program's spans;
None where no such span carries the card's time (a matrix-free block, a
CPU run, or a port without the span)."""

from portbench.spans import record

UNIT = "s/iter"
LAYER = "operator"
MOVES = "iter_s"
SPAN = "rlaopt.linop.blk_dense"


def per_step(spans):
    """Seconds of the dense blocks' device time over the steps; None
    without a step, without a dense block, or where one carries no device
    time."""
    steps = sum(1 for s in spans if s["name"] == "rlaopt.sap.step")
    blocks = [s.get("device_ms") for s in spans if s["name"] == SPAN]
    if not steps or not blocks or any(ms is None for ms in blocks):
        return None
    return sum(blocks) / 1e3 / steps


def read(run):
    spans = record()
    return per_step(spans) if spans else None
