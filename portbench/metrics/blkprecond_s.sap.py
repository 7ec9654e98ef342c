"""blkprecond_s.sap: the card's seconds inside SAP's block preconditioner
(``rlaopt.sap.precond``: the block oracle, the Nystrom sketch and its
factorization) and stepsize (``rlaopt.sap.stepsize``: the power iteration)
per SAP step (``rlaopt.sap.step``). Each span carries the card's time
between CUDA events recorded at its entry and exit (the power iteration's
span returns before its work is done, so its host time is not the card's).
Read from the program's spans."""

from portbench.spans import record

UNIT = "s/iter"
LAYER = "preconditioners"
MOVES = "iter_s"
PHASES = ("rlaopt.sap.precond", "rlaopt.sap.stepsize")


def per_step(spans):
    """Seconds of the phases' device time over the steps; None without a
    step or where a phase span carries no device time."""
    steps = sum(1 for s in spans if s["name"] == "rlaopt.sap.step")
    phases = [s.get("device_ms") for s in spans if s["name"] in PHASES]
    if not steps or not phases or any(ms is None for ms in phases):
        return None
    return sum(phases) / 1e3 / steps


def read(run):
    spans = record()
    return per_step(spans) if spans else None
