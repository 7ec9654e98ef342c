"""apply_host_us.solve: host microseconds per operator apply
(``rlaopt.linop.matmat``: the operator, the dispatch and the CUDA wrapper up
to the launch's return), less the host syncs inside it, mean over the
window's applies. Read from the program's spans."""

from portbench.spans import apply_host_us, record

UNIT = "us"
LAYER = "wrappers"
MOVES = "solve_s"


def read(run):
    spans = record()
    return apply_host_us(spans) if spans else None
