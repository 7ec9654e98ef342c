"""The judgement that decides ``correct``.

A cell's file in ``checks/`` names the numbers its check compares, each
with its limit (``limits``), the rows the reference reads (``rows``: all of
them when null), the control (``control``) and the readings each limit was
set from (``readings``). The cell's program (``programs/<name>.py``) works
the numbers out after the window has closed, with its configuration's plain
reference in float64; each number reads 0 for a perfect answer and grows
with the error, and a number that could not be read is infinite.
"""

import math


def judge(values: dict, limits: dict) -> bool:
    """Every number finite and within its limit."""
    return all(math.isfinite(values.get(k, math.inf)) and values[k] <= lim
               for k, lim in limits.items())
