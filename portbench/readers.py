"""Arithmetic that several metric readers share (``metrics/<name>.py``)."""

from .peaks import bound_ms


def mean(values):
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def roofline(run, op: str):
    """The operation's least time over its device time, in %, summed over the
    traced window's applies of that operation; None without any. Each
    apply's record names the work it counts as (``kernel``, ``kind``, ``cd``
    and its shapes), which its program decides."""
    ops = [o for o in run.ops if o["op"] == op]
    if not ops:
        return None
    bound = sum(bound_ms(o["kernel"], o["n"], o["m"], o["d"], o["k"], o["kind"], o["cd"])[0]
                for o in ops)
    return 100.0 * bound / sum(o["device_ms"] for o in ops)


def idle_share(run):
    """The traced window's share (%) in which the device ran no operation."""
    if not run.busy_s or not run.trace_window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.trace_window_s)
