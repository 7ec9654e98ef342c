"""What the traced run reads from ``torch.profiler``.

The harness opens the range ``portbench.window`` around the measured window
and, from outside the program, ``portbench.*`` ranges around each solve and
each operator apply. From the profiler's events this
module takes the device's busy time inside the window (the union of its
kernel, copy and fill intervals), the device operations that took most time
(grouped by ``profgroup``), and the device's idle time by what the host was
doing when each gap began (the innermost host event open at that moment).
"""

from collections import defaultdict

from .profgroup import _kernel_group

WINDOW = "portbench.window"
TOP = 10


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA


def _host_name(name: str) -> str:
    """A range's name without its index (``portbench.apply.12`` is
    ``portbench.apply``)."""
    head, _, tail = name.rpartition(".")
    return head if name.startswith("portbench.") and tail.isdigit() else name


def merge(intervals):
    """Sorted, disjoint unions of ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(busy, w0, w1):
    """The idle intervals of ``[w0, w1]`` between merged busy intervals."""
    out, t = [], w0
    for a, b in busy:
        if a > t:
            out.append((t, min(a, w1)))
        t = max(t, b)
    if t < w1:
        out.append((t, w1))
    return [(a, b) for a, b in out if b > a]


def host_at(host_events, times):
    """For each time (ascending), the name of the innermost host event open
    then, from ``(start, end, name)`` events of one thread that nest; None
    where none is open."""
    host_events = sorted(host_events, key=lambda e: (e[0], -e[1]))
    names, stack, k = [], [], 0
    for t in times:
        while k < len(host_events) and host_events[k][0] <= t:
            while stack and stack[-1][1] <= host_events[k][0]:
                stack.pop()
            stack.append(host_events[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        names.append(stack[-1][2] if stack else None)
    return names


def summarize(device, host, w0, w1):
    """Busy seconds, window seconds and the breakdown, from device events
    ``(start_us, end_us, name)`` and the window thread's host events
    ``(start_us, end_us, name)``, inside the window ``[w0, w1]`` (us)."""
    inside = [(max(a, w0), min(b, w1), name) for a, b, name in device if b > w0 and a < w1]
    busy = merge((a, b) for a, b, _ in inside)
    busy_us = sum(b - a for a, b in busy)
    ops = defaultdict(float)
    for a, b, name in inside:
        group = _kernel_group(name)
        ops[group if group != "other" else name[:120]] += (b - a) / 1e6
    idle = gaps(busy, w0, w1)
    names = host_at([e for e in host if e[2] != WINDOW], [a for a, _ in idle])
    by_host = defaultdict(float)
    for (a, b), name in zip(idle, names):
        by_host[_host_name(name) if name else "host outside any event"] += (b - a) / 1e6
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "breakdown": {"device_ops": _top(ops), "idle_gaps": _top(by_host)},
    }


def _top(seconds: dict) -> list:
    return sorted(([k, v] for k, v in seconds.items()), key=lambda kv: -kv[1])[:TOP]


def read(prof):
    """:func:`summarize` of a profiler run that holds one ``WINDOW`` range;
    None if it holds no device event inside the window."""
    events = prof.events()
    window = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not window:
        return None
    w = window[0]
    w0, w1 = w.time_range.start, w.time_range.end
    device, host = [], []
    for e in events:
        if _is_device(e):
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("portbench.")):
                device.append((e.time_range.start, e.time_range.end, e.name))
        elif e.thread == w.thread and not getattr(e, "is_async", False):
            host.append((e.time_range.start, e.time_range.end, e.name))
    out = summarize(device, host, w0, w1)
    return out if out["busy_s"] > 0 else None

