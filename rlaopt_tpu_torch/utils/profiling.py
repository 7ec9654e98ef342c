"""Profiling and tracing.

Port of ``rlaopt_tpu/utils/profiling.py`` onto ``torch.profiler``:

* :func:`trace` records a trace of the host and, where a CUDA card is
  present, of the card, and writes it as a Chrome trace file that opens in
  Perfetto (``ui.perfetto.dev``) or ``chrome://tracing``, with the
  program's spans and counters beside it;
* :func:`annotate` names a span of the program: in that trace
  (``record_function``) and in an in-memory record;
* :class:`Profiler` accumulates named wall-clock phases, synchronizing the
  card at the end of each phase so that a phase's time holds the work it
  queued there and not only the time it took to queue it.

Tracing is on exactly while a ``torch.profiler`` profile records in this
process (``trace`` opens one). Then every span of the program opens a
``record_function`` range, so that it sits in the profiler's trace on the
clock of the card's kernels, and appends one record: its name, start and
end (``time.perf_counter_ns``), its id, its parent's id and the id of the
outermost ``rlaopt.linsys.solve`` it belongs to (correction solves share
their outer solve's). A span opened on a CUDA device
(``annotate(name, device)``) also records a CUDA event on the device's
current stream at its entry and at its exit: its record carries the
device's milliseconds between the two (its work and any idle gap inside
it), read when the spans are. Counters (:func:`count`, :func:`add_ns`)
sit beside the spans; an increment that is a tensor on the card is kept as
it is and added when the counters are read, so that counting never waits
for the card. :func:`spans`, :func:`counters` and :func:`summary` read the
record; :func:`reset` clears it. Off, a span or a counter costs one flag
check: no allocation, no ``record_function``.
"""

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict

import torch

from ._tree import leaves


__all__ = ["Profiler", "trace", "annotate"]

# ``torch.profiler`` sets this flag while a profile records in the process.
_ap = torch.autograd.profiler
_OFF = contextlib.nullcontext()

SOLVE = "rlaopt.linsys.solve"
MAX_SPANS = 1_000_000  # raw span records kept; the summary and counters stay exact


class _Record:
    """The spans and counters recorded since the last :func:`reset`."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        # (name, start_ns, end_ns, id, parent, solve, device, error, events)
        self.spans = []
        self.dropped = 0
        self.counters = defaultdict(int)
        self.pending = defaultdict(list)  # name -> increments held as tensors
        self.summary = {}  # name -> [calls, total_ns, self_ns]


_record = _Record()
_local = threading.local()  # each thread's stack of open spans


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One open span (see the module's docstring)."""

    __slots__ = ("name", "device", "id", "solve", "_up", "_rf", "_start", "_child_ns",
                 "_events")

    def __init__(self, name: str, device=None, events=None):
        self.name, self.device, self._events = name, device, events

    def __enter__(self):
        stack = _stack()
        up = self._up = stack[-1] if stack else None
        self.id = next(_record.ids)
        self.solve = up.solve if up is not None else None
        if self.solve is None and self.name == SOLVE:
            self.solve = self.id
        self._child_ns = 0
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        stack.append(self)
        if self._events is not None:
            self._events[0].record(self._events[2])
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(self._events[2])
        _stack().pop()  # spans nest: ``with`` closes them in turn
        self._rf.__exit__(exc_type, exc, tb)
        ns = end - self._start
        up = self._up
        if up is not None:
            up._child_ns += ns
        row = (self.name, self._start, end, self.id, None if up is None else up.id,
               self.solve, self.device, exc_type is not None, self._events)
        with _record.lock:
            s = _record.summary.get(self.name)
            if s is None:
                s = _record.summary[self.name] = [0, 0, 0]
            s[0] += 1
            s[1] += ns
            s[2] += ns - self._child_ns
            if len(_record.spans) < MAX_SPANS:
                _record.spans.append(row)
            else:
                _record.dropped += 1
        return False


def annotate(name: str, device=None):
    """A named span of the program (a context manager): a profiler range and
    a record while tracing is on, nothing otherwise. On a CUDA ``device``
    (or a tensor's) the record also carries the device's time inside it."""
    if not _ap._is_profiler_enabled:
        return _OFF
    device = getattr(device, "device", device)
    if device is None or torch.device(device).type != "cuda":
        return _Span(name)
    events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True),
              torch.cuda.current_stream(device))
    return _Span(name, events=events)


def annotate_sync(name: str, t):
    """The span of a host read that waits for the device of tensor ``t`` (or
    for the device ``t``), named ``rlaopt.sync.<site>`` and recorded with
    that device's type."""
    if not _ap._is_profiler_enabled:
        return _OFF
    return _Span(name, getattr(t, "device", t).type)


def traced(name: str):
    """Decorator: each call of the function is a span named ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _ap._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return spanned

    return wrap


def host_counted(prefix: str):
    """Decorator: while tracing is on, each call adds its host nanoseconds,
    from entry to return, to the counter ``<prefix>.host_ns`` and one to
    ``<prefix>.calls``."""
    host_ns, calls = f"{prefix}.host_ns", f"{prefix}.calls"

    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            if not _ap._is_profiler_enabled:
                return fn(*args, **kwargs)
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                add_ns(host_ns, time.perf_counter_ns() - t0)
                count(calls)

        return counted

    return wrap


def recording() -> bool:
    """Whether tracing is on: a ``torch.profiler`` profile records."""
    return _ap._is_profiler_enabled


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on. ``n`` may be
    a 0-d tensor (on the card): it is read when the counters are."""
    if _ap._is_profiler_enabled:
        with _record.lock:
            if isinstance(n, torch.Tensor):
                _record.pending[name].append(n)
            else:
                _record.counters[name] += n


def add_ns(name: str, ns: int) -> None:
    """Add ``ns`` nanoseconds to the counter ``name`` while tracing is on."""
    count(name, ns)


def spans() -> list:
    """The recorded spans, in the order they closed: dicts of ``name``,
    ``start_ns``, ``end_ns``, ``id``, ``parent`` and ``solve`` (ids, None
    where there is none), ``device`` (a sync span's device type, else None),
    ``error`` (closed by an exception) and ``device_ms`` (a span opened on a
    CUDA device: the device's milliseconds between its entry and its exit,
    waited for here; else None)."""
    keys = ("name", "start_ns", "end_ns", "id", "parent", "solve", "device", "error")
    with _record.lock:
        rows = list(_record.spans)
    return [dict(zip(keys, row), device_ms=_elapsed_ms(row[-1])) for row in rows]


def _elapsed_ms(events):
    """Milliseconds between a span's two CUDA events, once the second has
    completed; None for a span without them."""
    if events is None:
        return None
    events[1].synchronize()
    return events[0].elapsed_time(events[1])


def dropped() -> int:
    """Spans closed past ``MAX_SPANS`` and so left out of :func:`spans`."""
    return _record.dropped


def counters() -> dict:
    """Each counter's total, its increments held as tensors read (and so
    waited for) here."""
    with _record.lock:
        out = dict(_record.counters)
        pending = {name: list(ts) for name, ts in _record.pending.items()}
    for name, ts in pending.items():
        out[name] = out.get(name, 0) + sum(int(t) for t in ts)
    return out


def summary() -> dict:
    """Per span name: ``calls``, ``total_s`` and ``self_s`` (the spans'
    seconds less those of the spans directly inside them), exact past
    ``MAX_SPANS``."""
    with _record.lock:
        return {name: {"calls": c, "total_s": t / 1e9, "self_s": s / 1e9}
                for name, (c, t, s) in _record.summary.items()}


def reset() -> None:
    """Clear the record; spans still open close into the cleared one. Span
    ids keep counting, so they stay unique in the process."""
    with _record.lock:
        _record.spans, _record.dropped = [], 0
        _record.counters, _record.summary = defaultdict(int), {}
        _record.pending = defaultdict(list)


def _dump() -> dict:
    return {"spans": spans(), "dropped": dropped(), "counters": counters(),
            "summary": summary()}


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_link: bool = False):
    """Record a trace of the enclosed code into ``log_dir``.

    Usage::

        with rlaopt_tpu_torch.utils.trace("/tmp/rlaopt_trace"):
            model.solve(...)

    On entry the record of spans and counters is cleared. On exit a Chrome
    trace file (``trace_<pid>_<ns>.json``) is written under ``log_dir``; it
    opens in Perfetto. Beside it ``spans_<pid>_<ns>.json`` holds the
    program's spans, counters and per-name summary. ``create_perfetto_link``
    is taken for the JAX package's callers and changes nothing: the file is
    the link.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    reset()
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        stamp = f"{os.getpid()}_{time.time_ns()}"
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}.json"))
        with open(os.path.join(log_dir, f"spans_{stamp}.json"), "w") as f:
            json.dump(_dump(), f)


def _sync(tree) -> None:
    devices = {x.device for x in leaves(tree) if isinstance(x, torch.Tensor) and x.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


class Profiler:
    """Accumulating named phase timer.

    ``phase(name, result=None)`` yields a dict; with ``block=True``, on exit
    it synchronizes the CUDA devices of every tensor among the leaves of its
    ``"sync"`` entry (``result`` when there is none) before it reads the
    clock. On the CPU that is a no-op.
    """

    def __init__(self, block: bool = True):
        self.block = block
        self.times: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        t0 = time.perf_counter()
        out = {}
        try:
            yield out
        finally:
            if self.block:
                _sync(out.get("sync", result))
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": self.times[k], "count": self.counts[k]}
            for k in self.times
        }

    def reset(self) -> None:
        self.times.clear()
        self.counts.clear()
