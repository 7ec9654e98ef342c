"""Profiling and tracing.

Port of ``rlaopt_tpu/utils/profiling.py`` onto ``torch.profiler``:

* :func:`trace` records a trace of the host and, where a CUDA card is
  present, of the card, and writes it as a Chrome trace file that opens in
  Perfetto (``ui.perfetto.dev``) or ``chrome://tracing``;
* :func:`annotate` names a span in that trace (``record_function``);
* :class:`Profiler` accumulates named wall-clock phases, synchronizing the
  card at the end of each phase so that a phase's time holds the work it
  queued there and not only the time it took to queue it.
"""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

from ._tree import leaves


__all__ = ["Profiler", "trace", "annotate"]


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_link: bool = False):
    """Record a trace of the enclosed code into ``log_dir``.

    Usage::

        with rlaopt_tpu_torch.utils.trace("/tmp/rlaopt_trace"):
            model.solve(...)

    On exit a Chrome trace file (``trace_<pid>_<ns>.json``) is written under
    ``log_dir``; it opens in Perfetto. ``create_perfetto_link`` is taken
    for the JAX package's callers and changes nothing: the file is the link.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)


def annotate(name: str):
    """A named span in profiler traces (a context manager)."""
    return torch.profiler.record_function(name)


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
