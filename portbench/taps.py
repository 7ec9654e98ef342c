"""Taps on the port's public objects, set from outside the program by
attributes of the objects a program module made: an operator's ``matmat``
(:class:`Probe`) and a ``LinSys``'s callback and boundary metrics
(:class:`Observer`). A program module (``programs/<name>.py``) builds its
objects and puts these on them.
"""

import random
import time

from . import data


class WindowClosed(Exception):
    """Raised from a solve's callback at the boundary that ends the window."""


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Probe:
    """Taps an operator's ``matmat``. While on, it names each apply by
    ``name_of(V)``, keeps one apply named ``"matvec"`` drawn from the seed
    (reservoir) and the last one, and in a traced run times every apply
    with CUDA events inside a profiler range."""

    def __init__(self, K, name_of, seed: int, traced: bool):
        self._mm = K.matmat
        K.matmat = self.matmat
        self.name_of, self.traced, self.on = name_of, traced, False
        self._rng = random.Random(data.stream_seed(seed, "apply_sample"))
        self.seen, self.sample, self.last = 0, None, None
        self.timed = []  # (op, k, start event, end event)

    def matmat(self, V):
        if not self.on:
            return self._mm(V)
        op = self.name_of(V)
        if self.traced:
            import torch

            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            with torch.profiler.record_function(f"portbench.apply.{len(self.timed)}"):
                ev[0].record()
                Y = self._mm(V)
                ev[1].record()
            self.timed.append((op, V.shape[1], *ev))
        else:
            Y = self._mm(V)
        if op == "matvec":
            self.seen += 1
            if self._rng.randrange(self.seen) == 0:
                self.sample = (V, Y)
            self.last = (V, Y)
        return Y

    def kept(self) -> list:
        if self.last is None:
            return []
        return [self.last] if self.sample is self.last else [self.sample, self.last]

    def release(self):
        self._mm = None


class Observer:
    """One solve's callback and metrics tap: keeps the iterate and the
    logged ``rel_res`` of every logging boundary in ``kept``. With a
    deadline, it raises :class:`WindowClosed` at the first boundary past 0
    at or after it, and not before boundary ``hold``."""

    def __init__(self, system, j, freq, max_iters, kept, deadline=None, hold=0):
        self.j, self.freq, self.max_iters = j, freq, max_iters
        self.kept, self.deadline, self.hold, self.i = kept, deadline, hold, None
        metrics = system._compute_internal_metrics

        def tap(W, force_true=False):
            m = metrics(W, force_true=force_true)
            self.kept[-1]["logged"] = m["rel_res"].tolist()
            return m

        system._compute_internal_metrics = tap

    def __call__(self, W, _model):
        self.i = 0 if self.i is None else min(self.i + self.freq, self.max_iters)
        self.kept.append({"solve": self.j, "i": self.i,
                          "W": W.detach().clone() if self.i else None, "logged": None})
        if (self.deadline is not None and self.i and self.i >= self.hold
                and time.perf_counter() >= self.deadline):
            raise WindowClosed
