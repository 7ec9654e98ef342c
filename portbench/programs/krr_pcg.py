"""Kernel ridge regression by preconditioned CG through the port's public
entry point: the program of every configuration whose ``program`` is
``krr_pcg``.

The configuration names the kernel (any kind of the port's
``KernelLinOp``), its lengthscale and tier, the regulariser ``reg_per_n·n``,
the solver (``pcg``), its preconditioner (``nystrom``) and the float64
refinement. Set-up makes the data on the device from the seed, builds the
operator (and, for traffic with ``"preconditioner": "prebuilt"``, the
preconditioner) and warms up every shape the window uses with a shortened
solve. The window drives ``LinSys(K, y_j, reg).solve(...)``, a fresh target
``y_j`` per solve, one solve at a time; the traffic's ``loop`` says how it
ends:

``"solves"``
    Solves start while the window's clock is under ``--seconds``, and every
    solve that starts finishes.
``"iterations"``
    The window ends at the first logging boundary at or after
    ``--seconds``, and not before the window's first solve has reached the
    deepest boundary a check number reads (``res_at.<i>``): the callback
    raises there and keeps the iterate it was given. A solve that ends
    first is followed by the next.

The check's numbers (``numbers``), judged by the configuration's plain
reference (``reference/<name>.py``: ``gram_apply(X, rows, V, lengthscale,
dtype, tf32)``, float64 unless asked):

``apply_err``
    For the operator applies the window kept (one drawn from the seed and
    the last one), ``max|Y - K V| / max(K |V|)`` over the checked rows: the
    Gram apply at the configuration's tier. The scale is the sum of the
    terms' sizes (K >= 0), which bounds a float sum's rounding; ``max|K V|``
    would swing with the cancellation in a solver's late directions.
``res_gap``
    For every logging boundary whose iterate and logged ``rel_res`` the
    window kept, ``|logged - true| / true``, the true relative residual of
    the same iterate from the reference: the iterate and the residual the
    program reports.
``res_err``
    The same, ``|logged - true|`` itself: both are shares of ``|y|``, and a
    residual evaluated in float32 is off by a share of ``|y|`` (its last
    subtraction's rounding), not of the residual.
``res_at.<i>``
    The largest true relative residual of the iterate each solve holds at
    iteration ``i`` (its last, where it ended before ``i``), over the
    window's solves that got that far: progress, at a depth that does not
    depend on how fast the program runs.
``cert_gap``
    For every refined solve, the same gap for the final certified
    ``rel_res_f64`` and the delivered float64 solution.
``refined_res``
    The largest true relative residual of a delivered float64 solution.

The checked rows are all n, or a number drawn from the seed (the check's
``rows``); the true relative residual is then the estimate from those rows.
With ``control``, the numbers are those the reference in TF32 reads in the
program's place, from the same kept inputs: the control of an exact float32
configuration (``"control": "tf32_reference"``).
"""

import contextlib
import dataclasses
import math
import time
import traceback
from dataclasses import dataclass, field

import torch

from portbench import data
from portbench.harness import Run
from portbench.spec import SpecError
from portbench.taps import Observer, Probe, WindowClosed, sync

# The wrapper whose work an apply is counted as (``peaks.bound_ms``), by the
# apply and whether the configuration runs a bf16 tier: the symmetric matvec
# counts each distinct Gram value once; the sketch is the general product.
KERNEL = {("matvec", False): "gram_matvec_symmetric",
          ("matvec", True): "gram_matvec_symmetric_tier",
          ("sketch", False): "gram_matmat", ("sketch", True): "gram_matmat_tier"}


def _depth(name: str):
    """``i`` of a number named ``res_at.<i>``, else None."""
    head, _, i = name.partition(".")
    return int(i) if head == "res_at" and i.isdigit() else None


@dataclass
class Kept:
    """What the window produced that the check judges."""

    ys: list = field(default_factory=list)
    applies: list = field(default_factory=list)  # (V, K @ V)
    iterates: list = field(default_factory=list)  # solve, i, W, logged rel_res
    finals: list = field(default_factory=list)  # solve, W64, claimed rel_res_f64
    ended: dict = field(default_factory=dict)  # solve -> whether it ran to its end


class Program:
    """The program under one cell's configuration and traffic."""

    def __init__(self, cell, seed: int, device, traced: bool, log=print):
        import rlaopt_tpu_torch  # noqa: F401
        from rlaopt_tpu_torch.kernels import KERNEL_KINDS, KernelConfig, KernelLinOp
        from rlaopt_tpu_torch.ops import kernel_cuda
        from rlaopt_tpu_torch.preconditioners import Nystrom, NystromConfig
        from rlaopt_tpu_torch.solvers import PCGConfig

        c, t = cell.config, cell.traffic
        if c["kernel"] not in KERNEL_KINDS or c["solver"]["name"] != "pcg" or (
                c["preconditioner"]["name"] != "nystrom"):
            raise SpecError("krr_pcg drives a kernel of the port by Nyström-PCG")
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            lib = kernel_cuda.build()
            log(f"build: {time.perf_counter() - t0:.3f} s ({lib.name})")
        self.loop, self.columns = t["loop"], int(t["columns"])
        n, d = int(c["n"]), int(c["d"])
        self.n, self.d = n, d
        self.kind, self.cd = c["kernel"], c["compute_dtype"]
        self.reg = c["reg_per_n"] * n
        self.ls = float(c["lengthscale"])
        self.noise = float(c["data"]["noise"])
        s, p = c["solver"], c["preconditioner"]
        self.freq, self.rank = s["callback_freq"], p["rank"]
        self.pcg = PCGConfig(max_iters=s["max_iters"], rtol=s["rtol"],
                             precond_config=NystromConfig(rank=p["rank"],
                                                          rho=p["rho_per_n"] * n))
        r = c.get("refine") or {}
        self.refine = {} if not r.get("rounds") else {
            "f64_refine_rounds": r["rounds"], "f64_refine_device": r["device"],
            "f64_refine_residual": r["residual"], "f64_refine_certify": r["certify"]}
        depths = [_depth(k) for k in cell.check["limits"]]
        self.hold = max([i for i in depths if i is not None], default=0)
        # traffic with a "data_seed" draws every seed's points and targets
        # from it; the run's seed then draws each target's sign
        self.signed = "data_seed" in t
        self.data_seed = t["data_seed"] if self.signed else seed
        t0 = time.perf_counter()
        self.X = data.points(self.data_seed, n, d, self.device)
        self.K = KernelLinOp(self.X, self.X, KernelConfig(lengthscale=self.ls), kind=self.kind,
                             compute_dtype=self.cd)
        self.probe = Probe(self.K, lambda V: "sketch" if V.shape[1] == self.rank else "matvec",
                           seed, traced)
        self.P = None
        if t["preconditioner"] == "prebuilt":
            self.P = Nystrom(self.pcg.precond_config)
            self.P._update(self.K, key=c["key"])
            self.P._update_damping(baseline_rho=self.reg)
        sync(self.device)
        log(f"set-up: data, operator and preconditioner {time.perf_counter() - t0:.3f} s")
        self.kept = Kept()
        self.run = Run(self.loop)
        self.failed = 0

    def _solve(self, y, j, cfg, kept, deadline=None, traced=False, hold=0):
        """One solve of target y; returns the solve's record."""
        from rlaopt_tpu_torch.models import LinSys

        system = LinSys(self.K, y, reg=self.reg)
        obs = Observer(system, j, self.freq, cfg.max_iters, kept, deadline, hold)
        rec = {"j": j, "completed": False}
        rf = (torch.profiler.record_function(f"portbench.solve.{j}") if traced
              else contextlib.nullcontext())
        try:
            with rf:
                W, log = system.solve(
                    cfg, torch.zeros_like(y), callback_fn=obs, callback_freq=self.freq,
                    key=self.cell.config["key"], preconditioner=self.P,
                    metrics=self.cell.config["solver"]["metrics"], **self.refine)
            rec["completed"] = True
            rec["phase_walls"] = dict(system.phase_walls)
            if "f64_refine" in log:
                walls = log["f64_refine"]["phase_walls"]
                rec["refine_s"] = sum(walls["residual_f64"]) + sum(walls["correction_solve"])
                rec["W64"], rec["claim"] = W, log["f64_refine"]["rel_res_f64"][-1]
        except WindowClosed:
            sync(self.device)
        rec["iters"] = obs.i or 0
        return rec

    def warm_up(self):
        """A shortened solve of a target of its own: every kernel and shape
        of the window, once."""
        if self.loop == "solves":
            cfg = dataclasses.replace(self.pcg, max_iters=self.freq)
            deadline = None
        else:
            cfg = dataclasses.replace(self.pcg, max_iters=1)
            deadline = 0.0
        y = data.target(self.data_seed, 0, self.X, self.columns, self.noise, stream="warmup")
        self._solve(y, 0, cfg, [], deadline)
        sync(self.device)

    def window(self, seconds: float, traced: bool):
        """The measured window; fills ``run`` and ``kept``."""
        self.probe.on = True
        t0 = time.perf_counter()
        deadline = t0 + seconds if self.loop == "iterations" else None
        j = 0
        while True:
            if self.loop == "solves" and time.perf_counter() - t0 >= seconds:
                break
            y = data.target(self.data_seed, j, self.X, self.columns, self.noise)
            if self.signed:
                y = data.sign(self.seed, j) * y
            self.kept.ys.append(y)
            try:
                rec = self._solve(y, j, self.pcg, self.kept.iterates, deadline, traced,
                                  self.hold if j == 0 else 0)
            except Exception:  # a failed solve ends the window; the run is not correct
                traceback.print_exc()
                self.failed += 1
                break
            self.run.solves.append({k: v for k, v in rec.items() if k not in ("W64", "claim")})
            self.run.iterations += rec["iters"]
            self.kept.ended[j] = rec["completed"]
            if "W64" in rec:
                self.kept.finals.append({"solve": j, "W64": rec["W64"], "claim": rec["claim"]})
            j += 1
            if self.loop == "iterations" and (not rec["completed"]
                                              or time.perf_counter() >= deadline):
                break
        sync(self.device)
        self.run.window_s = time.perf_counter() - t0
        self.probe.on = False
        self.kept.applies = self.probe.kept()

    def timed_ops(self):
        """Each traced apply: the work it is counted as, its shape and its
        device time (ms)."""
        tier = self.cd is not None
        return [{"op": op, "kernel": KERNEL[op, tier], "kind": self.kind, "cd": self.cd,
                 "n": self.n, "m": self.n, "d": self.d, "k": k, "device_ms": a.elapsed_time(b)}
                for op, k, a, b in self.probe.timed]

    def release(self):
        """Drop the program's state (the operator, the preconditioner, the
        tap's hold on them); the kept outputs and the points stay."""
        self.probe.release()
        self.K = self.P = self.probe = None

    def numbers(self, reference, names, control=False):
        """The numbers ``names`` of the window's kept outputs, judged by the
        reference module; with ``control``, those the TF32 reference reads
        in the program's place."""
        rows = data.sample_rows(self.seed, self.n, self.cell.check.get("rows"))
        return numbers(self.kept, self.X, self.reg, self.ls, reference, rows, names, control)


def _rel_gap(a, b):
    return abs(a - b) / b if b > 0 else math.inf


def _columns(cap):
    """Every kept vector the reference multiplies, as one (n, c) float64
    matrix, and the slices of each group."""
    groups = {
        "applies": [v for v, _ in cap.applies],
        "sizes": [v.abs() for v, _ in cap.applies],
        "iterates": [it["W"] for it in cap.iterates if it["W"] is not None],
        "finals": [f["W64"] for f in cap.finals],
    }
    mats, spans, at = [], {}, 0
    for key, vs in groups.items():
        spans[key] = []
        for v in vs:
            mats.append(v.double())
            spans[key].append(slice(at, at + v.shape[1]))
            at += v.shape[1]
    return (torch.cat(mats, dim=1) if mats else None), spans


def _at_depth(kept, ended, i):
    """Per solve, the index in ``kept`` of its iterate at iteration ``i``:
    its boundary ``i``, or its last where it ran to its end before ``i``."""
    last = {}
    for at, it in enumerate(kept):
        if it["i"] <= i:
            last[it["solve"]] = at
    return [at for j, at in last.items() if kept[at]["i"] == i or ended.get(j)]


def numbers(cap, X, reg, lengthscale, reference, rows, names, control=False):
    """The numbers ``names`` of kept outputs ``cap`` (see the module's
    docstring)."""
    dev = X.device
    n = X.shape[0]
    rows = rows.to(dev)
    V, spans = _columns(cap)
    if V is None:
        return {name: math.inf for name in names}
    V = V.to(dev)
    exact = reference.gram_apply(X, rows, V, lengthscale)  # (s, c) float64
    got_kv = reference.gram_apply(X, rows, V.float(), lengthscale, torch.float32,
                                  tf32=True).double() if control else exact
    scale = (n / rows.shape[0]) ** 0.5

    def rel_res(kv, sl, y):
        y = y.to(dev, torch.float64)
        r = y[rows] - (kv[:, sl] + reg * V[rows, sl])
        return (torch.linalg.norm(r, dim=0) * scale / torch.linalg.norm(y, dim=0)).tolist()

    out = {}
    if "apply_err" in names:
        errs = []
        for (_, Y), sl, size in zip(cap.applies, spans["applies"], spans["sizes"]):
            ref = exact[:, sl]
            got = got_kv[:, sl] if control else Y.to(dev, torch.float64)[rows]
            errs.append((torch.max(torch.abs(got - ref)) / torch.max(exact[:, size])).item())
        out["apply_err"] = max(errs, default=math.inf)
    kept = [it for it in cap.iterates if it["W"] is not None]
    true_it = [rel_res(exact, sl, cap.ys[it["solve"]]) for it, sl in zip(kept, spans["iterates"])]
    pairs = []  # (logged, true) of every kept boundary that logged
    for it, sl, true in zip(kept, spans["iterates"], true_it):
        logged = rel_res(got_kv, sl, cap.ys[it["solve"]]) if control else it["logged"]
        if logged is not None:
            pairs += list(zip(logged, true))
    if "res_gap" in names:
        out["res_gap"] = max((_rel_gap(a, b) for a, b in pairs), default=math.inf)
    if "res_err" in names:
        out["res_err"] = max((abs(a - b) for a, b in pairs), default=math.inf)
    for name in names:
        i = _depth(name)
        if i is not None:
            out[name] = max((max(true_it[at]) for at in _at_depth(kept, cap.ended, i)),
                            default=math.inf)
    true_fin = [rel_res(exact, sl, cap.ys[f["solve"]]) for f, sl in zip(cap.finals, spans["finals"])]
    if "cert_gap" in names:
        gaps = []
        for f, sl, true in zip(cap.finals, spans["finals"], true_fin):
            claim = rel_res(got_kv, sl, cap.ys[f["solve"]]) if control else f["claim"]
            gaps += [_rel_gap(a, b) for a, b in zip(claim, true)]
        out["cert_gap"] = max(gaps, default=math.inf)
    if "refined_res" in names:
        out["refined_res"] = max((max(t) for t in true_fin), default=math.inf)
    return out
