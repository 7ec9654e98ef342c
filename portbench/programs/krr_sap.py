"""Kernel ridge regression by ASkotch (accelerated SAP, block Nyström) through
the port's public entry point: the program of every configuration whose
``program`` is ``krr_sap``.

The configuration names the kernel, its lengthscale and tier, the
regulariser ``reg_per_n·n``, the number of right-hand sides ``k``, the
solver (``sap``: block size, power iterations, (μ, ν), ``callback_freq``)
and its block preconditioner (``nystrom``: rank, ρ = ``rho_per_n·n``).
Set-up draws the points X = N(0, 1)/√d (n, d) and the targets Y = N(0, 1)
(n, k) on the device from the seed, builds the operator and warms up one
SAP step with its logging boundary. The window drives

    LinSys(K, Y, reg, A_row_oracle=K.row_oracle, A_blk_oracle=K.blk_oracle)
        .solve(SAPConfig(...), metrics="sampled", callback_freq=...)

from zero. The traffic's ``loop`` is ``"iterations"``: the window ends at
the first logging boundary at or after ``--seconds``, and not before the
deepest boundary a check number reads (``res_at.<i>``); a solve that ends
first is followed by the next.

The check's numbers (``numbers``), judged by the configuration's plain
reference (``reference/<name>.py``: ``gram_apply(X, rows, V, lengthscale)``
in float64):

``oracle_err``
    For two row-oracle applies ``K[blk, :] @ V`` the window kept (one drawn
    from the seed among each solve's applies past its first, whose point is
    zero, and the last), ``max|Y - K[blk, :] V| / max(K[blk, :] |V|)`` over
    the check's ``oracle_rows`` rows of the block, drawn from the seed: the
    row oracle at the configuration's tier, scaled as ``krr_pcg``'s
    ``apply_err``.
``res_gap``
    For every logging boundary past 0 whose iterate and logged ``rel_res``
    the window kept, ``|logged - reference| / reference``: the logged
    estimate from the port's 4,096 sampled rows against the reference's
    estimate of the same iterate's relative residual from the check's
    ``rows`` (``|r[rows]|·sqrt(n/rows) / |y|``, as the port estimates).
``res_at.<i>``
    The reference's ``|r[rows]| / |y[rows]|`` of each solve's iterate at
    iteration ``i`` (largest over columns and solves): progress, at a depth
    that does not depend on how fast the program runs. Both norms over the
    check's rows: r = y - (K + reg I) W moves with y, so the ratio's
    sampling noise is a small share of the residual's reduction (the
    estimate above would bury a reduction of 1% in its own noise); an
    iterate that has not moved from zero reads 1 exactly.
"""

import contextlib
import dataclasses
import math
import random
import time
import traceback

import torch

from portbench import data
from portbench.harness import Run
from portbench.programs.krr_pcg import Kept, _at_depth, _columns, _depth, _rel_gap
from portbench.spec import SpecError
from portbench.taps import Observer, WindowClosed, sync


class OracleProbe:
    """Taps an operator's row oracle. While on, each oracle of ``blk_sz``
    rows (a SAP block; the sampled metrics' rows pass untouched) has its
    apply kept, one drawn from the seed (reservoir) among the applies past
    each solve's first and the last one, and in a traced run timed with
    CUDA events inside a profiler range."""

    def __init__(self, K, blk_sz: int, seed: int, traced: bool):
        self._ro = K.row_oracle
        K.row_oracle = self.row_oracle
        self.blk_sz, self.traced, self.on = blk_sz, traced, False
        self._rng = random.Random(data.stream_seed(seed, "oracle_sample"))
        self.first, self.seen, self.sample, self.last = True, 0, None, None
        self.timed = []  # (k, start event, end event)

    def row_oracle(self, blk):
        op = self._ro(blk)
        if self.on and blk.shape[0] == self.blk_sz:
            mm = op.matmat
            op.matmat = lambda V: self._apply(mm, blk, V)
        return op

    def _apply(self, mm, blk, V):
        if self.traced:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            with torch.profiler.record_function(f"portbench.oracle.{len(self.timed)}"):
                ev[0].record()
                Y = mm(V)
                ev[1].record()
            self.timed.append((V.shape[1], *ev))
        else:
            Y = mm(V)
        if not self.first:
            self.seen += 1
            if self._rng.randrange(self.seen) == 0:
                self.sample = (blk, V, Y)
            self.last = (blk, V, Y)
        self.first = False
        return Y

    def kept(self) -> list:
        if self.last is None:
            return []
        return [self.last] if self.sample is self.last else [self.sample, self.last]


class Program:
    """The program under one cell's configuration and traffic."""

    def __init__(self, cell, seed: int, device, traced: bool, log=print):
        import rlaopt_tpu_torch  # noqa: F401
        from rlaopt_tpu_torch.kernels import KERNEL_KINDS, KernelConfig, KernelLinOp
        from rlaopt_tpu_torch.ops import kernel_cuda
        from rlaopt_tpu_torch.preconditioners import NystromConfig
        from rlaopt_tpu_torch.solvers import SAPAccelConfig, SAPConfig

        c, t = cell.config, cell.traffic
        if c["kernel"] not in KERNEL_KINDS or c["solver"]["name"] != "sap" or (
                c["preconditioner"]["name"] != "nystrom") or t["loop"] != "iterations":
            raise SpecError("krr_sap drives a kernel of the port by SAP with block Nyström, "
                            "in iterations windows")
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            lib = kernel_cuda.build()
            log(f"build: {time.perf_counter() - t0:.3f} s ({lib.name})")
        n, d, k = int(c["n"]), int(c["d"]), int(c["k"])
        self.n, self.d = n, d
        self.kind, self.cd = c["kernel"], c["compute_dtype"]
        self.reg = c["reg_per_n"] * n
        self.ls = float(c["lengthscale"])
        s, p = c["solver"], c["preconditioner"]
        self.freq, self.blk, self.key = s["callback_freq"], s["blk_sz"], c["key"]
        self.sap = SAPConfig(
            max_iters=s["max_iters"], rtol=s["rtol"], blk_sz=s["blk_sz"],
            power_iters=s["power_iters"], accel=s["accel"],
            accel_config=SAPAccelConfig(mu=s["mu"], nu=s["nu"]) if s["accel"] else None,
            precond_config=NystromConfig(rank=p["rank"], rho=p["rho_per_n"] * n))
        depths = [_depth(name) for name in cell.check["limits"]]
        self.hold = max([i for i in depths if i is not None], default=0)
        t0 = time.perf_counter()
        self.X = data.points(seed, n, d, self.device).div_(d**0.5)
        g = data.generator(seed, "targets", 0, self.device)
        self.Y = torch.randn((n, k), generator=g, device=self.device, dtype=torch.float32)
        self.K = KernelLinOp(self.X, self.X, KernelConfig(lengthscale=self.ls), kind=self.kind,
                             compute_dtype=self.cd)
        self.oracle = OracleProbe(self.K, self.blk, seed, traced)
        sync(self.device)
        log(f"set-up: data and operator {time.perf_counter() - t0:.3f} s")
        self.kept = Kept()
        self.applies = []
        self.run = Run("iterations")
        self.failed = 0

    def _solve(self, j, cfg, kept, deadline, traced=False, hold=0):
        """One solve from zero; returns the solve's record."""
        from rlaopt_tpu_torch.models import LinSys

        system = LinSys(self.K, self.Y, reg=self.reg, A_row_oracle=self.K.row_oracle,
                        A_blk_oracle=self.K.blk_oracle)
        obs = Observer(system, j, self.freq, cfg.max_iters, kept, deadline, hold)
        rec = {"j": j, "completed": False}
        rf = (torch.profiler.record_function(f"portbench.solve.{j}") if traced
              else contextlib.nullcontext())
        self.oracle.first = True
        try:
            with rf:
                system.solve(cfg, torch.zeros_like(self.Y), callback_fn=obs,
                             callback_freq=self.freq, key=self.key, metrics="sampled")
            rec["completed"] = True
            rec["phase_walls"] = dict(system.phase_walls)
        except WindowClosed:
            sync(self.device)
        rec["iters"] = obs.i or 0
        return rec

    def warm_up(self):
        """One SAP step and its logging boundary (every kernel and shape of
        the window), closed there."""
        self._solve(0, dataclasses.replace(self.sap, max_iters=1), [], 0.0)
        sync(self.device)

    def window(self, seconds: float, traced: bool):
        """The measured window; fills ``run``, ``kept`` and ``applies``."""
        self.oracle.on = True
        t0 = time.perf_counter()
        deadline = t0 + seconds
        j = 0
        while True:
            self.kept.ys.append(self.Y)
            try:
                rec = self._solve(j, self.sap, self.kept.iterates, deadline, traced,
                                  self.hold if j == 0 else 0)
            except Exception:  # a failed solve ends the window; the run is not correct
                traceback.print_exc()
                self.failed += 1
                break
            self.run.solves.append(rec)
            self.run.iterations += rec["iters"]
            self.kept.ended[j] = rec["completed"]
            j += 1
            if not rec["completed"] or time.perf_counter() >= deadline:
                break
        sync(self.device)
        self.run.window_s = time.perf_counter() - t0
        self.oracle.on = False
        self.applies = self.oracle.kept()

    def timed_ops(self):
        """Each traced row-oracle apply: the work it is counted as (the
        general product at the tier, ``blk_sz`` rows against n columns), its
        shape and its device time (ms)."""
        kernel = "gram_matmat" if self.cd is None else "gram_matmat_tier"
        return [{"op": "row_oracle", "kernel": kernel, "kind": self.kind, "cd": self.cd,
                 "n": self.blk, "m": self.n, "d": self.d, "k": k,
                 "device_ms": a.elapsed_time(b)} for k, a, b in self.oracle.timed]

    def release(self):
        """Drop the operator and the tap's hold on it; the kept outputs, the
        points and the targets stay."""
        self.K = self.oracle = None

    def numbers(self, reference, names, control=False):
        """The numbers ``names`` of the window's kept outputs, judged by the
        reference module (the control is the program at a lower tier)."""
        rows = data.sample_rows(self.seed, self.n, self.cell.check.get("rows"))
        out = residual_numbers(self.kept, self.X, self.reg, self.ls, reference, rows, names)
        if "oracle_err" in names:
            pos = data.sample_rows(self.seed, self.blk, self.cell.check["oracle_rows"])
            out["oracle_err"] = oracle_err(reference, self.X, self.ls, self.applies, pos)
        return out


def residual_numbers(kept, X, reg, lengthscale, reference, rows, names):
    """``res_gap`` and ``res_at.<i>`` of the kept iterates, where asked."""
    its = [it for it in kept.iterates if it["W"] is not None]
    V, spans = _columns(Kept(iterates=its))
    if V is None:
        return {name: math.inf for name in names
                if name == "res_gap" or _depth(name) is not None}
    rows = rows.to(X.device)
    KV = reference.gram_apply(X, rows, V, lengthscale)  # (s, c) float64
    V = V.to(X.device)
    scale = (X.shape[0] / rows.shape[0]) ** 0.5
    est, ratio = [], []
    for it, sl in zip(its, spans["iterates"]):
        y = kept.ys[it["solve"]].to(X.device, torch.float64)
        r = torch.linalg.norm(y[rows] - (KV[:, sl] + reg * V[rows, sl]), dim=0)
        est.append((r * scale / torch.linalg.norm(y, dim=0)).tolist())
        ratio.append((r / torch.linalg.norm(y[rows], dim=0)).tolist())
    out = {}
    if "res_gap" in names:
        gaps = [_rel_gap(a, b) for it, ref in zip(its, est) if it["logged"] is not None
                for a, b in zip(it["logged"], ref)]
        out["res_gap"] = max(gaps, default=math.inf)
    for name in names:
        i = _depth(name)
        if i is not None:
            out[name] = max((max(ratio[at]) for at in _at_depth(its, kept.ended, i)),
                            default=math.inf)
    return out


def oracle_err(reference, X, lengthscale, applies, pos):
    """``max|Y - K[blk, :] V| / max(K[blk, :] |V|)`` over the positions
    ``pos`` of each kept apply's block, largest over the applies; infinite
    without one."""
    errs = []
    for blk, V, Y in applies:
        p = pos.to(blk.device)
        ref = reference.gram_apply(X, blk[p], torch.cat([V, V.abs()], dim=1), lengthscale)
        k = V.shape[1]
        err = torch.max(torch.abs(Y[p].double() - ref[:, :k])) / torch.max(ref[:, k:])
        errs.append(err.item())
    return max(errs, default=math.inf)
