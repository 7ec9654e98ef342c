"""A grid search of kernel ridge regression by Nyström-PCG: ``krr_pcg``'s
configuration solved over a grid of lengthscales and regularisers, each fit
from scratch. The traffic names this program (``"program":
"krr_pcg_sweep"``).

A sweep is one target y, solved once for each pair (ℓ, λ) of the grid: ℓ
the configuration's lengthscale times each of the traffic's
``lengthscale_factors``, λ = ρ each of its ``reg_per_n`` times n, in one
order drawn from the traffic's ``data_seed`` (the same in every run). Each
solve builds a new operator ``KernelLinOp(X, X, KernelConfig(ℓ))``, a new
``LinSys(K, y, λ)`` and with it a new Nyström preconditioner of the
configuration's rank, and runs the traffic's ``rtol``, ``max_iters`` and
``callback_freq`` with no refinement. Sweep s takes target s of the pool
of ``data_seed`` and the seed's sign for it, as ``krr_pcg``'s
``"solves"`` loop takes its targets. Sweeps start while the window's clock
is under ``--seconds``, and every sweep that starts finishes.

The check's numbers are ``krr_pcg``'s, each taken per pair with the pair's
ℓ and λ and the largest kept: ``apply_err`` (the kept applies of each
solve's operator), ``res_err`` and ``res_gap``, and

``final_res``
    The largest reference relative residual of the final iterate of a
    solve that ended converged (its last logged ``rel_res`` at most
    ``rtol`` in every column).
"""

import dataclasses
import time
import traceback

import numpy as np

from portbench import data
from portbench.programs import krr_pcg
from portbench.taps import Probe, sync


class Program(krr_pcg.Program):
    """The program under one cell's configuration and the sweep's traffic."""

    def __init__(self, cell, seed: int, device, traced: bool, log=print):
        t = cell.traffic
        c = dict(cell.config)
        c["solver"] = dict(c["solver"], rtol=t["rtol"], max_iters=t["max_iters"],
                           callback_freq=t["callback_freq"])
        c["refine"] = {"rounds": 0}
        super().__init__(dataclasses.replace(cell, config=c), seed, device, traced, log)
        ls0 = self.ls
        grid = [(ls0 * f, r * self.n) for f in t["lengthscale_factors"] for r in t["reg_per_n"]]
        order = np.random.default_rng(data.stream_seed(self.data_seed, "sweep_order"))
        self.grid = [grid[i] for i in order.permutation(len(grid))]
        self.pair_of = {}  # solve -> (ℓ, λ)
        self.kept_applies = []  # (solve, (V, K V))
        self.timed = []  # every solve's probe's timed applies

    def _pair_solve(self, y, j, pair, traced):
        """Solve j: a new operator, system and preconditioner at ``pair``."""
        from rlaopt_tpu_torch.kernels import KernelConfig, KernelLinOp
        from rlaopt_tpu_torch.preconditioners import NystromConfig

        self.ls, self.reg = pair
        self.K = KernelLinOp(self.X, self.X, KernelConfig(lengthscale=self.ls), kind=self.kind,
                             compute_dtype=self.cd)
        self.probe = Probe(self.K, lambda V: "sketch" if V.shape[1] == self.rank else "matvec",
                           data.stream_seed(self.seed, "sweep_solve", j), traced)
        self.probe.timed = self.timed  # one list of the window's timed applies
        self.probe.on = True
        cfg = dataclasses.replace(self.pcg, precond_config=NystromConfig(rank=self.rank,
                                                                         rho=self.reg))
        try:
            return self._solve(y, j, cfg, self.kept.iterates, None, traced)
        finally:
            self.probe.on = False
            self.kept_applies += [(j, a) for a in self.probe.kept()]

    def window(self, seconds: float, traced: bool):
        """Whole sweeps while the clock is under ``seconds``."""
        t0 = time.perf_counter()
        j = sweep = 0
        while time.perf_counter() - t0 < seconds and not self.failed:
            y = data.sign(self.seed, sweep) * data.target(self.data_seed, sweep, self.X,
                                                          self.columns, self.noise)
            for pair in self.grid:
                self.kept.ys.append(y)
                self.pair_of[j] = pair
                try:
                    rec = self._pair_solve(y, j, pair, traced)
                except Exception:  # a failed solve ends the window; the run is not correct
                    traceback.print_exc()
                    self.failed += 1
                    break
                self.run.solves.append(rec)
                self.run.iterations += rec["iters"]
                self.kept.ended[j] = rec["completed"]
                j += 1
            sweep += 1
        sync(self.device)
        self.run.window_s = time.perf_counter() - t0

    def release(self):
        self.K = self.P = self.probe = None

    def numbers(self, reference, names, control=False):
        """Per pair, ``krr_pcg``'s numbers of that pair's solves at its ℓ
        and λ; the largest of each over the pairs."""
        rows = data.sample_rows(self.seed, self.n, self.cell.check.get("rows"))
        rtol = self.pcg.rtol
        out = {}
        for pair in self.grid:
            ls, reg = pair
            solves = {j for j, p in self.pair_of.items() if p == pair}
            if not solves:
                continue
            its = [it for it in self.kept.iterates if it["solve"] in solves]
            finals = []
            for j in solves:
                mine = [it for it in its if it["solve"] == j and it["W"] is not None]
                last = mine[-1] if mine else None
                if (self.kept.ended.get(j) and last is not None and last["logged"] is not None
                        and max(last["logged"]) <= rtol):
                    finals.append({"solve": j, "W64": last["W"], "claim": last["logged"]})
            kept = krr_pcg.Kept(ys=self.kept.ys, iterates=its, finals=finals,
                                applies=[a for j, a in self.kept_applies if j in solves],
                                ended=self.kept.ended)
            asked = [n for n in names if n != "final_res"] + (
                ["refined_res"] if "final_res" in names and finals else [])
            got = krr_pcg.numbers(kept, self.X, reg, ls, reference, rows, asked, control)
            if "refined_res" in got:
                got["final_res"] = got.pop("refined_res")
            for name, value in got.items():
                out[name] = max(out.get(name, value), value)
        return {name: out.get(name, float("inf")) for name in names}
