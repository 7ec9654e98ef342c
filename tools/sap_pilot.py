#!/usr/bin/env python3
"""A plain SAP pilot on a benchmark cell's data, and the (mu, nu) it gives.

    python3 tools/sap_pilot.py --workload krr1m-laplace-askotch-iters [--iters 60] [--seed 0]

Builds the cell's program at ``--seed`` as ``portbench/run.py`` does (its
points, targets and operator, drawn on the card), runs ``--iters``
iterations of plain SAP (no acceleration) from zero with the
configuration's blocks, block preconditioner, power iterations, key and
sampled metrics every ``callback_freq``, and prints one ``sap_pilot {...}``
line: the largest sampled rel_res over the columns at each logging
boundary, the seconds a iteration, and ``sap_accel_from_pilot``'s (mu,
nu) from the last boundary (None, with the reason, where the pilot shows
no contraction); then the card's name and power limit. Needs a CUDA card
and ``nvcc``.
"""

import argparse
import copy
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness, spec  # noqa: E402
from portbench.smi import card_line  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    harness.cache_env(spec.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("sap_pilot: no CUDA device is available", file=sys.stderr)
        return 1
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.solvers import sap_accel_from_pilot

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(args.workload)
    config = copy.deepcopy(cell.config)
    config["solver"].update(accel=False, max_iters=args.iters)
    cell = dataclasses.replace(cell, config=config)
    prog = spec.program(config["program"], cell.root).Program(
        cell, args.seed, torch.device("cuda"), False,
        lambda msg: print(msg, file=sys.stderr, flush=True))
    system = LinSys(prog.K, prog.Y, reg=prog.reg, A_row_oracle=prog.K.row_oracle,
                    A_blk_oracle=prog.K.blk_oracle)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, log = system.solve(prog.sap, torch.zeros_like(prog.Y), callback_freq=prog.freq,
                          key=prog.key, metrics="sampled")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    its = sorted(i for i in log if isinstance(i, int))
    traj = {i: float(torch.max(log[i]["metrics"]["internal_metrics"]["rel_res"])) for i in its}
    n, blk = prog.n, prog.blk
    rec = {"workload": args.workload, "seed": args.seed, "key": prog.key, "n": n, "blk_sz": blk,
           "iters": its[-1], "wall_s": wall, "s_per_iter": system.phase_walls["train"] / its[-1],
           "trajectory": traj}
    try:
        acc = sap_accel_from_pilot(traj[its[-1]], its[-1], n, blk)
        rec.update(mu=acc.mu, nu=acc.nu)
    except ValueError as e:  # no measurable contraction: no (mu, nu)
        rec.update(mu=None, nu=None, error=str(e))
    print("sap_pilot " + json.dumps(rec), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
