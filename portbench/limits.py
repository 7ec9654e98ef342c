#!/usr/bin/env python3
"""Read the numbers a cell's check compares, for the program and for its
control, over many seeds in one process (the library loads once).

    python3 portbench/limits.py --workload <name> --seconds <s> \
        --seeds 11,12,... [--control-seeds 21,22,23] [--fresh-data] \
        [--extra res_at.10,res_at.30]

Each seed is one run of the cell at its own size (set-up, window, check);
one JSON line per run: the seed, whether it is the control, its numbers,
``correct`` (for the control: whether its numbers pass the limits), and the
``--extra`` numbers of the program. The program's largest reading of a
number over its seeds is the lower reading of that number's limit; the
control's smallest is the upper reading (see ``checks/<cell>.json``). The
control of an exact float32 configuration (``"control": "tf32_reference"``)
is read from the program's own runs; one whose ``control`` overrides the
configuration (the program's own lower tier) runs on the control seeds.
``--fresh-data`` drops the traffic's ``data_seed``, so that each seed draws
its own points and targets. Needs a CUDA card.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness, spec  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fresh-data", action="store_true")
    ap.add_argument("--extra", type=lambda t: [e for e in t.split(",") if e], default=[])
    args = ap.parse_args(argv)
    harness.cache_env(spec.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("limits: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(args.workload)
    if args.fresh_data:
        traffic = {k: v for k, v in cell.traffic.items() if k != "data_seed"}
        cell = dataclasses.replace(cell, traffic=traffic)
    tf32 = cell.check["control"] == "tf32_reference"

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    def emit(seed, control, res, values, correct):
        print(json.dumps(harness.finite({
            "seed": seed, "control": control, "numbers": values, "correct": correct,
            "readings": res.get("readings", {}),
            "metrics": {k: v["value"] for k, v in res["metrics"].items()}})), flush=True)

    for seed in args.seeds:
        res = harness.run(cell, seed, args.seconds, False, control=tf32, log=log,
                          extra=args.extra)
        emit(seed, False, res, {k: v["value"] for k, v in res["checks"].items()},
             res["correct"])
        if tf32:
            emit(seed, True, res, res["control"], res["control_correct"])
    if not tf32:
        low = dataclasses.replace(cell, config={**cell.config, **cell.check["control"]})
        for seed in args.control_seeds:
            res = harness.run(low, seed, args.seconds, False, log=log, extra=args.extra)
            emit(seed, True, res, {k: v["value"] for k, v in res["checks"].items()},
                 res["correct"])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
