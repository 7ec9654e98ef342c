#!/usr/bin/env python3
"""The port's own counters and spans over one traced run of a benchmark cell.

    python3 tools/traced_counters.py --workload krr10m-askotch-iters --seed 7 [--seconds 28]

Runs the cell once as ``portbench/run.py --trace 1`` does
(``portbench.harness.run``: set-up, warm-up, the window under the profiler,
the check) and prints one ``traced_counters {...}`` line: the run's
``correct``, per-layer metrics, device record, breakdown and checks, the
counters the port recorded in the window
(``rlaopt_tpu_torch.utils.profiling.counters()``: each wrapper's calls and
host time, each route's launches, such as
``rlaopt.cuda.gram_matmat_tier.warpgroup.launches``) and the number of
each span, such as SAP's ``rlaopt.sap.row_oracle``; then the card's name
and power limit. Needs the cell's CUDA card(s) and ``nvcc``.
"""

import argparse
import collections
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402
from portbench import harness, spec  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=28.0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("traced_counters: no CUDA device is available", file=sys.stderr)
        return 1
    from rlaopt_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profiling.reset()
    result = harness.run(spec.cell(args.workload), args.seed, args.seconds, True,
                         log=lambda msg: print(msg, file=sys.stderr, flush=True))
    spans = collections.Counter(s["name"] for s in profiling.spans())
    print("traced_counters " + json.dumps({
        "workload": args.workload, "seed": args.seed, "correct": result["correct"],
        "metrics": result["metrics"], "device": result["device"],
        "breakdown": result.get("breakdown"), "checks": result["checks"],
        "counters": profiling.counters(),
        "spans": dict(sorted(spans.items())), "spans_dropped": profiling.dropped()}))
    print(smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
