#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on a CUDA card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last: each number the check compared, with its limit); the last
lines of standard error repeat the checks. It exits non-zero, printing no
result, without enough CUDA devices or if the process holds JAX or the JAX
package once the window has closed.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], harness.process_start()))
