#!/usr/bin/env python3
"""K1b's float32 row sums at a long m axis: one run against the runs that
``kernel_cuda.tier_splits`` gives.

    python3 tools/k1b_runs.py [--n 100000] [--m 10000000] [--k 10] [--rows 64]

The row oracle of configs 7 and 9 (``chip_smoke.py::askotch10m``): the
bf16x3 tier parts of X = N(0, 1)/sqrt(50) of (m, 50) drawn on the card from
a ``torch.Generator`` of seed 0, ``n`` rows of them against all m, k
right-hand sides. For a random normal V and a positive (uniform) one, K1b
(``kernel_cuda.gram_matmat_tier``, on the route ``forward_tier_route``
gives: the warp-specialised kernel) runs once with the m axis in one run
and once in the runs of ``tier_splits``; the first ``rows`` rows of each
are held against the float64 sum of the same float32 kernel values that
the tier's plain version computes (``kernel_plain._tier_values``), beside
that plain version's own products: float32 (``plain``) and tier-matched
(``plain_tier_matched``); the kernel contracts as ``forward_contraction``
says (the split at k = 10, float32 up to 8 columns). Prints one
``k1b_runs {...}`` line (for each V and schedule: the max error over
max|ref| and over the largest sum of magnitudes, sum_j |K_ij||V_jc|, and
the kernel's time), then the card's name and power limit. Needs one CUDA
card and ``nvcc``.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=10_000_000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--rows", type=int, default=64)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k1b_runs: no CUDA device is available", file=sys.stderr)
        return 1
    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
    from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand

    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_cuda.build()
    dev = torch.device("cuda", 0)
    n, m, k, d = args.n, args.m, args.k, 50
    X = torch.randn((m, d), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev) / d**0.5
    P = tier_operand(X, "bf16x3")
    del X
    rows = torch.as_tensor(smoke.sampled_rows(m, n, 3), device=dev)
    Pb, Pr = P.rows(rows), P.rows(rows[:args.rows])
    route = kernel_cuda.forward_tier_route(k, P.hi.shape[1])
    runs = kernel_cuda.tier_splits(n, m, k, P.hi.shape[1], kernel_cuda.sm_count(dev))
    contraction = kernel_cuda.forward_contraction(k, P.hi.shape[1], P.passes)
    tier_splits = kernel_cuda.tier_splits
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {"n": n, "m": m, "k": k, "rows": args.rows, "route": route,
           "contraction": contraction, "runs": runs}
    for name, V in (("random", torch.randn((m, k), generator=gen, device=dev)),
                    ("positive", torch.rand((m, k), generator=gen, device=dev))):
        vals = kernel_plain._tier_values("rbf", Pr, P)
        ref = vals.double() @ V.double()
        mag = (vals.double().abs() @ V.double().abs()).max().item()
        plain = (vals @ V).double()
        plain_tm = kernel_plain.tier_contract(vals, V, "split").double()
        del vals
        rec = {"max_abs_ref": ref.abs().max().item(), "max_magnitude_sum": mag}

        def err(x):
            e = (x - ref).abs().max().item()
            return {"of_max_ref": e / rec["max_abs_ref"], "of_magnitudes": e / mag}

        rec["plain"] = err(plain)
        rec["plain_tier_matched"] = err(plain_tm)
        for label, count in (("one run", 1), ("tier_splits", runs)):
            kernel_cuda.tier_splits = lambda *a, c=count: c
            try:
                got = kernel_cuda.gram_matmat_tier("rbf", Pb, P, V)[:args.rows].double()
                ms = smoke.cuda_ms(lambda: kernel_cuda.gram_matmat_tier("rbf", Pb, P, V),
                                   reps=3, warm=False)
            finally:
                kernel_cuda.tier_splits = tier_splits
            rec[label] = {**err(got), "runs": count, "ms": ms}
        out[name] = rec
        print(f"k1b_runs {name}: {json.dumps(rec)}", flush=True)
    print("k1b_runs " + json.dumps(out))
    print(smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
