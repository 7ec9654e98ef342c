#!/usr/bin/env python3
"""Config 9 of ``benchmarks/run.py`` whole, through the port, on one card.

    python3 tools/config10m.py [--iters 150] [--every 50]

The recipe of ``chip_smoke.py::askotch10m`` at its full depth: X =
N(0, 1)/sqrt(50) of (10^7, 50) and y = N(0, 1) of (10^7, 10) drawn on the
card from a ``torch.Generator`` of seed 0, ``RBFLinOp(X, X,
KernelConfig(lengthscale=1.0), compute_dtype="bf16x3")``, reg = 1e-5 n;
SAP with blocks of 100,000, block Nyström of rank 100 at rho = reg, 10
power iterations, rtol 1e-6, sampled metrics every 5 iterations, key 7,
accelerated with the (mu, nu) of the benchmark's configuration
``portbench/configs/synth10m-rbf-askotch.json`` (a plain pilot's, which
``tools/sap_pilot.py --workload krr10m-askotch-iters`` runs): ``--iters``
iterations, certified every ``--every`` iterations and at the end by
``chip_smoke.value64_certificate`` (2,048 rows of numpy seed 11, K8
against all 10^7 points, the rest in float64 on the host). As in the
smoke, a solve's last metrics stay sampled (a true residual at this size
is 10^14 float64 kernel values, about half an hour on the card).

Prints the accelerated run's wall, s/iter and sampled trajectory, (mu,
nu), each certificate with its standard error and wall, and the peak
memory, as one ``config10m {...}`` line, then the card's name and power
limit. Needs one CUDA card and ``nvcc``; takes about 12 minutes on an
H100.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402

CONFIG9 = Path(__file__).resolve().parent.parent / "portbench/configs/synth10m-rbf-askotch.json"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--every", type=int, default=50)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("config10m: no CUDA device is available", file=sys.stderr)
        return 1
    from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.ops import kernel_cuda
    from rlaopt_tpu_torch.preconditioners import NystromConfig
    from rlaopt_tpu_torch.solvers import SAPAccelConfig, SAPConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernel_cuda.build()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    n, d, k, freq = smoke.N10, smoke.D10, smoke.K10, smoke.FREQ10
    blk, reg = n // 100, smoke.REG9_PER_N * smoke.N10
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(dev)
    t_all = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((n, d), generator=gen, device=dev) / d**0.5
    y = torch.randn((n, k), generator=gen, device=dev)
    K = RBFLinOp(X, X, KernelConfig(lengthscale=1.0), compute_dtype="bf16x3")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_all
    y_norm = float(torch.linalg.norm(y.double()))
    base = dict(rtol=1e-6, blk_sz=blk, power_iters=10,
                precond_config=NystromConfig(rank=smoke.RANK10, rho=reg))

    def solve(cfg, snaps=None):
        sys_ = LinSys(K, y, reg=reg, A_row_oracle=K.row_oracle, A_blk_oracle=K.blk_oracle)
        smoke.sampled_final_metrics(sys_)

        def keep(w, model):
            t = model._ms.solver.state.t
            if snaps is not None and t > 0 and t % args.every == 0:
                snaps[t] = w.clone()

        t0 = time.perf_counter()
        W, log = sys_.solve(cfg, torch.zeros((n, k), device=dev), callback_freq=freq, key=7,
                            metrics="sampled", callback_fn=keep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        its = smoke.int_keys(log)
        traj = {i: float(torch.max(log[i]["metrics"]["internal_metrics"]["rel_res"]))
                for i in its}
        return W, {"wall_s": wall, "phase_walls": sys_.phase_walls, "iters": its[-1],
                   "s_per_iter": sys_.phase_walls["train"] / its[-1], "trajectory": traj}

    solver = json.loads(CONFIG9.read_text())["solver"]
    acc = SAPAccelConfig(mu=solver["mu"], nu=solver["nu"])
    snaps = {}
    W, accel = solve(SAPConfig(max_iters=args.iters, accel=True, accel_config=acc, **base),
                     snaps)
    snaps[accel["iters"]] = W
    print(f"config10m accelerated: {json.dumps(accel)}", flush=True)
    certs = {}
    for i in sorted(snaps):
        rel, stderr, _, _, cert_s = smoke.value64_certificate(X, y, y_norm, snaps[i], reg)
        certs[i] = {"rel_res": rel, "stderr": stderr, "s": cert_s}
        print(f"config10m certificate at {i}: {rel:.8e} ± {rel * stderr:.2e} in {cert_s:.3f} s",
              flush=True)
    record = {"n": n, "d": d, "k": k, "blk_sz": blk, "reg": reg, "build_s": build_s,
              "setup_s": setup_s, "accel_params": {"mu": acc.mu, "nu": acc.nu},
              "accelerated": accel, "certificates": certs,
              "wall_s": time.perf_counter() - t_all,
              "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    print("config10m " + json.dumps(record))
    print(smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
