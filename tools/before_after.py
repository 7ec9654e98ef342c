#!/usr/bin/env python3
"""Time a kernel operator's product in two checkouts on one card.

    python3 tools/before_after.py OTHER_TREE [--kind KIND] [--d D]
        [--general N:K ...] [--symmetric N:K ...] [--pair N:K ...]
        [--comp N:K ...] [--triangle N:K ...] [--f64 N:K ...] [--ring N:P ...]

OTHER_TREE is another checkout of the repository (for example a ``git
archive`` of a commit unpacked into a directory that ``.gitignore``
lists). Each tree's kernels are built from its own sources, both builds
started together; then the trees are timed in turns, other, this, this,
other, each in a process of its own that imports that tree's package.

What is timed is ``A @ V`` for a ``KernelLinOp`` of that tree, the public
operator, on float32 points drawn from a seed (standard normal, N x D,
lengthscale sqrt(D), V standard normal N x K): ``--general N:K`` on two
point sets (X and a copy of it: the forward product, K1 or K3),
``--symmetric N:K`` on one (``A1 is A2``: the triangle up to 16 columns,
K2 or K5). The operator is built once a shape and applied once before the
timings, so whatever it keeps (the points' operand) is made outside them,
as in a solve. ``--pair N:K`` times ``kernel_dispatch.kernel_pair`` (K4
or K6 up to 16 columns) on two shards of N points, the JAX package's
signature in either tree, which builds the register tile's operands of
both in each call, each timing over 20 calls back to back (a call takes a
fraction of a millisecond). ``--comp N:K`` times
``kernel_dispatch.kernel_matmat_compensated`` and ``--f64 N:K``
``kernel_dispatch.kernel_matmat_f64`` (V in float64) on X and a copy of it
(the general K1c or K3c, and K8); ``--triangle N:K`` the compensated
product on one data set (``symmetric=True``: the float64 triangle). A shape ``N:K:KIND`` takes the family KIND
in place of ``--kind``. CUDA-event medians of 5 after one call. ``--ring
N:P`` solves config 5 on a P-position ring of the card as ``chip_smoke.py``'s
E2 does (``ShardedRBFLinOp`` in ring mode on N points of the HIGGS recipe,
Nyström-PCG of rank 200 for 50 iterations, callback_freq 10, one float64
refinement round) once, and reports its s/iter (``phase_walls["train"]``
over the iterations) and wall in seconds on the host clock.

With no shapes: the exact tier's products at the HIGGS surrogate of
``chip_smoke.py`` (D = 28), general 100,000 x K = 1, 10, 16, 500 and
50,000 x K = 1, 32, 200 (config 5's n), symmetric 100,000 x K = 1, 10, 16.

Prints one line a timing run, ``before_after {"tree": ..., "general":
{"n=N k=K": ms}, "symmetric": {...}, "pair": {...}, "comp": {...},
"triangle": {...}, "f64": {...}, "ring": {"n=N P=P": {"s_per_iter": ...,
"wall_s": ...}}}`` (a key ends in `` KIND`` where the shape names one),
then the card's name and power limit. Needs one CUDA card and ``nvcc``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
DEFAULT_GENERAL = ["100000:1", "100000:10", "100000:16", "100000:500",
                   "50000:1", "50000:32", "50000:200"]
DEFAULT_SYMMETRIC = ["100000:1", "100000:10", "100000:16"]


def _shape(text: str):
    n, k, *kind = text.split(":")
    return int(n), int(k), *kind


def _cuda_ms(fn, reps=5, inner=1):
    """Median of ``reps`` timings after one call, each over ``inner`` calls
    back to back (divided by it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _ring_solve(n: int, P: int, d: int, dev) -> dict:
    """Config 5 on a P-position ring of the card (chip_smoke.py's E2): the
    solve's s/iter and wall."""
    import time

    import numpy as np
    import torch

    from rlaopt_tpu_torch.kernels import KernelConfig, ShardedRBFLinOp
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.parallel import make_mesh
    from rlaopt_tpu_torch.preconditioners import NystromConfig
    from rlaopt_tpu_torch.solvers import PCGConfig

    rng = np.random.default_rng(0)  # chip_smoke.synthetic_higgs
    Xn = rng.standard_normal((n, d), dtype=np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    yn = np.tanh(Xn @ w) + 0.1 * rng.standard_normal(n).astype(np.float32)
    X = torch.from_numpy(Xn).to(dev)
    y = torch.from_numpy(yn.astype(np.float32)).to(dev)
    reg = 1e-4 * n
    K = ShardedRBFLinOp(X, X, KernelConfig(lengthscale=d**0.5),
                        mesh=make_mesh(devices=[dev] * P), memory_mode="ring")
    cfg = PCGConfig(max_iters=50, rtol=1e-6, precond_config=NystromConfig(rank=200, rho=reg))
    sys_ = LinSys(K, y, reg=reg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, log = sys_.solve(cfg, torch.zeros((n, 1), device=dev), callback_freq=10, key=0,
                        f64_refine_rounds=1, f64_refine_device="accel")
    torch.cuda.synchronize()
    iters = max(i for i in log if isinstance(i, int))
    return {"s_per_iter": sys_.phase_walls["train"] / iters, "wall_s": time.perf_counter() - t0}


def _run(args) -> dict:
    """Build (and unless ``args.build_only``, time) the kernels of
    ``args.tree``, imported from there."""
    sys.path.insert(0, args.tree)
    import numpy as np
    import torch

    from rlaopt_tpu_torch.kernels import KernelConfig, KernelLinOp
    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_dispatch

    assert Path(kernel_cuda.__file__).resolve().is_relative_to(Path(args.tree).resolve())
    kernel_cuda.build()
    if args.build_only:
        return {}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    shapes = {"general": args.general or [], "symmetric": args.symmetric or [],
              "pair": args.pair or [], "comp": args.comp or [], "triangle": args.triangle or [],
              "f64": args.f64 or [], "ring": args.ring or []}
    n_max = max(((2 if form == "pair" else 1) * shape[0]
                 for form, group in shapes.items() if form != "ring" for shape in group),
                default=1)
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((n_max, args.d), dtype=np.float32)).to(dev)
    ls = args.d**0.5
    cfg = KernelConfig(lengthscale=ls)
    gen = torch.Generator(device=dev).manual_seed(1)
    rec = {"tree": args.tree, "kind": args.kind, "d": args.d}
    for form, group in shapes.items():
        rec[form] = {}
        for n, k, *named in group:
            if form == "ring":
                rec[form][f"n={n} P={k}"] = _ring_solve(n, k, args.d, dev)
                continue
            kind = named[0] if named else args.kind
            key = f"n={n} k={k}" + (f" {kind}" if named else "")
            V = torch.randn((n, k), generator=gen, device=dev)
            if form == "pair":
                X1, X2 = X[:n].contiguous(), X[n:2 * n].contiguous()
                V1 = torch.randn((n, k), generator=gen, device=dev)
                rec[form][key] = _cuda_ms(lambda: kernel_dispatch.kernel_pair(
                    kind, X1, X2, V, V1, ls, 1.0), inner=20)
                continue
            Xn = X[:n].contiguous()
            if form in ("comp", "triangle", "f64"):
                Xc = Xn if form == "triangle" else Xn.clone()
                if form != "f64":
                    rec[form][key] = _cuda_ms(lambda: kernel_dispatch.kernel_matmat_compensated(
                        kind, Xn, Xc, V, ls, symmetric=form == "triangle"))
                else:
                    V64 = V.double()
                    rec[form][key] = _cuda_ms(lambda: kernel_dispatch.kernel_matmat_f64(
                        kind, Xn, Xc, V64, ls))
                continue
            A = KernelLinOp(Xn, Xn if form == "symmetric" else Xn.clone(), cfg, kind)
            rec[form][key] = _cuda_ms(lambda: A @ V)
            del A, V
    return rec


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("other_tree")
    p.add_argument("--kind", default="rbf")
    p.add_argument("--d", type=int, default=28)
    p.add_argument("--general", nargs="*", type=_shape)
    p.add_argument("--symmetric", nargs="*", type=_shape)
    p.add_argument("--pair", nargs="*", type=_shape)
    p.add_argument("--comp", nargs="*", type=_shape)
    p.add_argument("--triangle", nargs="*", type=_shape)
    p.add_argument("--f64", nargs="*", type=_shape)
    p.add_argument("--ring", nargs="*", type=_shape)
    p.add_argument("--tree", help=argparse.SUPPRESS)
    p.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.tree:
        print(json.dumps(_run(args)))
        return 0
    groups = (args.general, args.symmetric, args.pair, args.comp, args.triangle, args.f64,
              args.ring)
    if all(g is None for g in groups):
        args.general = [_shape(s) for s in DEFAULT_GENERAL]
        args.symmetric = [_shape(s) for s in DEFAULT_SYMMETRIC]
    shapes = []
    for flag, group in (("--general", args.general), ("--symmetric", args.symmetric),
                        ("--pair", args.pair), ("--comp", args.comp),
                        ("--triangle", args.triangle), ("--f64", args.f64), ("--ring", args.ring)):
        if group:
            shapes += [flag, *(":".join(map(str, shape)) for shape in group)]
    other, this = str(Path(args.other_tree).resolve()), str(HERE)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    me = str(Path(__file__).resolve())

    def start(tree, *extra):
        return subprocess.Popen([sys.executable, me, args.other_tree, "--kind", args.kind,
                                 "--d", str(args.d), *shapes, "--tree", tree, *extra],
                                env=env, stdout=subprocess.PIPE, text=True)

    builds = [start(tree, "--build-only") for tree in (other, this)]
    for b in builds:
        b.communicate()
    if any(b.returncode != 0 for b in builds):
        return 1
    for tree in (other, this, this, other):
        run = start(tree)
        out = run.communicate()[0]
        if run.returncode != 0:
            return run.returncode
        print("before_after " + out.strip().splitlines()[-1], flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
