#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (the kernels are built from
``rlaopt_tpu_torch/csrc/gram.cu`` into ``build/`` on first use). It runs
straight through and exits non-zero at the first failure:

1. device: the card's name and power limit, the two TF32 flags (set off);
2. build of the Gram kernels, timed;
3. each kernel against its plain PyTorch version in float64 on the card, at
   the main path's shapes (HIGGS-100k: n = 100,000, d = 28) and at a ragged
   shape for every family; kernel and plain float32 timed (median of 5,
   CUDA events), and beside K1c the plain float32 TwoSum version of the JAX
   package's compensated contract;
4. the slice: RBF kernel ridge regression, Nyström-PCG (rank 500) through
   ``LinSys.solve`` with k = 1 and then k = 10 right-hand sides; every kernel
   must have launched, the residual must fall, and every logged residual
   must agree within 1% with an independent float64 one;
5. one more solve of each under ``torch.profiler``: the card's busy time
   and each kernel's share (where the time goes);
6. the kernels' JSON line, the card line, and the result line last.

It imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N, D, RANK, ITERS, FREQ = 100_000, 28, 500, 20, 10
SOURCE = "rlaopt_tpu_torch/csrc/gram.cu"
PALLAS = "rlaopt_tpu/ops/kernel_pallas.py"
# K1 and K2 are held to the exact f32 tier's contract with room for fp32
# atomics; K1c works in float64 inside a tile, so it is held to 1e-10.
K_BOUND, COMP_BOUND = 2e-5, 1e-10
# Rows (or columns) per streamed tile of the plain versions on the card:
# 2^26 elements, so that launch overhead does not dominate their times.
BLOCK = (1 << 26) // N


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def synthetic_higgs(n: int, seed: int = 0):
    """Shape-matched HIGGS surrogate (the recipe of the benchmarks' dataset
    module): 28 standard-normal features, a tanh target with noise."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D), dtype=np.float32)
    w = rng.standard_normal(D).astype(np.float32)
    y = np.tanh(X @ w) + 0.1 * rng.standard_normal(n).astype(np.float32)
    return X, y.astype(np.float32)


def extra_targets(X: np.ndarray, k: int, seed: int = 1):
    """k − 1 more targets of the same recipe, for the multi-RHS solve."""
    rng = np.random.default_rng(seed)
    Wx = rng.standard_normal((D, k - 1)).astype(np.float32)
    noise = rng.standard_normal((X.shape[0], k - 1)).astype(np.float32)
    return (np.tanh(X @ Wx) + 0.1 * noise).astype(np.float32)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def plain_twosum_f32(kind, X, V, ls):
    """The JAX package's compensated contract in plain PyTorch: points
    pre-scaled in float32, float32 column-tile partials (the plain K1 on
    BLOCK columns at a time), TwoSum-added into ``(hi, lo)``."""
    from rlaopt_tpu_torch.ops import kernel_plain

    hi = V.new_zeros((X.shape[0], V.shape[1]))
    lo = hi.clone()
    for s in range(0, X.shape[0], BLOCK):
        p = kernel_plain.gram_matmat(kind, X, X[s : s + BLOCK], V[s : s + BLOCK], ls,
                                     row_block=X.shape[0])
        t = hi + p
        z = t - hi
        lo += (hi - (t - z)) + (p - z)
        hi = t
    return hi, lo


def device_breakdown(prof) -> dict:
    """Card busy time (ms) and each Gram kernel's time and launches, from the
    device events of a ``torch.profiler`` run. Empty if no device event was
    recorded."""
    from torch.autograd import DeviceType

    groups = {"gram_matvec_symmetric": [0.0, 0], "gram_matmat_comp": [0.0, 0],
              "gram_matmat": [0.0, 0], "other": [0.0, 0]}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name
        if "gram_matvec_symmetric" in name:
            key = "gram_matvec_symmetric"
        elif "gram_matmat_narrow" in name and "true>" in name:
            key = "gram_matmat_comp"
        elif "gram_matmat" in name:
            key = "gram_matmat"
        else:
            key = "other"
        groups[key][0] += e.time_range.elapsed_us() / 1e3
        groups[key][1] += 1
    busy = sum(g[0] for g in groups.values())
    if busy == 0:
        return {"device": "not measured: the profiler recorded no device event"}
    return {
        "busy_ms": busy,
        "kernels": {key: {"ms": g[0], "events": g[1]} for key, g in groups.items()},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
    from rlaopt_tpu_torch.preconditioners import NystromConfig
    from rlaopt_tpu_torch.solvers import PCGConfig

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(
        "tf32: cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    check(torch.backends.cuda.matmul.allow_tf32 is False, "matmul TF32 is off")
    check(torch.backends.cudnn.allow_tf32 is False, "cuDNN TF32 is off")

    # 2. build
    t0 = time.perf_counter()
    lib = kernel_cuda.build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}")

    # 3. each kernel against its plain version
    Xn, yn = synthetic_higgs(N)
    X = torch.from_numpy(Xn).to(dev)
    ls = D**0.5
    X64 = X.double()
    gen = torch.Generator(device=dev).manual_seed(1)
    Vs = {k: torch.randn((N, k), generator=gen, device=dev) for k in (1, 10, 16, 500)}
    refs = {
        k: kernel_plain.gram_matmat("rbf", X64, X64, Vs[k].double(), ls, row_block=BLOCK)
        for k in (1, 10, 500)
    }
    errors = {"gram_matmat": [], "gram_matmat_comp": [], "gram_matvec_symmetric": []}

    def compare(kernel, got, ref, what):
        torch.cuda.synchronize()
        diff = (got.double() - ref).abs().max().item()
        rel = diff / ref.abs().max().item()
        errors[kernel].append((diff, rel))
        print(f"check {kernel} {what}: max_abs_err={diff:.3e} rel={rel:.3e}")
        return rel

    for k in refs:
        V = Vs[k]
        rel = compare("gram_matmat", kernel_cuda.gram_matmat("rbf", X, X, V, ls),
                      refs[k], f"n=m={N} d={D} k={k}")
        check(rel <= K_BOUND, f"gram_matmat k={k} within {K_BOUND}")
        if k == 1:
            rel_k1 = rel
    for k in (1, 10):
        rel = compare("gram_matvec_symmetric",
                      kernel_cuda.gram_matvec_symmetric("rbf", X, Vs[k], ls),
                      refs[k], f"n={N} d={D} k={k}")
        check(rel <= K_BOUND, f"gram_matvec_symmetric k={k} within {K_BOUND}")
    hi, lo = kernel_cuda.gram_matmat_comp("rbf", X, X, Vs[1], ls)
    rel = compare("gram_matmat_comp", hi.double() + lo.double(), refs[1],
                  f"n=m={N} d={D} k=1 (hi+lo)")
    check(rel <= COMP_BOUND and rel <= rel_k1,
          f"gram_matmat_comp within {COMP_BOUND} and no worse than gram_matmat")
    jhi, jlo = plain_twosum_f32("rbf", X, Vs[1], ls)
    diff = (jhi.double() + jlo.double() - refs[1]).abs().max().item()
    twosum_f32_rel = diff / refs[1].abs().max().item()
    print(f"check plain f32 TwoSum (the JAX package's compensated contract) "
          f"n=m={N} d={D} k=1 (hi+lo): max_abs_err={diff:.3e} rel={twosum_f32_rel:.3e}")

    rng = np.random.default_rng(2)
    A1 = torch.from_numpy(rng.standard_normal((1000, 3)).astype(np.float32)).to(dev)
    A2 = torch.from_numpy(rng.standard_normal((777, 3)).astype(np.float32)).to(dev)
    W7 = torch.from_numpy(rng.standard_normal((777, 7)).astype(np.float32)).to(dev)
    S7 = torch.from_numpy(rng.standard_normal((1000, 7)).astype(np.float32)).to(dev)
    for kind in ("rbf", "matern12", "matern32", "matern52"):
        ref = kernel_plain.gram_matmat(kind, A1.double(), A2.double(), W7.double(), 1.3, 0.9)
        rel = compare("gram_matmat", kernel_cuda.gram_matmat(kind, A1, A2, W7, 1.3, 0.9),
                      ref, f"{kind} n=1000 m=777 d=3 k=7")
        check(rel <= K_BOUND, f"gram_matmat {kind} ragged within {K_BOUND}")
        hi, lo = kernel_cuda.gram_matmat_comp(kind, A1, A2, W7, 1.3, 0.9)
        rel_c = compare("gram_matmat_comp", hi.double() + lo.double(), ref,
                        f"{kind} n=1000 m=777 d=3 k=7 (hi+lo)")
        check(rel_c <= COMP_BOUND and rel_c <= rel,
              f"gram_matmat_comp {kind} ragged within {COMP_BOUND}")
        ref = kernel_plain.gram_matmat(kind, A1.double(), A1.double(), S7.double(), 1.3, 0.9)
        rel = compare("gram_matvec_symmetric",
                      kernel_cuda.gram_matvec_symmetric(kind, A1, S7, 1.3, 0.9),
                      ref, f"{kind} n=1000 d=3 k=7")
        check(rel <= K_BOUND, f"gram_matvec_symmetric {kind} ragged within {K_BOUND}")
    del refs

    def cuda_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    # The first shape of each kernel is the one its JSON entry reports.
    timings = {}
    for kernel, k in (
        ("gram_matmat", 500), ("gram_matmat", 1), ("gram_matmat", 10),
        ("gram_matmat", 16),
        ("gram_matvec_symmetric", 1), ("gram_matvec_symmetric", 10),
        ("gram_matvec_symmetric", 16),
        ("gram_matmat_comp", 1), ("gram_matmat_comp", 10),
    ):
        V = Vs[k]
        if kernel == "gram_matvec_symmetric":
            fn = lambda: kernel_cuda.gram_matvec_symmetric("rbf", X, V, ls)
            plain = lambda: kernel_plain.gram_matvec_symmetric("rbf", X, V, ls, row_block=BLOCK)
        elif kernel == "gram_matmat":
            fn = lambda: kernel_cuda.gram_matmat("rbf", X, X, V, ls)
            plain = lambda: kernel_plain.gram_matmat("rbf", X, X, V, ls, row_block=BLOCK)
        else:
            fn = lambda: kernel_cuda.gram_matmat_comp("rbf", X, X, V, ls)
            plain = lambda: kernel_plain.gram_matmat_comp("rbf", X, X, V, ls, col_block=BLOCK)
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain)
        shape = f"n={N} d={D} k={k}"
        entry = {"shape": shape, "ms": ms, "plain_ms": plain_ms}
        line = f"time {kernel} {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
        if kernel == "gram_matmat_comp":
            entry["plain_f32_twosum_ms"] = cuda_ms(lambda: plain_twosum_f32("rbf", X, V, ls))
            line += f", plain f32 TwoSum {entry['plain_f32_twosum_ms']:.3f} ms"
        timings.setdefault(kernel, []).append(entry)
        print(line)

    # 4. the slice, through the entry points a user calls
    reg = 1e-4 * N
    K = RBFLinOp(X, X, KernelConfig(lengthscale=ls))
    cfg = PCGConfig(
        max_iters=ITERS, rtol=1e-6,
        precond_config=NystromConfig(rank=RANK, rho=reg),
    )
    Y1 = torch.from_numpy(yn).to(dev)
    Y10 = torch.cat([Y1[:, None], torch.from_numpy(extra_targets(Xn, 10)).to(dev)], 1)
    kernel_cuda.reset_launch_counts()
    solves = []
    for B in (Y1, Y10):
        before = kernel_cuda.launch_counts()
        sys_ = LinSys(K, B, reg=reg)
        k = 1 if B.ndim == 1 else B.shape[1]
        iterates = []  # W at every logging boundary, for the float64 check
        t0 = time.perf_counter()
        W, log = sys_.solve(
            cfg, torch.zeros((N, k), device=dev), callback_freq=FREQ, key=0,
            callback_fn=lambda w, _model: iterates.append(w.clone()),
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = kernel_cuda.launch_counts()
        solves.append((k, iterates, log, sys_, wall, {n_: after[n_] - before[n_] for n_ in after}))
    counts = kernel_cuda.launch_counts()

    for k, iterates, log, sys_, wall, used in solves:
        iters = max(log)
        hist = {i: log[i]["metrics"]["internal_metrics"]["rel_res"].tolist() for i in sorted(log)}
        for i, r in hist.items():
            print(f"slice k={k} iter {i}: rel_res {r}")
        s_iter = sys_.phase_walls["train"] / iters
        print(f"slice k={k}: phase_walls {sys_.phase_walls} wall {wall:.3f} s "
              f"s/iter {s_iter:.4f} launches {used}")
        first, last = np.array(hist[0]), np.array(hist[iters])
        check(np.all(np.isfinite(last)), f"k={k} rel_res finite")
        check(np.all(last < first), f"k={k} rel_res falls")
        check(used["gram_matmat"] > 0, f"k={k} sketch ran through gram_matmat")
        check(used["gram_matmat_comp"] > 0, f"k={k} residuals ran through gram_matmat_comp")
        check(used["gram_matvec_symmetric"] >= iters,
              f"k={k} every PCG step ran through gram_matvec_symmetric")
        B64 = sys_.B.double()
        b_norms = torch.linalg.norm(B64, dim=0).cpu().numpy()
        for i, Wi in zip(sorted(log), iterates):
            if i == 0:
                continue
            W64 = Wi.double()
            KW = kernel_plain.gram_matmat("rbf", X64, X64, W64, ls, row_block=BLOCK)
            R64 = B64 - (KW + reg * W64)
            rel64 = torch.linalg.norm(R64, dim=0).cpu().numpy() / b_norms
            gaps = np.abs(np.array(hist[i]) - rel64) / rel64
            print(f"slice k={k} iter {i}: independent float64 rel_res "
                  f"{rel64.tolist()}; gaps {gaps.tolist()}")
            check(np.all(gaps <= 0.01),
                  f"k={k} rel_res at iteration {i} within 1% of float64")
        print("slice " + json.dumps({"k": k, "iters": iters, "s_per_iter": s_iter}))

    # 5. where the time goes: one more solve of each, profiled
    for B in (Y1, Y10):
        k = 1 if B.ndim == 1 else B.shape[1]
        sys_ = LinSys(K, B, reg=reg)
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
        ) as prof:
            t0 = time.perf_counter()
            sys_.solve(cfg, torch.zeros((N, k), device=dev), callback_freq=FREQ, key=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile = {"k": k, "wall_s": wall, "phase_walls": sys_.phase_walls}
        profile.update(device_breakdown(prof))
        print("profile " + json.dumps(profile))

    # 6. result lines
    kernels = []
    comp = timings["gram_matmat_comp"][0]
    comp["plain_f32_twosum_rel_err"] = twosum_f32_rel
    for kname, replaces in (
        ("gram_matmat", f"{PALLAS}:733"),
        ("gram_matmat_comp", f"{PALLAS}:733"),
        ("gram_matvec_symmetric", f"{PALLAS}:1366"),
    ):
        main_t = timings[kname][0]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": SOURCE,
            "replaces": replaces,
            "launches": counts[kname],
            "max_abs_err": max(e[0] for e in errors[kname]),
            "max_rel_err": max(e[1] for e in errors[kname]),
            "ms": main_t["ms"],
            "plain_ms": main_t["plain_ms"],
            "shape": main_t["shape"],
            "timings": timings[kname],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
