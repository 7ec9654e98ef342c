#!/usr/bin/env python3
"""Check and time K1's two kernels past 16 columns on one card.

    python3 tools/wide_routes.py [--n N] [--d D ...] [--ks K ...]
        [--kinds KIND ...] [--routes ROUTE ...] [--variants MACRO=VALUE ...]
        [--bn BN ...] [--out PATH]

Builds ``csrc/gram_wide.cu`` (the ``mma.sync`` kernel, route ``"wide"``)
and ``csrc/gram_wide_ws.cu`` (the warpgroup form, route ``"warpgroup"``)
into a library of their own under ``build/`` (the rest of the port's
kernels are not needed here), and one more copy of the warpgroup form for
each ``--variants`` definition (``WIDE_WS_ABLATE=1``: no products, ``=2``:
no values, ``=3``: neither; several joined by commas). Then, on the HIGGS
surrogate of ``chip_smoke.py`` (N x D standard normal, lengthscale
sqrt(D), V standard normal), for each D, family and k, each route forced
in turn through
``kernel_cuda.gram_matmat`` on the operand an operator keeps: the error
against the plain float64 product on 2,048 sampled rows (max |err| over
max |ref|), whether two calls give the same bits, and the CUDA-event median
of 5 calls after one. Then, with ``--variants`` or ``--bn``, the warpgroup
form as built and each variant at each ``--bn`` width of its blocks (the
width ``wide_ws_cols`` picks without it), timed and checked at the last k
in RBF, beside the ``mma.sync`` kernel's error on the same inputs. Small
shapes first: a ragged check (n = 1000, m = 777 and others) of each route,
family and k against float64 before any timing.

Prints one JSON line a measurement (``wide_routes {...}``), the
``-Xptxas -v`` registers and spills of both kernels and the compiler's
warnings, the count of each ``wgmma`` wait in the warpgroup form's machine
code (``cuobjdump -sass``), and the card's name and power limit; with
``--out`` the lines also go to that file. Needs one CUDA card and ``nvcc``.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

ENTRIES = ("rl_gram_matmat_wide", "rl_gram_matmat_wide_ws")


def _build(kernel_cuda, variants):
    """The two wide kernels' library and one of the warpgroup form for each
    variant: ``{variant: ctypes library}`` ("" the kernels as built for the
    port), and each build's compiler output."""
    out = kernel_cuda._BUILD_DIR
    out.mkdir(parents=True, exist_ok=True)
    nvcc = kernel_cuda._nvcc()
    flags = [f for f in kernel_cuda.COMPILE_FLAGS if f != "-c"]
    csrc = kernel_cuda._CSRC
    jobs = {"": [str(csrc / "gram_wide.cu"), str(csrc / "gram_wide_ws.cu")]}
    jobs.update({v: [*(f"-D{m}" for m in v.split(",")), str(csrc / "gram_wide_ws.cu")]
                 for v in variants})
    paths = {v: out / f"wide_routes{i}.so" for i, v in enumerate(jobs)}
    procs = {v: subprocess.Popen([nvcc, *flags, "-shared", "-o", str(paths[v]), *src],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for v, src in jobs.items()}
    logs = {v: p.communicate()[0] for v, p in procs.items()}
    for v, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (variant {v!r}):\n{logs[v]}")
    libs = {}
    for v in jobs:
        lib = ctypes.CDLL(str(paths[v]))
        for name in ENTRIES if not v else ENTRIES[1:]:
            fn = getattr(lib, name)
            fn.argtypes = kernel_cuda._SIGNATURES[name]
            fn.restype = ctypes.c_int
        libs[v] = lib
    return libs, logs, paths


def _sass_waits(path, nvcc) -> dict:
    """Per warpgroup-form kernel, the count of HGMMA instructions and of the
    waits on them (WARPGROUP.DEPBAR) in its machine code."""
    try:
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                               str(path)], capture_output=True, text=True, timeout=300).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": str(e)}
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "gram_wide_ws" in m.group(1) else None
            continue
        if fn is not None:
            c = counts.setdefault(fn, {"HGMMA": 0, "DEPBAR": 0})
            c["HGMMA"] += "HGMMA" in line
            c["DEPBAR"] += "WARPGROUP.DEPBAR" in line
    return counts


def _registers(log: str) -> dict:
    report, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = m.group(1) if "gram_wide" in m.group(1) else None
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report.setdefault(key, {})["spills"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report.setdefault(key, {})["registers"] = int(m.group(1))
    return report


def _cuda_ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--d", type=int, nargs="*", default=[28])
    p.add_argument("--ks", type=int, nargs="*", default=[17, 32, 64, 200, 500])
    p.add_argument("--kinds", nargs="*", default=["rbf"])
    p.add_argument("--routes", nargs="*", default=["wide", "warpgroup"])
    p.add_argument("--variants", nargs="*", default=[])
    p.add_argument("--bn", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args()

    import numpy as np
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = "wide_routes " + json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    libs, logs, paths = _build(kernel_cuda, args.variants)
    emit({"registers": _registers(logs[""])})
    emit({"warnings": [line for line in logs[""].splitlines()
                       if re.search(r"arning|Potential|C75", line)]})
    emit({"sass": _sass_waits(paths[""], kernel_cuda._nvcc())})
    kernel_cuda._lib["handle"], kernel_cuda._lib["path"] = libs[""], paths[""]
    dev = torch.device("cuda", 0)
    forced = kernel_cuda.wide_route

    def on(route, fn):
        kernel_cuda.wide_route = lambda k, dp: route
        try:
            return fn()
        finally:
            kernel_cuda.wide_route = forced

    # ragged shapes first: every route, family and k against float64
    rng = np.random.default_rng(43)
    for n1, m1, d in ((1000, 777, 3), (1000, 777, 28), (300, 1300, 70)):
        P1 = torch.from_numpy(rng.standard_normal((n1, d)).astype(np.float32)).to(dev)
        P2 = torch.from_numpy(rng.standard_normal((m1, d)).astype(np.float32)).to(dev)
        ls = d**0.5
        for kind in ("rbf", "matern52", "laplace"):
            for k in args.ks:
                V = torch.from_numpy(rng.standard_normal((m1, k)).astype(np.float32)).to(dev)
                ref = kernel_plain.gram_matmat_f64(kind, P1, P2, V, ls, 0.9)
                for route in args.routes:
                    got = on(route, lambda: kernel_cuda.gram_matmat(kind, P1, P2, V, ls, 0.9))
                    torch.cuda.synchronize()
                    err = ((got.double() - ref).abs().max() / ref.abs().max()).item()
                    emit({"check": f"{kind} n={n1} m={m1} d={d} k={k}", "route": route,
                          "rel_err": err})
                    if not err < 2e-5:
                        raise SystemExit(f"{route} {kind} n={n1} m={m1} d={d} k={k}: {err}")

    n = args.n
    gen = torch.Generator(device=dev).manual_seed(7)
    for d in args.d:
        X = torch.randn((n, d), generator=gen, device=dev)
        ls = d**0.5
        XT = kernel_cuda.tile_operand(X, ls)
        idx = torch.randperm(n, generator=gen, device=dev)[:2048]
        for kind in args.kinds:
            for k in args.ks:
                V = torch.randn((n, k), generator=gen, device=dev)
                ref = kernel_plain.gram_matmat_f64(kind, X[idx], X, V, ls, row_block=512)
                for route in args.routes:
                    def call():
                        return kernel_cuda.gram_matmat(kind, X, X, V, ls, 1.0, XT, XT)
                    one, two = on(route, call), on(route, call)
                    torch.cuda.synchronize()
                    diff = one[idx].double() - ref
                    err = (diff.abs().max() / ref.abs().max()).item()
                    rms = (diff.norm() / ref.norm()).item()
                    same = bool(torch.equal(one, two))
                    del one, two
                    ms = on(route, lambda: _cuda_ms(call))
                    emit({"time": f"{kind} n=m={n} d={d} k={k}", "route": route, "ms": ms,
                          "rel_err": err, "rms_err": rms, "same_bits": same})
                del ref, V
        if args.variants or args.bn:
            k = args.ks[-1]
            V = torch.randn((n, k), generator=gen, device=dev)
            ref = kernel_plain.gram_matmat_f64("rbf", X[idx], X, V, ls, row_block=512)
            kept = kernel_cuda.wide_ws_cols
            for v, lib in libs.items():
                kernel_cuda._lib["handle"] = lib
                for bn in args.bn or [kept(k)]:
                    kernel_cuda.wide_ws_cols = lambda k: bn

                    def call():
                        return kernel_cuda.gram_matmat("rbf", X, X, V, ls, 1.0, XT, XT)
                    diff = on("warpgroup", call)[idx].double() - ref
                    err = (diff.abs().max() / ref.abs().max()).item()
                    rms = (diff.norm() / ref.norm()).item()
                    ms = on("warpgroup", lambda: _cuda_ms(call))
                    emit({"variant": v or "as built", "bn": bn,
                          "shape": f"rbf n=m={n} d={d} k={k}", "ms": ms, "rel_err": err,
                          "rms_err": rms})
            kernel_cuda.wide_ws_cols = kept
            kernel_cuda._lib["handle"] = libs[""]
            diff = on("wide", lambda: kernel_cuda.gram_matmat(
                "rbf", X, X, V, ls, 1.0, XT, XT))[idx].double() - ref
            emit({"variant": "mma.sync kernel", "shape": f"rbf n=m={n} d={d} k={k}",
                  "rel_err": (diff.abs().max() / ref.abs().max()).item(),
                  "rms_err": (diff.norm() / ref.norm()).item()})
            del ref, V, diff
        del X, XT
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit({"card": card.strip()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
