#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on a CUDA card and check them.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (the kernels are built from
``rlaopt_tpu_torch/csrc/*.cu`` into ``build/`` on first use). It runs
straight through and exits non-zero at the first failure:

1. device: the card's name and power limit, the two TF32 flags (set off);
2. build of the Gram kernels, timed, and the registers and spills of K2b
   and of #9's short-row schedule from the build's ``-Xptxas -v`` log;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes (HIGGS-100k: n = 100,000, d = 28) and at a ragged shape
   for every family: K1, K1c, K2 against float64; K1b and K2b on both bf16
   tiers against the plain version of the same tier and against float64;
   K7 and K8, all five families, against the float64 plain version; kernel
   and plain version timed (median of 5, CUDA events);
4. slice 1, config 3 whole: RBF kernel ridge regression, Nyström-PCG (rank
   500) through ``LinSys.solve`` with k = 1 and k = 10 right-hand sides,
   then the k = 1 solve again with two float64 refinement rounds; every
   kernel of the path must have launched, the residual must fall, every
   logged residual must agree within 1% with an independent float64 one,
   and the refined residual must clear 1e-6 and agree with its own;
5. one more solve of each k under ``torch.profiler``: the card's busy time
   and each kernel's share (where the time goes);
6. slice 2, config 6: the n = 1,000,000 north-star solve on the bf16x3
   operator with update-mode refinement and the sampled certificate, under
   ``torch.profiler``; the certificate, a full float64 sweep of the
   delivered solution and an independent sampled float64 residual (plain
   version, other rows) must all put it at or under 1e-6; then K1b (k =
   500), K2b (k = 1 and 10), K1c, K7 and K8 against their plain versions
   at the path's n = m = 1,000,000, on those 4,096 rows, and K2b timed
   beside the exact K2 on the same points at k = 1 and 10;
7. slice 3: the Laplace kernels K3, K3c and K5 against the float64 plain
   version at the HIGGS shape (on 4,096 rows) and the ragged one, timed;
   path B, Nyström-PCG on ``LaplaceLinOp`` at the HIGGS-100k shape (k = 1,
   k = 10, k = 1 refined), every logged residual within 1% of a float64 one;
   path A, ASkotch (SAP) on ``LaplaceLinOp`` at config 4's n = 1,000,000,
   d = 50, and path A', config 4 as written (bf16x3 RBF), both under
   ``torch.profiler`` with sampled metrics, each sampled estimate within
   5 sigma of an independent float64 residual on other rows; then K3, K3c,
   K1b and K1c at the paths' block-oracle shape (10,000 x 1,000,000),
   checked on 4,096 rows, and the dense block's peak memory;
8. slice 4: path S, ``LstSq(SparseCSRTensor(A), b)`` with LSQR and the
   sparse SkPre sketch on a 2^20 x 1,024 CSR operand with 16 nonzeros a row
   (k = 1, k = 10), every logged rel_res against scipy's float64 one, the
   launches of #9 (``csr_spmv``, ``csr_spmm``) against the path's count, the
   sketch's peak memory; #9 against its float64 plain version at the path's
   shapes (k = 1 and 10 both ways, the sketch) and on two ragged operands
   (rows of 0 to 20,000 entries) in every schedule, float32 and float64,
   the same bits twice, timed beside its plain version and cuSPARSE (the
   forward SpMV at every lanes value too); a k = 1 solve profiled; then
   path C', config 2 as written (dense, SRHT);
9. slice 5, the sharded operators on positions of the one card
   (``make_mesh(devices=[card] * P)``): the pair kernels K4, K4b, K6 against
   float64 (K4b also against its tier's plain version) at k = 1, 3, 16 at a
   ragged shape and at each path's shard shape, timed there; path E1, config
   5 as written (``benchmarks/run.py::config5_sharded_krr``: n = 50,000,
   ``ShardedRBFLinOp`` on ``make_mesh()``, ``lanczos_eigsh``, ``hutchinson``,
   Nyström-PCG), profiled; E2, the same on a 4-position ring (the symmetric
   half-ring: K2 and K4) with one float64 refinement round; E3, the Laplace
   half-ring on 3 positions at path B's shape (K5, K6); E4, the bf16x3 ring
   at config 6's n = 1,000,000 on 4 positions (K2b, K4b), five matvecs
   timed against K2b on the unsharded operator. Each ring matvec against
   the unsharded operator's and float64, its launches against the
   schedule's count, every logged rel_res against an independent float64
   one, Hutchinson's trace against the exact c·n;
10. the kernels' JSON line (each with its bound, ``bound_ms``), the card
   line, and the result line last.

It imports nothing of JAX.
"""

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

N, D, RANK, ITERS, FREQ = 100_000, 28, 500, 20, 10
# Config 6 (benchmarks/run.py::config6_northstar_1m_pcg), with callback_freq
# 10 in place of the 3 that the TPU's execution watchdog forced there.
N6, ITERS6, FREQ6 = 1_000_000, 60, 10
# Config 4 (benchmarks/run.py::config4_askotch_1m): n = 1M, d = 50, blocks of
# n/100, Nyström rank 100, sampled metrics every 100 iterations. Path A runs
# it on the Laplace kernel, path A' as written, each for 200 iterations
# (config 4 runs 1000): SAP's residual norm first rises, and at 100 the
# bf16x3 RBF solve's had not come back below the start's 1.
N4, D4, ITERS4, FREQ4 = 1_000_000, 50, 200, 100
BLK4, RANK4, REG4 = N4 // 100, 100, 1e-2
# Laplace lengthscales: the mean L1 distance of the data (2·sqrt(d/pi) for
# config 4's rows, 2d/sqrt(pi) for d standard-normal features), where kernel
# values sit near e^-1.
LS_A, LS_B = 8.0, 32.0
# Slice 4, path S: the operand of bench.py::make_sparse_tallskinny (2^20 rows,
# 1,024 columns, 16 nonzeros a row, numpy seed 5) with its columns scaled by
# logspace(0, -4) as config 2 scales its columns; LSQR with SkPre at config
# 2's settings (sketch 4n, rho 0, 100 iterations, rtol 1e-6, callback_freq
# 5), k = 1 and k = 10. Path C': config 2 as written
# (benchmarks/run.py::config2_srht_lsqr), its data from numpy seed 0.
S_ROWS, S_COLS, S_WIDTH = 1 << 20, 1024, 16
S_SKETCH, S_ITERS, S_FREQ, S_RTOL = 4 * S_COLS, 100, 5, 1e-6
C2_M, C2_N = 100_000, 1_000
# Slice 5: config 5 (benchmarks/run.py::config5_sharded_krr) at its n =
# 50,000, Lanczos 20 steps, Hutchinson 32 Gaussian probes, Nyström rank
# 200, PCG 50 iterations at rtol 1e-6, callback_freq 10; the ring paths on
# P positions of the one card.
N5, ITERS5, RANK5, LANCZOS5, PROBES5 = 50_000, 50, 200, 20, 32
P_RING, P_LAPLACE = 4, 3
SOURCES = {
    "gram": "rlaopt_tpu_torch/csrc/gram.cu",
    "laplace": "rlaopt_tpu_torch/csrc/gram_laplace.cu",
    "tier": "rlaopt_tpu_torch/csrc/gram_tier.cu",
    "f64": "rlaopt_tpu_torch/csrc/gram_f64.cu",
    "spmv": "rlaopt_tpu_torch/csrc/spmv.cu",
    "pair": "rlaopt_tpu_torch/csrc/gram_pair.cu",
}
PALLAS = "rlaopt_tpu/ops/kernel_pallas.py"
VALUE64 = "rlaopt_tpu/ops/kernel_value64.py"
LANED = "rlaopt_tpu/sparse/laned.py"
# K1 and K2 are held to the exact f32 tier's contract with room for fp32
# atomics; K1c, K7 and K8 work in float64 inside a tile, so they are held to
# 1e-10 of the float64 plain version.
K_BOUND, COMP_BOUND = 2e-5, 1e-10
# K1b and K2b against the plain version of their tier: the same bf16
# roundings, so only the order of the f32 sums and expf differ. Where the
# one-pass tier re-rounds float32 kernel values to bf16 (the "fast"
# contraction at k > 16, the mirror rows at k >= 3), a value that differs
# from the plain version's in its last float bit now and then rounds the
# other way, 2^-8 of that product: held to 5e-4 there.
TIER_BOUND, REROUND_BOUND = 1e-5, 5e-4
# bf16x3 against float64 at the HIGGS shape.
BF16X3_F64_BOUND = 2e-5
# The JAX package's Pallas tiers in interpret mode against the float64
# product (max abs error / max|ref|), on the data of each check, measured on
# the CPU by tests/test_torch_tiers.py. K1b and K2b are held to 3x these
# against float64 where no fixed bound is set. "gen" is
# kernel_matmat_pallas, "sym" kernel_matvec_symmetric (tile 512). Ragged:
# ragged_data(); HIGGS: synthetic_higgs(1024) with itself at lengthscale
# sqrt(28), the size the interpreter runs in seconds. "pair" is
# kernel_pair_matmat on ragged_data()'s points and pair_ragged_rhs(k): the
# largest error of both outputs at k = 1 and 3, above k = 16's on this data.
JAX_TIER_ERR = {
    ("ragged", "bf16x3", "gen", "rbf"): 6.5e-6,
    ("ragged", "bf16x3", "gen", "matern12"): 2.1e-5,
    ("ragged", "bf16x3", "gen", "matern32"): 7.6e-6,
    ("ragged", "bf16x3", "gen", "matern52"): 6.2e-6,
    ("ragged", "bf16x3", "sym", "rbf"): 1.4e-5,
    ("ragged", "bf16x3", "sym", "matern12"): 1.2e-3,
    ("ragged", "bf16x3", "sym", "matern32"): 2.9e-5,
    ("ragged", "bf16x3", "sym", "matern52"): 1.8e-5,
    ("ragged", "bfloat16", "gen", "rbf"): 2.8e-3,
    ("ragged", "bfloat16", "gen", "matern12"): 1.2e-2,
    ("ragged", "bfloat16", "gen", "matern32"): 3.5e-3,
    ("ragged", "bfloat16", "gen", "matern52"): 3.1e-3,
    ("ragged", "bfloat16", "sym", "rbf"): 4.0e-3,
    ("ragged", "bfloat16", "sym", "matern12"): 2.2e-2,
    ("ragged", "bfloat16", "sym", "matern32"): 5.4e-3,
    ("ragged", "bfloat16", "sym", "matern52"): 4.0e-3,
    ("ragged", "bf16x3", "pair", "rbf"): 1.7e-5,
    ("ragged", "bf16x3", "pair", "matern12"): 2.8e-5,
    ("ragged", "bf16x3", "pair", "matern32"): 1.7e-5,
    ("ragged", "bf16x3", "pair", "matern52"): 1.7e-5,
    ("ragged", "bfloat16", "pair", "rbf"): 5.8e-3,
    ("ragged", "bfloat16", "pair", "matern12"): 2.8e-2,
    ("ragged", "bfloat16", "pair", "matern32"): 7.0e-3,
    ("ragged", "bfloat16", "pair", "matern52"): 6.1e-3,
    ("higgs", "bfloat16", "gen", 1): 7.8e-4,
    ("higgs", "bfloat16", "gen", 10): 5.4e-4,
    ("higgs", "bfloat16", "sym", 1): 7.8e-4,
    ("higgs", "bfloat16", "sym", 10): 2.2e-3,
}
# The interpreter runs the one-pass "fast" contraction of k > 16 in full
# float32 (a DEFAULT-precision dot off the TPU), so at k = 500 the bfloat16
# bound adds that contraction's own rounding, 2^-8 (K and V each rounded).
FAST_CONTRACTION = 2.0**-8
# Rows (or columns) per streamed tile of the plain versions on the card:
# 2^26 elements, so that launch overhead does not dominate their times.
BLOCK = (1 << 26) // N
SQDIST_KINDS = ("rbf", "matern12", "matern32", "matern52")
TIERS = ("bf16x3", "bfloat16")
# The least time the card could take (bound_ms): NVIDIA's data sheet of the
# H100 SXM, dense rates at 700 W: 67 TFLOP/s float32 outside the tensor
# cores, 34 TFLOP/s float64 outside them, 989 TFLOP/s bf16 on the tensor
# cores, 3.35 TB/s of HBM. An FMA counts two operations, any other one. The
# special-function unit (ex2, rsqrt: the float32 exp and sqrt) issues 16
# results a clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) on 132 SMs at the 1.98 GHz boost
# clock of the data sheet.
PEAK = {"fp32": 67e12, "fp64": 34e12, "bf16_tc": 989e12, "sfu": 16 * 132 * 1.98e9}
HBM_BYTES_PER_S = 3.35e12
# #9 (csr_spmv, csr_spmm) against the float64 plain version. In float64 a
# row's sum of L products is off by ~sqrt(L)·2^-53 of its size (1.4e-14 at
# L = 16,384): held to 1e-12. In float32 the row is summed by 32 lanes (a
# warp) or 256 threads (a block), each over L/32 or L/256 terms in order,
# then added in a tree, or (k > 16) by one lane over all L terms in order:
# at worst-typical sqrt(L)·2^-24 = 7.6e-6 of max|ref| for the adjoint's L =
# 16,384, 6.6x under the bound.
CSR_F64_BOUND, CSR_F32_BOUND = 1e-12, 5e-5
# Paths S and C': each logged rel_res (the float32 normal residual
# ‖Aᵀ(b − AW)‖/‖Aᵀb‖, through #9 on S, cuBLAS on C') against the float64 one
# of the same iterate (scipy or numpy on the host): within 1% above 1e-5;
# below it within RES_ABS absolute. Near the solution ‖Aᵀr‖ ≪ Σ|a||r|, and
# what remains of the float32 sums' rounding is a fixed share of ‖Aᵀb‖: up
# to 1.07e-7 measured on an H100 (config 2; 5.2e-8 on S), held to 5x that.
RES_REL, RES_ABS, RES_ABOVE = 0.01, 5e-7, 1e-5
COMP_KERNELS = ("gram_matmat_comp", "laplace_matmat_comp")
F64_KERNELS = ("gram_matmat_f64", "gram_matvec_symmetric_f64")
TIER_KERNELS = ("gram_matmat_tier", "gram_matvec_symmetric_tier", "gram_pair_tier")
PAIR_KERNELS = ("gram_pair", "gram_pair_tier", "laplace_pair")
CSR_KERNELS = ("csr_spmv", "csr_spmm")


def bound_ms(kernel, n, m, d, k, kind="rbf", cd=None, nnz=None):
    """``(ms, "bytes" or "operations")``: the least time of one call at these
    shapes, the larger of the bytes it must move (each input read once, each
    output written once) over the HBM rate and its operations over the peak
    of their unit. Per kernel value: a subtraction and an FMA per feature
    (the squared distance) or a subtraction and an add (Laplace's L1), in
    float32 or, for K1c, K3c, K7 and K8, float64 (the lengthscale's
    division is O((n + m) d) work and not counted); the exponential, one
    SFU operation (and one more for the Matérn square root) where the
    epilogue is float32, one float64 operation in K1c, K3c, K7 and K8; 2k
    for the contraction. The triangle kernels evaluate each
    of the n^2/2 values of a pair of tiles once and contract it both ways;
    the pair kernels each of the n·m values once, contracted both ways (4k),
    reading V1 (n, k) besides V2 and writing out2 (m, k) besides out1.
    The tiers: the cross term on the tensor cores (2 operations per feature
    of d, per pass), three float32 operations and the exponential (SFU) of
    epilogue per value, the
    contraction in float32 up to 16 columns and on the tensor cores (per
    pass) past that; their points are read as d bf16 parts (two with
    bf16x3) and a float32 norm each. The CSR product (``csr_spmv``,
    ``csr_spmm``; n rows, m columns, ``nnz`` nonzeros, values of type ``cd``,
    float32 by default): each nonzero's index and value, the int64 indptr,
    X (m, k) and Y (n, k) once; an FMA per nonzero and column."""
    if kernel in CSR_KERNELS:
        vb = 8 if cd == "float64" else 4
        nbytes = nnz * (4 + vb) + 8 * (n + 1) + vb * k * (m + n)
        t_ops = 2.0 * nnz * k / PEAK["fp64" if vb == 8 else "fp32"]
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    sym = "symmetric" in kernel
    if sym:
        m = n
    values = n * n / 2 if sym else float(n) * m
    pair = kernel in PAIR_KERNELS
    contraction = (4.0 if pair else 2.0) * k * n * m
    vk = 4 * (m + n) * k if pair else 0  # the pair's V1 read and out2 written
    per_feature = 2 if kind == "laplace" else 3
    ops = {}
    if not (kernel in COMP_KERNELS or kernel in F64_KERNELS):
        ops["sfu"] = values * (2 if kind.startswith("matern") else 1)
    if kernel in COMP_KERNELS or kernel in F64_KERNELS:
        ops["fp64"] = values * (per_feature * d + 1) + contraction
        vb = 8 if kernel in F64_KERNELS else 4
        outs = 1 if kernel in F64_KERNELS else 2
        nbytes = 4 * (n + (0 if sym else m)) * d + vb * m * k + vb * outs * n * k
    elif kernel in TIER_KERNELS:
        passes = 3 if cd == "bf16x3" else 1
        ops["bf16_tc"] = values * 2 * d * passes + (contraction * passes if k > 16 else 0)
        ops["fp32"] = values * 3 + (contraction if k <= 16 else 0)
        parts = 2 * d * (2 if passes == 3 else 1) + 4
        nbytes = parts * (n + (0 if sym else m)) + 4 * m * k + 4 * n * k + vk
    else:
        ops["fp32"] = values * per_feature * d + contraction
        nbytes = 4 * (n + (0 if sym else m)) * d + 4 * m * k + 4 * n * k + vk
    t_ops = max(v / PEAK[unit] for unit, v in ops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def ptxas_report(log: str, names) -> dict:
    """Registers and spills of each instantiation of the kernels ``names``,
    from the build's ``-Xptxas -v`` log: ``{"name<args>": {"registers": R,
    "spill_stores": bytes, "spill_loads": bytes}}``; the template arguments
    read from the mangled name (f float, d double, integers)."""
    report, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = None
            for name in names:
                at = m.group(1).find(name)
                if at >= 0:
                    tail = m.group(1)[at + len(name):].split("EE")[0]
                    args = [a or b for a, b in re.findall(r"I?([fd])|Li(\d+)E?", tail)]
                    key = f"{name}<{','.join(args)}>"
                    report[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report[key]["spill_stores"] = int(m.group(1))
            report[key]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[key]["registers"] = int(m.group(1))
    return report


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


def ragged_data():
    """The ragged check shape: X1 (1000, 3), X2 (777, 3), right-hand sides
    W (777, 7) for X2 and S (1000, 7) for X1; lengthscale 1.3, c = 0.9."""
    rng = np.random.default_rng(2)
    A1 = rng.standard_normal((1000, 3)).astype(np.float32)
    A2 = rng.standard_normal((777, 3)).astype(np.float32)
    W = rng.standard_normal((777, 7)).astype(np.float32)
    S = rng.standard_normal((1000, 7)).astype(np.float32)
    return A1, A2, W, S


def pair_ragged_rhs(k: int):
    """The pair check's right-hand sides at the ragged shape: V2 (777, k)
    for X2 and V1 (1000, k) for X1."""
    rng = np.random.default_rng(21 + k)
    V2 = rng.standard_normal((777, k)).astype(np.float32)
    V1 = rng.standard_normal((1000, k)).astype(np.float32)
    return V2, V1


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


# csrc/gram_common.cuh's template arguments: the family first (LAPLACE is 4),
# the Mode last (EXACT 0, COMP 1, F64 2, TIER1 3, TIER3 4).
_NARROW = {0: "gram_matmat", 1: "gram_matmat_comp", 2: "gram_matmat_f64",
           3: "gram_matmat_tier", 4: "gram_matmat_tier"}
_TRIANGLE = {0: "gram_matvec_symmetric", 2: "gram_matvec_symmetric_f64",
             3: "gram_matvec_symmetric_tier", 4: "gram_matvec_symmetric_tier"}
_PAIR = {0: "gram_pair", 3: "gram_pair_tier", 4: "gram_pair_tier"}
_LAPLACE = {"gram_matmat": "laplace_matmat", "gram_matmat_comp": "laplace_matmat_comp",
            "gram_matvec_symmetric": "laplace_matvec_symmetric", "gram_pair": "laplace_pair"}
LAPLACE_CODE = 4


def _kernel_group(name: str) -> str:
    if "sum_splits" in name:
        return "sum_splits"
    if "csr_spmm" in name:
        return "csr_spmm"
    m = re.search(r"(gram_\w+)<([^>]*)>", name)
    if m is None:
        return "other"
    fn, args = m.group(1), [a.strip() for a in m.group(2).split(",")]
    if fn == "gram_tier_symmetric":  # K2b: <KIND, PASSES, KC>
        return "gram_matvec_symmetric_tier"
    # gram_matvec_symmetric<KIND, KC, MODE, PAIR>; the others end in MODE
    triangle = fn == "gram_matvec_symmetric"
    try:
        family, mode = int(args[0]), int(args[2] if triangle else args[-1])
    except (ValueError, IndexError):
        return "other"
    if fn == "gram_matmat_wide":
        group = "gram_matmat"
    elif fn == "gram_matmat_tier_wide":
        group = "gram_matmat_tier"
    elif triangle:
        pair = args[3] in ("true", "1", "(bool)1")
        group = (_PAIR if pair else _TRIANGLE).get(mode, "other")
    else:
        group = _NARROW.get(mode, "other")
    return _LAPLACE.get(group, group) if family == LAPLACE_CODE else group


def device_breakdown(prof) -> dict:
    """Card busy time (ms) and each Gram kernel's time and launches, from the
    device events of a ``torch.profiler`` run. Empty if no device event was
    recorded."""
    from torch.autograd import DeviceType

    groups = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        g = groups.setdefault(_kernel_group(e.name), [0.0, 0])
        g[0] += e.time_range.elapsed_us() / 1e3
        g[1] += 1
    busy = sum(g[0] for g in groups.values())
    if busy == 0:
        return {"device": "not measured: the profiler recorded no device event"}
    return {
        "busy_ms": busy,
        "kernels": {key: {"ms": g[0], "events": g[1]} for key, g in sorted(groups.items())},
    }


@contextlib.contextmanager
def one_pass():
    """K1 and K3 walk all of m in one pass (no column splits) inside."""
    from rlaopt_tpu_torch.ops import kernel_cuda

    real = kernel_cuda.column_splits
    kernel_cuda.column_splits = lambda *a: 1
    try:
        yield
    finally:
        kernel_cuda.column_splits = real


def cuda_ms(fn, reps=5, warm=True, inner=1):
    """Median of ``reps`` CUDA-event timings of ``fn``, after one warm-up
    run unless ``warm`` is False (plain versions that take seconds). With
    ``inner`` > 1 each timing spans that many calls back to back and is
    divided by it: for calls of a fraction of a millisecond, whose launch
    alone would otherwise leave the card idle inside the timing."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def int_keys(log):
    return sorted(i for i in log if isinstance(i, int))


def north_star(dev, profile_run, compare, timings):
    """Config 6 through the entry points a user calls; returns its record.

    Everything from the data to the delivered W64 runs inside the counted
    window (the caller reads the launch counts just after); the checks
    after it launch outside it: a full float64 sweep through K7, an
    independent sampled float64 residual through the plain version, and
    every kernel of the path held against its plain version at the path's
    shapes (n = m = 1,000,000; ``compare`` records each), and K2b timed at
    k = 1 and 10 beside the exact K2 on the same points (``timings``).
    """
    import torch

    from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
    from rlaopt_tpu_torch.ops.kernel_tiers import TierOperand, tier_operand
    from rlaopt_tpu_torch.preconditioners import NystromConfig
    from rlaopt_tpu_torch.solvers import PCGConfig

    t0 = time.perf_counter()
    Xn, yn = synthetic_higgs(N6)
    X = torch.from_numpy(Xn).to(dev)
    y = torch.from_numpy(yn).to(dev)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    reg = 1e-4 * N6
    ls = D**0.5
    kernel_cuda.reset_launch_counts()
    with profile_run() as prof:
        t0 = time.perf_counter()
        K = RBFLinOp(X, X, KernelConfig(lengthscale=ls), compute_dtype="bf16x3")
        sys_ = LinSys(K, y, reg=reg)
        cfg = PCGConfig(max_iters=ITERS6, rtol=1e-6,
                        precond_config=NystromConfig(rank=RANK, rho=reg))
        W64, log = sys_.solve(
            cfg, torch.zeros((N6, 1), device=dev), callback_freq=FREQ6, key=0,
            f64_refine_rounds=2, f64_refine_device="accel",
            f64_refine_residual="update", f64_refine_certify="sampled",
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    used = kernel_cuda.launch_counts()
    ref = log["f64_refine"]
    its = int_keys(log)
    iters = its[-1]
    base_rel = float(log[iters]["metrics"]["internal_metrics"]["rel_res"][0])
    for i in its:
        m = log[i]["metrics"]["internal_metrics"]
        print(f"config6 iter {i}: rel_res {m['rel_res'].tolist()} "
              f"source {m.get('source')} stalled {m.get('stalled', False)}")
    claim = ref["rel_res_f64"][-1][0]
    print(f"config6: wall {wall:.3f} s phase_walls {sys_.phase_walls} "
          f"base iters {iters} base s/iter {sys_.phase_walls['train'] / iters:.4f} "
          f"stalled {sys_.stalled}")
    print("config6 refine " + json.dumps(ref))
    print(f"config6 launches {used}")
    check(W64.dtype == torch.float64 and W64.device == X.device and W64.shape == (N6, 1),
          "config 6 delivers float64 W on the card")
    check(bool(torch.all(torch.isfinite(W64))), "config 6 W is finite")
    for kname in ("gram_matmat_tier", "gram_matvec_symmetric_tier",
                  "gram_matvec_symmetric_f64", "gram_matmat_f64"):
        check(used[kname] > 0, f"config 6 launched {kname}")
    cert = ref.get("sampled_certificate")
    if cert is None or cert.get("refreshed"):
        print("config6: the sampled certificate was not accepted; the claim "
              f"rests on a full evaluation: {ref['residual_sources']}")
    check(claim <= 1e-6, f"config 6 certified rel_res_f64 {claim:.3e} <= 1e-6")

    # post-hoc full float64 sweep of the delivered W64 through K7
    t0 = time.perf_counter()
    y64 = y.double()[:, None]
    KW = kernel_cuda.gram_matvec_symmetric_f64("rbf", X, W64, ls)
    full = (torch.linalg.norm(y64 - (KW + reg * W64)) / torch.linalg.norm(y64)).item()
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    check(full <= 1e-6, f"config 6 full float64 sweep {full:.3e} <= 1e-6")

    # independent sampled float64 residual: other rows (seed 7, as
    # benchmarks/run.py), the plain float64 version on the card
    s = min(4096, N6)
    idx = torch.as_tensor(np.sort(np.random.default_rng(7).choice(N6, s, replace=False)),
                          device=dev)
    t0 = time.perf_counter()
    Kr = kernel_plain.gram_matmat_f64("rbf", X[idx], X, W64, ls)
    r = y64[idx] - (Kr + reg * W64[idx])
    indep = ((torch.linalg.norm(r) / s**0.5) / (torch.linalg.norm(y64) / N6**0.5)).item()
    torch.cuda.synchronize()
    indep_s = time.perf_counter() - t0
    sigma_indep = indep / (2.0 * s) ** 0.5
    sigma_claim = claim * (cert["rel_stderr"] if cert and not cert.get("refreshed") else 0.0)
    gap = abs(indep - claim)
    sigma = (sigma_indep**2 + sigma_claim**2) ** 0.5
    print(f"config6 checks: claim {claim:.6e} full float64 sweep {full:.6e} "
          f"({full_s:.3f} s) independent sampled {indep:.6e} ± {sigma_indep:.2e} "
          f"({indep_s:.3f} s); gap {gap:.3e} = {gap / sigma:.2f} sigma")
    check(gap <= 5 * sigma, "config 6 independent sampled residual within 5 sigma")

    # The path's kernels against their plain versions at its shapes, on
    # the same s rows (a full plain product at n = 1M takes hours): K7's
    # sweep and K8 against the plain float64 rows above; K1b at the
    # sketch's k = 500 and K2b at the matvec's k = 1 (and k = 10) on the
    # bf16x3 parts of all 1M points; K1c at k = 1.
    t0 = time.perf_counter()
    shape = f"config 6 rows {s} of n=m={N6} d={D}"
    compare("gram_matvec_symmetric_f64", KW[idx], Kr, f"{shape} k=1", COMP_BOUND)
    compare("gram_matmat_f64", kernel_cuda.gram_matmat_f64("rbf", X[idx], X, W64, ls),
            Kr, f"{shape} k=1", COMP_BOUND)
    del KW, Kr
    P = tier_operand(X / ls, "bf16x3")
    Pr = TierOperand(P.hi[idx], P.lo[idx], P.sq[idx])
    gen = torch.Generator(device=dev).manual_seed(3)
    for k in (RANK, 1, 10):
        V = torch.randn((N6, k), generator=gen, device=dev)
        ref64 = kernel_plain.gram_matmat_f64("rbf", X[idx], X, V, ls, row_block=256)
        tier_ref = kernel_plain.gram_matmat_tier("rbf", Pr, P, V, row_block=256)
        if k == RANK:
            got = kernel_cuda.gram_matmat_tier("rbf", Pr, P, V)
            kname = "gram_matmat_tier"
        else:
            got = kernel_cuda.gram_matvec_symmetric_tier("rbf", P, V)[idx]
            kname = "gram_matvec_symmetric_tier"
        compare(kname, got, tier_ref, f"bf16x3 {shape} k={k} vs its tier", TIER_BOUND)
        compare(kname, got, ref64, f"bf16x3 {shape} k={k} vs float64", BF16X3_F64_BOUND)
        if k == 1:
            hi, lo = kernel_cuda.gram_matmat_comp("rbf", X[idx], X, V, ls)
            compare("gram_matmat_comp", hi.double() + lo.double(), ref64,
                    f"{shape} k=1 (hi+lo)", COMP_BOUND)
        del got, tier_ref, ref64
        if k != RANK:
            # K2b beside the exact K2 on the same 1M points (3 runs each; the
            # plain versions take minutes here and are not run)
            what = f"n={N6} d={D} k={k}"
            ms = cuda_ms(lambda: kernel_cuda.gram_matvec_symmetric_tier("rbf", P, V), reps=3)
            k2_ms = cuda_ms(lambda: kernel_cuda.gram_matvec_symmetric("rbf", X, V, ls), reps=3,
                            warm=False)
            timings["gram_matvec_symmetric_tier"].append(
                timing_entry("gram_matvec_symmetric_tier", what + " bf16x3", ms, None, N6, N6,
                             D, k, "rbf", "bf16x3", k2_ms=k2_ms))
            timings["gram_matvec_symmetric"].append(
                timing_entry("gram_matvec_symmetric", what, k2_ms, None, N6, N6, D, k))
            print(f"time gram_matvec_symmetric_tier {what} bf16x3: kernel {ms:.3f} ms, "
                  f"K2 {k2_ms:.3f} ms, bound "
                  f"{timings['gram_matvec_symmetric_tier'][-1]['bound_ms']:.3f} ms")
        del V
    print(f"config6 kernel checks at the path's shapes: {time.perf_counter() - t0:.3f} s")
    return {
        "n": N6, "wall_s": wall, "data_s": data_s, "phase_walls": sys_.phase_walls,
        "base_iters": iters, "base_s_per_iter": sys_.phase_walls["train"] / iters,
        "base_rel_res": base_rel, "refine_phase_walls": ref["phase_walls"],
        "residual_sources": ref["residual_sources"], "rel_res_f64": ref["rel_res_f64"],
        "sampled_certificate": cert, "full_sweep_rel": full, "full_sweep_s": full_s,
        "independent_rel": indep, "independent_stderr": sigma_indep,
        "launches": used, "profile": device_breakdown(prof) if prof else None,
    }


def sampled_rows(n: int, s: int, seed: int) -> np.ndarray:
    return np.sort(np.random.default_rng(seed).choice(n, s, replace=False))


def timing_entry(kernel, shape, ms, plain_ms, n, m, d, k, kind="rbf", cd=None, nnz=None,
                 **extra):
    """One timed shape of a kernel, with its bound at that shape."""
    bound, by = bound_ms(kernel, n, m, d, k, kind, cd, nnz)
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "n": n, "m": m, "d": d, "k": k, "kind": kind, **extra}


def laplace_kernels(dev, X, compare, timings):
    """K3, K3c and K5 against the float64 plain version at the HIGGS shape
    (lengthscale 32, on 4,096 rows of each full product) and at the ragged
    shape, then each kernel and its plain version timed at the HIGGS shape.
    The plain versions sum distances directly, seconds a call here: one
    timed run each, without a warm-up."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain

    n = X.shape[0]
    idx = torch.as_tensor(sampled_rows(n, 4096, 5), device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    Vs = {k: torch.randn((n, k), generator=gen, device=dev) for k in (1, 10, RANK)}
    cols = {1: slice(0, 1), 10: slice(1, 11), RANK: slice(11, 11 + RANK)}
    t0 = time.perf_counter()
    ref = kernel_plain.gram_matmat_f64(
        "laplace", X[idx], X, torch.cat([Vs[1], Vs[10], Vs[RANK]], 1), LS_B, row_block=512
    )
    torch.cuda.synchronize()
    print(f"laplace float64 reference, 4096 rows: {time.perf_counter() - t0:.3f} s")
    shape = f"rows 4096 of n=m={n} d={D}"
    for k in (1, 10, RANK):
        compare("laplace_matmat", kernel_cuda.laplace_matmat(X, X, Vs[k], LS_B)[idx],
                ref[:, cols[k]], f"{shape} k={k}", K_BOUND)
    for k in (1, 10):
        compare("laplace_matvec_symmetric",
                kernel_cuda.laplace_matvec_symmetric(X, Vs[k], LS_B)[idx],
                ref[:, cols[k]], f"{shape} k={k}", K_BOUND)
    hi, lo = kernel_cuda.laplace_matmat_comp(X, X, Vs[1], LS_B)
    compare("laplace_matmat_comp", (hi.double() + lo.double())[idx], ref[:, cols[1]],
            f"{shape} k=1 (hi+lo)", COMP_BOUND)
    del ref, hi, lo
    A1, A2, W7, S7 = (torch.from_numpy(a).to(dev) for a in ragged_data())
    ref = kernel_plain.gram_matmat_f64("laplace", A1, A2, W7, 1.3, 0.9)
    rel = compare("laplace_matmat", kernel_cuda.laplace_matmat(A1, A2, W7, 1.3, 0.9), ref,
                  "n=1000 m=777 d=3 k=7", K_BOUND)
    hi, lo = kernel_cuda.laplace_matmat_comp(A1, A2, W7, 1.3, 0.9)
    rel_c = compare("laplace_matmat_comp", hi.double() + lo.double(), ref,
                    "n=1000 m=777 d=3 k=7 (hi+lo)", COMP_BOUND)
    check(rel_c <= rel, "laplace_matmat_comp ragged no worse than laplace_matmat")
    compare("laplace_matvec_symmetric", kernel_cuda.laplace_matvec_symmetric(A1, S7, 1.3, 0.9),
            kernel_plain.gram_matmat_f64("laplace", A1, A1, S7, 1.3, 0.9), "n=1000 d=3 k=7",
            K_BOUND)

    # K5's plain version is K3's on (X, X), the same call: timed once per k
    plain_ms = {}
    for kernel, k in (("laplace_matmat", RANK), ("laplace_matmat", 1), ("laplace_matmat", 10),
                      ("laplace_matvec_symmetric", 1), ("laplace_matvec_symmetric", 10),
                      ("laplace_matmat_comp", 1)):
        V = Vs[k]
        if kernel == "laplace_matmat_comp":
            ms = cuda_ms(lambda: kernel_cuda.laplace_matmat_comp(X, X, V, LS_B))
            p_ms = cuda_ms(lambda: kernel_plain.gram_matmat_comp(
                "laplace", X, X, V, LS_B, col_block=BLOCK), reps=1, warm=False)
        else:
            if kernel == "laplace_matmat":
                ms = cuda_ms(lambda: kernel_cuda.laplace_matmat(X, X, V, LS_B))
            else:
                ms = cuda_ms(lambda: kernel_cuda.laplace_matvec_symmetric(X, V, LS_B))
            if k not in plain_ms:
                plain_ms[k] = cuda_ms(lambda: kernel_plain.gram_matmat(
                    "laplace", X, X, V, LS_B, row_block=BLOCK), reps=1, warm=False)
            p_ms = plain_ms[k]
        what = f"n={n} d={D} k={k}"
        timings.setdefault(kernel, []).append(
            timing_entry(kernel, what, ms, p_ms, n, n, D, k, "laplace"))
        print(f"time {kernel} {what}: kernel {ms:.3f} ms, plain {p_ms:.3f} ms, "
              f"bound {timings[kernel][-1]['bound_ms']:.3f} ms")


def slice3(dev, X, Xn, y):
    """Path B: Nyström-PCG on the Laplace operator at the HIGGS-100k shape,
    through the entry points a user calls: k = 1, k = 10, then k = 1 with
    two float64 refinement rounds (evaluate/full). Counted as one window;
    then every logged residual against a float64 one of the same iterate
    (one plain float64 sweep over all of them), and the refined claim
    against a full K7 sweep. Returns the launch counts."""
    import torch

    from rlaopt_tpu_torch.kernels import KernelConfig, LaplaceLinOp
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
    from rlaopt_tpu_torch.preconditioners import NystromConfig
    from rlaopt_tpu_torch.solvers import PCGConfig

    n = X.shape[0]
    reg = 1e-4 * n
    Y10 = torch.cat([y[:, None], torch.from_numpy(extra_targets(Xn, 10)).to(dev)], 1)
    cfg = PCGConfig(max_iters=ITERS, rtol=1e-6,
                    precond_config=NystromConfig(rank=RANK, rho=reg))
    kernel_cuda.reset_launch_counts()
    K = LaplaceLinOp(X, X, KernelConfig(lengthscale=LS_B))
    solves = []
    for B in (y, Y10):
        before = kernel_cuda.launch_counts()
        sys_ = LinSys(K, B, reg=reg)
        k = 1 if B.ndim == 1 else B.shape[1]
        iterates = []
        t0 = time.perf_counter()
        _, log = sys_.solve(cfg, torch.zeros((n, k), device=dev), callback_freq=FREQ, key=0,
                            callback_fn=lambda w, _model: iterates.append(w.clone()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = kernel_cuda.launch_counts()
        solves.append((k, iterates, log, sys_, wall, {c: after[c] - before[c] for c in after}))
    before = kernel_cuda.launch_counts()
    sys_r = LinSys(K, y, reg=reg)
    t0 = time.perf_counter()
    W64, log_r = sys_r.solve(cfg, torch.zeros((n, 1), device=dev), callback_freq=FREQ, key=0,
                             f64_refine_rounds=2, f64_refine_device="accel")
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    counts = kernel_cuda.launch_counts()
    used_r = {c: counts[c] - before[c] for c in counts}

    # every logged iterate's float64 residual in one plain sweep
    W64s, B64s, where = [], [], []
    for k, iterates, log, sys_, _, _ in solves:
        for i, Wi in zip(sorted(log), iterates):
            if i > 0:
                where.append((k, i, len(W64s)))
                W64s.append(Wi.double())
                B64s.append(sys_.B.double())
    t0 = time.perf_counter()
    Bst, Wst = torch.cat(B64s, 1), torch.cat(W64s, 1)
    R64 = Bst - (kernel_plain.gram_matmat_f64("laplace", X, X, Wst, LS_B, row_block=BLOCK)
                 + reg * Wst)
    rel64 = (torch.linalg.norm(R64, dim=0) / torch.linalg.norm(Bst, dim=0)).cpu().numpy()
    del R64, Wst
    print(f"slice3 float64 residuals of {len(W64s)} iterates: {time.perf_counter() - t0:.3f} s")
    col = np.cumsum([0] + [w.shape[1] for w in W64s])
    for k, iterates, log, sys_, wall, used in solves:
        iters = max(log)
        hist = {i: log[i]["metrics"]["internal_metrics"]["rel_res"].tolist() for i in sorted(log)}
        s_iter = sys_.phase_walls["train"] / iters
        print(f"slice3 k={k}: phase_walls {sys_.phase_walls} wall {wall:.3f} s "
              f"s/iter {s_iter:.4f} launches {used}")
        first, last = np.array(hist[0]), np.array(hist[iters])
        check(np.all(np.isfinite(last)) and np.all(last < first), f"slice3 k={k} rel_res falls")
        check(used["laplace_matmat"] > 0, f"slice3 k={k} sketch ran through laplace_matmat")
        check(used["laplace_matmat_comp"] >= len(log),
              f"slice3 k={k} every boundary ran through laplace_matmat_comp")
        check(used["laplace_matvec_symmetric"] >= iters,
              f"slice3 k={k} every PCG step ran through laplace_matvec_symmetric")
        gaps = {}
        for kk, i, j in where:
            if kk == k:
                r64 = rel64[col[j]:col[j + 1]]
                gaps[i] = (np.abs(np.array(hist[i]) - r64) / r64).tolist()
                print(f"slice3 k={k} iter {i}: rel_res {hist[i]} float64 {r64.tolist()} "
                      f"gaps {gaps[i]}")
                check(max(gaps[i]) <= 0.01, f"slice3 k={k} rel_res at {i} within 1% of float64")
        print("slice3 " + json.dumps({"k": k, "iters": iters, "s_per_iter": s_iter, "wall_s": wall,
                                      "phase_walls": sys_.phase_walls, "rel_res": hist,
                                      "gaps": gaps, "launches": used}))
    ref_r = log_r["f64_refine"]
    iters_r = int_keys(log_r)[-1]
    base_r = float(log_r[iters_r]["metrics"]["internal_metrics"]["rel_res"][0])
    final_r = ref_r["rel_res_f64"][-1][0]
    t0 = time.perf_counter()
    y64 = y.double()[:, None]
    KW = kernel_cuda.gram_matvec_symmetric_f64("laplace", X, W64, LS_B)
    k7 = (torch.linalg.norm(y64 - (KW + reg * W64)) / torch.linalg.norm(y64)).item()
    k7_s = time.perf_counter() - t0
    print("slice3 refined " + json.dumps({
        "wall_s": wall_r, "phase_walls": sys_r.phase_walls, "base_rel_res": base_r,
        "refine": ref_r, "k7_sweep_rel": k7, "k7_sweep_s": k7_s, "launches": used_r}))
    check(W64.dtype == torch.float64 and W64.is_cuda, "slice3 refined W is float64 on the card")
    check(np.isfinite(final_r) and final_r < base_r,
          f"slice3 refined rel_res_f64 {final_r:.3e} below the base {base_r:.3e}")
    check(abs(final_r - k7) <= 0.01 * k7, "slice3 refined rel_res_f64 within 1% of a K7 sweep")
    check(used_r["gram_matvec_symmetric_f64"] > 0, "slice3 refinement ran through K7")
    return counts


def config4(dev, X, y, profile_run, compare, timings, laplace):
    """Path A (``laplace``: ASkotch on the Laplace operator) or A' (config 4
    as written: bf16x3 RBF), ITERS4 iterations each, through the
    entry points a user calls, counted and profiled; then the sampled
    estimates against an independent float64 residual on other rows, and
    the block-oracle shape's kernels checked on those rows and timed.
    Returns the path's record (launch counts under ``"launches"``)."""
    import torch

    from rlaopt_tpu_torch.kernels import KernelConfig, LaplaceLinOp, RBFLinOp
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
    from rlaopt_tpu_torch.preconditioners import NystromConfig
    from rlaopt_tpu_torch.solvers import SAPAccelConfig, SAPConfig

    name = "config4_laplace" if laplace else "config4"
    kind, ls = ("laplace", LS_A) if laplace else ("rbf", 1.0)
    iters = ITERS4
    iterates = []
    kernel_cuda.reset_launch_counts()
    with profile_run() as prof:
        t0 = time.perf_counter()
        if laplace:
            K = LaplaceLinOp(X, X, KernelConfig(lengthscale=LS_A))
        else:
            K = RBFLinOp(X, X, KernelConfig(lengthscale=1.0), compute_dtype="bf16x3")
        sys_ = LinSys(K, y, reg=REG4, A_row_oracle=K.row_oracle, A_blk_oracle=K.blk_oracle)
        cfg = SAPConfig(
            max_iters=iters, rtol=1e-6, blk_sz=BLK4,
            precond_config=NystromConfig(rank=RANK4, rho=REG4), accel=True,
            accel_config=SAPAccelConfig(mu=REG4, nu=100.0), power_iters=10,
        )
        _, log = sys_.solve(cfg, torch.zeros((N4, 1), device=dev), callback_freq=FREQ4, key=0,
                            metrics="sampled",
                            callback_fn=lambda w, _model: iterates.append(w.clone()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    used = kernel_cuda.launch_counts()
    keys = int_keys(log)
    hist = {i: log[i]["metrics"]["internal_metrics"] for i in keys}
    for i in keys:
        print(f"{name} iter {i}: rel_res {hist[i]['rel_res'].tolist()} "
              f"source {hist[i].get('source')}")
    check(keys[-1] == iters, f"{name} ran {iters} iterations")
    final = float(hist[iters]["rel_res"][0])
    check(hist[iters].get("source") is None and np.isfinite(final) and final < 1.0,
          f"{name} final true rel_res {final:.4e} finite and below 1")
    if laplace:
        check(used["laplace_matmat"] >= iters, f"{name}: every iteration ran through K3")
        check(used["laplace_matmat_comp"] >= 1, f"{name}: the final residual ran through K3c")
    else:
        check(used["gram_matmat_tier"] >= iters, f"{name}: every iteration ran through K1b")
        check(used["gram_matmat_comp"] >= 1, f"{name}: the final residual ran through K1c")

    # independent float64 residuals on other rows (seed 7) of every logged
    # iterate past 0, by the plain version, in one sweep with a random
    # column for the kernel checks below (an iterate's product cancels:
    # its error against max|ref| says little of the kernel's)
    s = min(4096, BLK4 // 2)
    idx = torch.as_tensor(sampled_rows(N4, s, 7), device=dev)
    y64 = y.double()[:, None]
    Vr = torch.randn((N4, 1), generator=torch.Generator(device=dev).manual_seed(12), device=dev)
    t0 = time.perf_counter()
    W64 = torch.cat([w.double() for w in iterates[1:]], 1)
    KW = kernel_plain.gram_matmat_f64(kind, X[idx], X, torch.cat([W64, Vr.double()], 1), ls,
                                      row_block=256)
    R = y64[idx] - (KW[:, :-1] + REG4 * W64[idx])
    indep = (torch.linalg.norm(R, dim=0) * (N4 / s) ** 0.5 / torch.linalg.norm(y64)).cpu().numpy()
    indep_s = time.perf_counter() - t0
    checks = {}
    for j, i in enumerate(keys[1:]):
        est = float(hist[i]["rel_res"][0])
        sigma_i = indep[j] / (2.0 * s) ** 0.5
        sigma_e = est * hist[i].get("rel_stderr_est", 0.0)
        sigma = (sigma_i**2 + sigma_e**2) ** 0.5
        checks[i] = {"logged": est, "source": hist[i].get("source"), "independent": float(indep[j]),
                     "sigmas": abs(est - indep[j]) / sigma}
        print(f"{name} iter {i}: logged {est:.6e} ({hist[i].get('source') or 'true'}) "
              f"independent float64 {indep[j]:.6e} ± {sigma_i:.2e}: "
              f"{checks[i]['sigmas']:.2f} sigma")
        check(abs(est - indep[j]) <= 5 * sigma, f"{name} iter {i} within 5 sigma of float64")

    # the block-oracle shape: a block of BLK4 rows holding the s rows above,
    # checked on those rows against the float64 ones
    rest = np.setdiff1d(np.arange(N4), idx.cpu().numpy())
    more = np.random.default_rng(11).choice(rest, BLK4 - s, replace=False)
    blk = torch.cat([idx, torch.as_tensor(more, device=dev)])
    Wf = Vr
    ref = KW[:, -1:]
    shape = f"rows {s} of the row oracle n={BLK4} m={N4} d={D4} k=1"
    Xb = X[blk]
    record = {}
    if laplace:
        splits = kernel_cuda.column_splits(BLK4, N4, 1, dev)
        compare("laplace_matmat", kernel_cuda.laplace_matmat(Xb, X, Wf, ls)[:s], ref,
                f"{shape} splits {splits}", K_BOUND)
        hi, lo = kernel_cuda.laplace_matmat_comp(X[idx], X, Wf, ls)
        compare("laplace_matmat_comp", hi.double() + lo.double(), ref, f"{shape} (hi+lo)",
                COMP_BOUND)
        ms = cuda_ms(lambda: kernel_cuda.laplace_matmat(Xb, X, Wf, ls))
        with one_pass():
            compare("laplace_matmat", kernel_cuda.laplace_matmat(Xb, X, Wf, ls)[:s], ref,
                    f"{shape} one pass", K_BOUND)
            ms1 = cuda_ms(lambda: kernel_cuda.laplace_matmat(Xb, X, Wf, ls))
        p_ms = cuda_ms(lambda: kernel_plain.gram_matmat("laplace", Xb, X, Wf, ls, row_block=64),
                       reps=1, warm=False)
        what = f"row oracle n={BLK4} m={N4} d={D4} k=1"
        timings.setdefault("laplace_matmat", []).insert(0, timing_entry(
            "laplace_matmat", f"{what} splits {splits}", ms, p_ms, BLK4, N4, D4, 1, "laplace",
            splits=splits, one_pass_ms=ms1))
        print(f"time laplace_matmat {what}: splits {splits} {ms:.3f} ms, one pass {ms1:.3f} ms, "
              f"plain {p_ms:.3f} ms, bound {timings['laplace_matmat'][0]['bound_ms']:.3f} ms")
        record["row_oracle_ms"] = {"splits": splits, "ms": ms, "one_pass_ms": ms1, "plain_ms": p_ms}
        # the dense block of SAP's block preconditioner (blk_dense)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        Kb = K.blk_dense(blk)
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        record["blk_dense"] = {"s": dense_s, "peak_bytes": peak,
                               "tile_bytes": Kb.numel() * Kb.element_size()}
        print(f"{name} blk_dense at blk {BLK4}: {dense_s:.3f} s, peak {peak} bytes above the "
              f"operands, the tile itself {Kb.numel() * Kb.element_size()} bytes")
        del Kb
    else:
        P = K._tier[0]
        Pb = P.rows(blk)
        got = kernel_cuda.gram_matmat_tier("rbf", Pb, P, Wf)[:s]
        compare("gram_matmat_tier", got, kernel_plain.gram_matmat_tier(
            "rbf", P.rows(idx), P, Wf, row_block=256), f"bf16x3 {shape} vs its tier", TIER_BOUND)
        compare("gram_matmat_tier", got, ref, f"bf16x3 {shape} vs float64", BF16X3_F64_BOUND)
        hi, lo = kernel_cuda.gram_matmat_comp("rbf", X[idx], X, Wf, ls)
        compare("gram_matmat_comp", hi.double() + lo.double(), ref, f"{shape} (hi+lo)",
                COMP_BOUND)
        ms = cuda_ms(lambda: kernel_cuda.gram_matmat_tier("rbf", Pb, P, Wf))
        p_ms = cuda_ms(lambda: kernel_plain.gram_matmat_tier("rbf", Pb, P, Wf, row_block=256),
                       reps=1)
        what = f"row oracle n={BLK4} m={N4} d={D4} k=1 bf16x3"
        timings.setdefault("gram_matmat_tier", []).append(timing_entry(
            "gram_matmat_tier", what, ms, p_ms, BLK4, N4, D4, 1, "rbf", "bf16x3"))
        print(f"time gram_matmat_tier {what}: kernel {ms:.3f} ms, plain {p_ms:.3f} ms, "
              f"bound {timings['gram_matmat_tier'][-1]['bound_ms']:.3f} ms")
        record["row_oracle_ms"] = {"ms": ms, "plain_ms": p_ms}
    profile = device_breakdown(prof) if prof else {}
    busy = profile.get("busy_ms")
    record.update({
        "n": N4, "d": D4, "kind": kind, "lengthscale": ls, "iters": iters, "wall_s": wall,
        "phase_walls": sys_.phase_walls, "s_per_iter": sys_.phase_walls["train"] / iters,
        "rel_res": {i: hist[i]["rel_res"].tolist() for i in keys},
        "sources": {i: hist[i].get("source") for i in keys}, "checks": checks,
        "independent_s": indep_s, "launches": used, "profile": profile,
        "busy_share": None if busy is None else busy / 1e3 / wall,
    })
    print(name + " " + json.dumps(record))
    return record


def sparse_operand():
    """Path S's data, made with numpy: bench.py::make_sparse_tallskinny's
    buffers (standard-normal float32 values, uniform column indices, a row
    may repeat a column, indptr 16·arange) with each column j scaled by
    logspace(0, -4, 1024)[j]; then b and the ten columns of B10 from the
    same generator."""
    rng = np.random.default_rng(5)
    nnz = S_WIDTH * S_ROWS
    values = rng.standard_normal(nnz).astype(np.float32)
    indices = rng.integers(0, S_COLS, nnz).astype(np.int32)
    indptr = S_WIDTH * np.arange(S_ROWS + 1, dtype=np.int64)
    values *= np.logspace(0, -4, S_COLS, dtype=np.float32)[indices]
    b = rng.standard_normal(S_ROWS).astype(np.float32)
    B10 = rng.standard_normal((S_ROWS, 10)).astype(np.float32)
    return values, indices, indptr, b, B10


def ragged_csr(seed=21, n_rows=3000, n_cols=700):
    """The ragged CSR of the card tests: rows of 0 to 40 entries, every
    seventh empty, every 500th of 300 to 1,200 (longer than a block), each
    row's first column repeated; float64 values."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 41, n_rows)
    lengths[::7] = 0
    lengths[3::500] = rng.integers(300, 1201, len(lengths[3::500]))
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    indices = rng.integers(0, n_cols, indptr[-1]).astype(np.int32)
    starts = indptr[:-1][lengths >= 2]
    indices[starts + 1] = indices[starts]
    return rng.standard_normal(indptr[-1]), indices, indptr, n_cols


def ragged_rows_csr(seed=23, n_cols=5000):
    """The ragged CSR of the short-row schedule's contract: rows of 0, 1, 15,
    16, 17, 33, 300 and 20,000 entries, 40 of each in a shuffled order, each
    row's first column repeated; float64 values."""
    rng = np.random.default_rng(seed)
    lengths = np.tile(np.array([0, 1, 15, 16, 17, 33, 300, 20000]), 40)
    rng.shuffle(lengths)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    indices = rng.integers(0, n_cols, indptr[-1]).astype(np.int32)
    starts = indptr[:-1][lengths >= 2]
    indices[starts + 1] = indices[starts]
    return rng.standard_normal(indptr[-1]), indices, indptr, n_cols


def library_csr(values, indptr, indices, n_rows, n_cols):
    """The yardstick: torch's CSR tensor on the card, whose product with a
    dense operand is cuSPARSE's. Timed beside #9 here; the port never calls
    it."""
    import torch

    return torch.sparse_csr_tensor(indptr.int(), indices, values, (n_rows, n_cols))


# The schedules of #9 at k <= 16 (kernel_cuda.spmm_lanes): lanes a row, or
# a block of 256 threads a row.
CSR_SCHEDULES = (2, 4, 8, 16, 32, 256)
# Calls of #9 and of cuSPARSE per timing (cuda_ms's inner): path S's SpMV
# takes ~0.1 ms, about what one call's host side takes.
CSR_INNER = 20


@contextlib.contextmanager
def csr_lanes(lanes):
    """#9 takes ``lanes`` threads a row inside (k <= 16)."""
    from rlaopt_tpu_torch.ops import kernel_cuda

    real = kernel_cuda.spmm_lanes
    kernel_cuda.spmm_lanes = lambda *a: lanes
    try:
        yield
    finally:
        kernel_cuda.spmm_lanes = real


def sparse_kernels(dev, A, compare, timings):
    """#9 against the float64 plain version on path S's operand A (its CSR
    and the cached CSR of Aᵀ), on random right-hand sides: the forward and
    adjoint SpMV, the SpMM at k = 10 both ways, the adjoint SpMM at the
    sketch's k = 4,096 (checked on 256 columns); the ragged CSR of the card
    tests and the ragged-rows CSR (rows of 0 to 20,000 entries) in every
    schedule of k <= 16, float32 and float64; two launches give the same
    bits in both types. Each path shape and each ragged operand (at the
    schedule the wrapper picks) timed (median of 5, each over CSR_INNER
    calls for the kernel and cuSPARSE): kernel, plain version (float32) and
    cuSPARSE; the forward SpMV also at every lanes value."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda
    from rlaopt_tpu_torch.sparse import ops as sops

    fwd = A._csr_buffers()
    adj = A.T._csr_buffers()
    gen = torch.Generator(device=dev).manual_seed(31)

    def same_bits(fn, args, what):
        got = fn(*args)
        again = fn(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{what}: two launches give the same bits")
        return got

    def case(kernel, bufs, n_rows, n_cols, X, what, cols=None, lanes=()):
        values, indices, indptr = bufs
        fn = getattr(kernel_cuda, kernel)
        v64 = values.double()
        Xc = X if cols is None else X[:, :cols].contiguous()
        ref = sops._plain(v64, indptr, indices, Xc.double(), n_rows, False)
        got = same_bits(fn, (values, indptr, indices, X, n_rows), f"{kernel} {what} float32")
        compare(kernel, got if cols is None else got[:, :cols], ref, f"{what} float32",
                CSR_F32_BOUND)
        got = same_bits(fn, (v64, indptr, indices, Xc.double(), n_rows),
                        f"{kernel} {what} float64")
        compare(kernel, got, ref, f"{what} float64", CSR_F64_BOUND)
        del ref, got
        lib = library_csr(values, indptr, indices, n_rows, n_cols)
        ms = cuda_ms(lambda: fn(values, indptr, indices, X, n_rows), inner=CSR_INNER)
        p_ms = cuda_ms(lambda: sops._plain(values, indptr, indices, X, n_rows, False))
        l_ms = cuda_ms(lambda: lib @ X, inner=CSR_INNER)
        entry = timing_entry(kernel, what, ms, p_ms, n_rows, n_cols, 0, X.shape[1],
                             cd="float32", nnz=values.numel(), library_ms=l_ms,
                             lanes=kernel_cuda.spmm_lanes(n_rows, values.numel(), X.shape[1]))
        for L in lanes:
            with csr_lanes(L):
                entry.setdefault("ms_by_lanes", {})[L] = cuda_ms(
                    lambda: fn(values, indptr, indices, X, n_rows), inner=CSR_INNER)
        timings.setdefault(kernel, []).append(entry)
        print(f"time {kernel} {what}: kernel {ms:.4f} ms (lanes {entry['lanes']}), plain "
              f"{p_ms:.3f} ms, cuSPARSE {l_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']})" + (f", by lanes {entry['ms_by_lanes']}" if lanes else ""))

    shape = f"n={S_ROWS} m={S_COLS} nnz={A.nnz}"
    t0 = time.perf_counter()
    # csr_spmm's first entry (its JSON line) is the sketch's
    X = torch.randn((S_ROWS, S_SKETCH), generator=gen, device=dev)
    case("csr_spmm", adj, S_COLS, S_ROWS, X, f"adjoint {shape} k={S_SKETCH} (the sketch)",
         cols=256)
    del X
    torch.cuda.empty_cache()
    case("csr_spmv", fwd, S_ROWS, S_COLS, torch.randn((S_COLS, 1), generator=gen, device=dev),
         f"forward {shape} k=1", lanes=CSR_SCHEDULES[:-1])
    case("csr_spmv", adj, S_COLS, S_ROWS, torch.randn((S_ROWS, 1), generator=gen, device=dev),
         f"adjoint {shape} k=1")
    case("csr_spmm", fwd, S_ROWS, S_COLS, torch.randn((S_COLS, 10), generator=gen, device=dev),
         f"forward {shape} k=10", lanes=CSR_SCHEDULES[:-1])
    case("csr_spmm", adj, S_COLS, S_ROWS, torch.randn((S_ROWS, 10), generator=gen, device=dev),
         f"adjoint {shape} k=10")

    # the ragged operands: every schedule of k <= 16 checked, the wrapper's
    # own timed; past k = 16 the wide schedule
    for name, operand in (("ragged", ragged_csr()), ("ragged rows", ragged_rows_csr())):
        values, indices, indptr, n_cols = operand
        n_rows = len(indptr) - 1
        v64 = torch.from_numpy(values).to(dev)
        p, c = torch.from_numpy(indptr).to(dev), torch.from_numpy(indices).to(dev)
        empty = torch.from_numpy(np.diff(indptr) == 0).to(dev)
        for k in (1, 3, 10, 300):
            kernel = "csr_spmv" if k == 1 else "csr_spmm"
            fn = getattr(kernel_cuda, kernel)
            X = torch.randn((n_cols, k), generator=gen, device=dev, dtype=torch.float64)
            ref = sops._plain(v64, p, c, X, n_rows, False)
            what = f"{name} n={n_rows} m={n_cols} nnz={v64.numel()} k={k}"
            for lanes in (CSR_SCHEDULES if k <= 16 else (None,)):
                with contextlib.nullcontext() if lanes is None else csr_lanes(lanes):
                    sched = what + ("" if lanes is None else f" lanes={lanes}")
                    for dtype, bound in ((torch.float32, CSR_F32_BOUND),
                                         (torch.float64, CSR_F64_BOUND)):
                        tag = f"{sched} {str(dtype)[6:]}"
                        got = same_bits(fn, (v64.to(dtype), p, c, X.to(dtype), n_rows),
                                        f"{kernel} {tag}")
                        compare(kernel, got, ref, tag, bound)
                        check(bool(torch.all(got[empty] == 0)), f"{kernel} {tag}: empty rows 0")
            v32, X32 = v64.float(), X.float()
            lib = library_csr(v32, p, c, n_rows, n_cols)
            entry = timing_entry(
                kernel, what, cuda_ms(lambda: fn(v32, p, c, X32, n_rows), inner=CSR_INNER),
                cuda_ms(lambda: sops._plain(v32, p, c, X32, n_rows, False)), n_rows,
                n_cols, 0, k, cd="float32", nnz=v32.numel(),
                library_ms=cuda_ms(lambda: lib @ X32, inner=CSR_INNER),
                lanes=kernel_cuda.spmm_lanes(n_rows, v32.numel(), k))
            timings[kernel].append(entry)
            print(f"time {kernel} {what}: kernel {entry['ms']:.4f} ms (lanes "
                  f"{entry['lanes']}), plain {entry['plain_ms']:.3f} ms, cuSPARSE "
                  f"{entry['library_ms']:.4f} ms")
    print(f"slice4 kernel checks and times: {time.perf_counter() - t0:.3f} s")


def host_normal_residuals(A64, AT64, B, iterates):
    """scipy's float64 ‖Aᵀ(B − AW)‖ / ‖AᵀB‖ per column of each iterate."""
    B64 = np.asarray(B, np.float64).reshape(B.shape[0], -1)
    atb = np.linalg.norm(AT64 @ B64, axis=0)
    return [np.linalg.norm(AT64 @ (B64 - A64 @ W.double().cpu().numpy()), axis=0) / atb
            for W in iterates]


def residual_checks(name, log, rel64):
    """Each logged rel_res against its float64 value: within RES_REL while
    above RES_ABOVE, within RES_ABS absolute below it. Returns the last
    logged values and the largest gaps (relative above, absolute below)."""
    worst = {"rel_gap_above": 0.0, "abs_gap_below": 0.0}
    for i, r64 in zip(sorted(log), rel64):
        logged = log[i]["metrics"]["internal_metrics"]["rel_res"].cpu().numpy()
        gap = np.abs(logged - r64)
        above = r64 > RES_ABOVE
        print(f"{name} iter {i}: rel_res {logged.tolist()} float64 {r64.tolist()}")
        if above.any():
            worst["rel_gap_above"] = max(worst["rel_gap_above"],
                                         float(np.max(gap[above] / r64[above])))
        if (~above).any():
            worst["abs_gap_below"] = max(worst["abs_gap_below"], float(np.max(gap[~above])))
        check(np.all(gap[above] <= RES_REL * r64[above]),
              f"{name} rel_res at {i} within {RES_REL:.0%} of float64 above {RES_ABOVE:.0e}")
        check(np.all(gap[~above] <= RES_ABS),
              f"{name} rel_res at {i} within {RES_ABS:.0e} of float64 below {RES_ABOVE:.0e}")
    return {"last_logged": logged.tolist(), "last_float64": r64.tolist(), **worst}


def stop_check(name, stopped, logged, float64):
    """Stopped on rtol within the iterations: float32 reaches rtol 1e-6 on
    both paths (its float64 value is held by residual_checks)."""
    print(f"{name}: last rel_res {logged.tolist()}, float64 {float64.tolist()}")
    check(stopped, f"{name} stopped on rtol {S_RTOL:g} within {S_ITERS} iterations")


def lstsq_solve(dev, A, B, cfg, key=0):
    """One LstSq solve through the entry points a user calls, with every
    logged iterate kept; returns (model, log, iterates, wall s)."""
    import torch

    from rlaopt_tpu_torch.models import LstSq

    model = LstSq(A, B)
    iterates = []
    t0 = time.perf_counter()
    _, log = model.solve(cfg, torch.zeros((A.shape[1], 1 if B.ndim == 1 else B.shape[1]),
                                          device=dev),
                         callback_freq=S_FREQ, key=key,
                         callback_fn=lambda w, _model: iterates.append(w.clone()))
    torch.cuda.synchronize()
    return model, log, iterates, time.perf_counter() - t0


def slice4(dev, profiled, compare, timings):
    """Path S, counted: ``LstSq(SparseCSRTensor(A, device), b)`` with LSQR +
    SkPre at k = 1 and k = 10; then each logged rel_res against scipy's
    float64 one, the launches against the path's count, the sketch's peak
    memory, #9 against its plain version, one more k = 1 solve profiled.
    Returns the path's record (launch counts under ``"launches"``)."""
    import scipy.sparse as sps
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda
    from rlaopt_tpu_torch.preconditioners import SkPreConfig
    from rlaopt_tpu_torch.solvers import LSQRConfig
    from rlaopt_tpu_torch.sparse import SparseCSRTensor

    t0 = time.perf_counter()
    values, indices, indptr, b, B10 = sparse_operand()
    data_s = time.perf_counter() - t0
    cfg = LSQRConfig(max_iters=S_ITERS, rtol=S_RTOL, precond_config=SkPreConfig(
        sketch_size=S_SKETCH, rho=0.0, sketch="sparse"))
    solves = []
    kernel_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    A = SparseCSRTensor(values, indices, indptr, (S_ROWS, S_COLS), device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    for B in (b, B10):
        Bt = torch.from_numpy(B).to(dev)
        before = kernel_cuda.launch_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        model, log, iterates, wall = lstsq_solve(dev, A, Bt, cfg)
        peak = torch.cuda.max_memory_allocated(dev) - base
        after = kernel_cuda.launch_counts()
        solves.append((B, model, log, iterates, wall, peak,
                       {c: after[c] - before[c] for c in after}))
    counts = kernel_cuda.launch_counts()

    A64 = sps.csr_matrix((values.astype(np.float64), indices, indptr), shape=(S_ROWS, S_COLS))
    AT64 = A64.T.tocsr()
    record = {"data_s": data_s, "upload_s": upload_s, "solves": []}
    for B, model, log, iterates, wall, peak, used in solves:
        k = 1 if B.ndim == 1 else B.shape[1]
        name = f"slice4 k={k}"
        iters = max(log)
        t0 = time.perf_counter()
        rel64 = host_normal_residuals(A64, AT64, B, iterates)
        host_s = time.perf_counter() - t0
        gaps = residual_checks(name, log, rel64)
        last = np.array(gaps["last_logged"])
        stopped = bool(np.all(last <= S_RTOL)) and iters < S_ITERS
        expect = 1 + 2 * iters + 2 * len(log) + 1  # init, steps, boundaries, Aᵀ @ B
        want = {"csr_spmv": expect if k == 1 else 0,
                "csr_spmm": 1 + (0 if k == 1 else expect)}  # + the sketch
        s_iter = model.phase_walls["train"] / iters
        print(f"{name}: phase_walls {model.phase_walls} wall {wall:.3f} s iters {iters} "
              f"s/iter {s_iter:.5f} stopped on rtol {stopped} launches {used} "
              f"(want {want}) peak {peak} bytes above the operator; host float64 {host_s:.3f} s")
        for kname, n_want in want.items():
            check(used[kname] == n_want, f"{name} launched {kname} {used[kname]} times, "
                  f"the path's count {n_want}")
        stop_check(name, stopped, last, rel64[-1])
        check(peak <= 18e9, f"{name} peak {peak} bytes across the sketch within 18 GB")
        record["solves"].append({
            "k": k, "iters": iters, "stopped_on_rtol": stopped, "wall_s": wall,
            "phase_walls": model.phase_walls, "s_per_iter": s_iter, "peak_bytes": peak,
            "launches": used, "residuals": gaps, "host_float64_s": host_s})

    sparse_kernels(dev, A, compare, timings)
    with profiled() as prof:
        model, log, _, wall = lstsq_solve(dev, A, torch.from_numpy(b).to(dev), cfg)
    profile = {"k": 1, "wall_s": wall, "phase_walls": model.phase_walls, "iters": max(log)}
    profile.update(device_breakdown(prof))
    if "busy_ms" in profile:
        profile["busy_share"] = profile["busy_ms"] / 1e3 / wall
        profile["kernel_shares"] = {g: v["ms"] / profile["busy_ms"]
                                    for g, v in profile["kernels"].items()}
    record["profile"] = profile
    record["launches"] = counts
    print("slice4 " + json.dumps(record))
    return record


def config2(dev, profiled):
    """Path C': config 2 as written (dense 100,000 x 1,000 A, columns scaled
    by logspace(0, -4), SRHT sketch of 4,000 rows through the butterfly
    FWHT, LSQR rtol 1e-6, callback_freq 5), its data from numpy seed 0;
    every logged rel_res against numpy's float64 one; counted (it runs no
    TPU kernel) and profiled."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda
    from rlaopt_tpu_torch.preconditioners import SkPreConfig
    from rlaopt_tpu_torch.solvers import LSQRConfig

    rng = np.random.default_rng(0)
    An = rng.standard_normal((C2_M, C2_N), dtype=np.float32)
    An *= np.logspace(0, -4, C2_N, dtype=np.float32)
    bn = rng.standard_normal(C2_M, dtype=np.float32)
    A, b = torch.from_numpy(An).to(dev), torch.from_numpy(bn).to(dev)
    cfg = LSQRConfig(max_iters=S_ITERS, rtol=S_RTOL, precond_config=SkPreConfig(
        sketch_size=4 * C2_N, rho=0.0, sketch="srht"))
    kernel_cuda.reset_launch_counts()
    with profiled() as prof:
        model, log, iterates, wall = lstsq_solve(dev, A, b, cfg)
    used = kernel_cuda.launch_counts()
    A64 = An.astype(np.float64)
    iters = max(log)
    rel64 = host_normal_residuals(A64, A64.T, bn, iterates)
    gaps = residual_checks("config2", log, rel64)
    last = np.array(gaps["last_logged"])
    stopped = bool(np.all(last <= S_RTOL)) and iters < S_ITERS
    profile = device_breakdown(prof)
    busy = profile.get("busy_ms")
    record = {"m": C2_M, "n": C2_N, "iters": iters, "stopped_on_rtol": stopped, "wall_s": wall,
              "phase_walls": model.phase_walls,
              "s_per_iter": model.phase_walls["train"] / iters, "residuals": gaps,
              "launches": used, "profile": profile,
              "busy_share": None if busy is None else busy / 1e3 / wall}
    print("config2 " + json.dumps(record))
    stop_check("config2", stopped, last, rel64[-1])
    return record


def pair_ragged(dev, compare):
    """K4 (every squared-distance family), K6 and K4b (both tiers) against
    float64 and K4b against its tier's plain version, at the ragged shape
    (X1 1000 x 3, X2 777 x 3) and k = 1, 3, 16."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
    from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand

    A1, A2, _, _ = (torch.from_numpy(a).to(dev) for a in ragged_data())
    for k in (1, 3, 16):
        V2, V1 = (torch.from_numpy(a).to(dev) for a in pair_ragged_rhs(k))
        what = f"n1=1000 n2=777 d=3 k={k}"
        for kind in SQDIST_KINDS + ("laplace",):
            r1, r2 = kernel_plain.gram_pair(kind, A1.double(), A2.double(), V2.double(),
                                            V1.double(), 1.3, 0.9)
            if kind == "laplace":
                kname = "laplace_pair"
                o1, o2 = kernel_cuda.laplace_pair(A1, A2, V2, V1, 1.3, 0.9)
            else:
                kname = "gram_pair"
                o1, o2 = kernel_cuda.gram_pair(kind, A1, A2, V2, V1, 1.3, 0.9)
            compare(kname, o1, r1, f"{kind} {what} out1", K_BOUND)
            compare(kname, o2, r2, f"{kind} {what} out2", K_BOUND)
            if kind == "laplace":
                continue
            for cd in TIERS:
                P1, P2 = tier_operand(A1 / 1.3, cd), tier_operand(A2 / 1.3, cd)
                o1, o2 = kernel_cuda.gram_pair_tier(kind, P1, P2, V2, V1, 0.9)
                t1, t2 = kernel_plain.gram_pair_tier(kind, P1, P2, V2, V1, 0.9)
                mirror = REROUND_BOUND if cd == "bfloat16" and k >= 3 else TIER_BOUND
                compare("gram_pair_tier", o1, t1, f"{cd} {kind} {what} out1 vs its tier",
                        TIER_BOUND)
                compare("gram_pair_tier", o2, t2, f"{cd} {kind} {what} out2 vs its tier",
                        mirror)
                # against float64: 3x the JAX pair kernel's own error on
                # this data (its tier-matched mirror at k >= 3 included)
                for o, r, side in ((o1, r1, "out1"), (o2, r2, "out2")):
                    compare("gram_pair_tier", o, r, f"{cd} {kind} {what} {side} vs float64",
                            3 * JAX_TIER_ERR[("ragged", cd, "pair", kind)])


def pair_at(dev, kname, X1, X2, compare, timings, what, kind="rbf", ls=None, cd=None,
            rows=None):
    """One pair kernel at a path's shard shape (X1, X2: two shards) at
    k = 1, 3, 16 against float64 (and K4b against its tier's plain version),
    all rows or ``rows`` sampled rows of each output; then the kernel and
    its plain version timed at k = 1."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
    from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand

    n1, n2 = X1.shape[0], X2.shape[0]
    gen = torch.Generator(device=dev).manual_seed(22)
    P1 = P2 = None
    if cd is not None:
        P1, P2 = tier_operand(X1 / ls, cd), tier_operand(X2 / ls, cd)

    def kernel(V2, V1):
        if kname == "gram_pair_tier":
            return kernel_cuda.gram_pair_tier(kind, P1, P2, V2, V1)
        if kname == "laplace_pair":
            return kernel_cuda.laplace_pair(X1, X2, V2, V1, ls)
        return kernel_cuda.gram_pair(kind, X1, X2, V2, V1, ls)

    def plain(V2, V1):
        if kname == "gram_pair_tier":
            return kernel_plain.gram_pair_tier(kind, P1, P2, V2, V1, row_block=BLOCK // 4)
        return kernel_plain.gram_pair(kind, X1, X2, V2, V1, ls, row_block=BLOCK)

    t0 = time.perf_counter()
    for k in (1, 3, 16):
        V2 = torch.randn((n2, k), generator=gen, device=dev)
        V1 = torch.randn((n1, k), generator=gen, device=dev)
        o1, o2 = kernel(V2, V1)
        shape = f"{what} n1={n1} n2={n2} d={X1.shape[1]} k={k}"
        if rows is None:
            r1, r2 = kernel_plain.gram_pair(kind, X1.double(), X2.double(), V2.double(),
                                            V1.double(), ls, row_block=BLOCK)
            compare(kname, o1, r1, f"{shape} out1", K_BOUND)
            compare(kname, o2, r2, f"{shape} out2", K_BOUND)
            continue
        # sampled rows: out1 rows need all of X2, out2 rows all of X1
        i1 = torch.as_tensor(sampled_rows(n1, min(rows, n1), 23), device=dev)
        i2 = torch.as_tensor(sampled_rows(n2, min(rows, n2), 24), device=dev)
        f1 = kernel_plain.gram_matmat_f64(kind, X1[i1], X2, V2, ls, row_block=256)
        f2 = kernel_plain.gram_matmat_f64(kind, X2[i2], X1, V1, ls, row_block=256)
        t1 = kernel_plain.gram_pair_tier(kind, P1.rows(i1), P2, V2, V1[i1], row_block=256)[0]
        t2 = kernel_plain.gram_pair_tier(kind, P1, P2.rows(i2), V2[i2], V1, row_block=256)[1]
        sh = f"{shape} rows {rows}"
        compare(kname, o1[i1], t1, f"{cd} {sh} out1 vs its tier", TIER_BOUND)
        compare(kname, o2[i2], t2, f"{cd} {sh} out2 vs its tier",
                REROUND_BOUND if cd == "bfloat16" and k >= 3 else TIER_BOUND)
        compare(kname, o1[i1], f1, f"{cd} {sh} out1 vs float64", BF16X3_F64_BOUND)
        compare(kname, o2[i2], f2, f"{cd} {sh} out2 vs float64", BF16X3_F64_BOUND)
    V2 = torch.randn((n2, 1), generator=gen, device=dev)
    V1 = torch.randn((n1, 1), generator=gen, device=dev)
    ms = cuda_ms(lambda: kernel(V2, V1))
    p_ms = cuda_ms(lambda: plain(V2, V1), reps=1, warm=False)
    shape = f"{what} n1={n1} n2={n2} d={X1.shape[1]} k=1" + (f" {cd}" if cd else "")
    timings.setdefault(kname, []).append(
        timing_entry(kname, shape, ms, p_ms, n1, n2, X1.shape[1], 1, kind, cd))
    print(f"time {kname} {shape}: kernel {ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"bound {timings[kname][-1]['bound_ms']:.3f} ms "
          f"(checks {time.perf_counter() - t0:.3f} s)")


def used_since(before):
    from rlaopt_tpu_torch.ops import kernel_cuda

    after = kernel_cuda.launch_counts()
    return {c: after[c] - before[c] for c in after if after[c] != before[c]}


def residual_gaps(name, log, iterates, rel64):
    """Every logged rel_res past iteration 0 against the float64 one of the
    same iterate (``rel64``, one value per logged iterate past 0)."""
    gaps = {}
    for j, i in enumerate(int_keys(log)[1:]):
        logged = float(log[i]["metrics"]["internal_metrics"]["rel_res"][0])
        gaps[i] = abs(logged - rel64[j]) / rel64[j]
        print(f"{name} iter {i}: rel_res {logged:.6e} float64 {rel64[j]:.6e} gap {gaps[i]:.2e}")
        check(gaps[i] <= 0.01, f"{name} rel_res at {i} within 1% of float64")
    return gaps


def matvec_launches(name, K, v, expected):
    """One matvec of a sharded operator, its launches against the
    schedule's count."""
    from rlaopt_tpu_torch.ops import kernel_cuda

    before = kernel_cuda.launch_counts()
    out = K @ v
    used = used_since(before)
    print(f"{name} one matvec: launches {used}, the schedule's {expected}")
    check(used == expected, f"{name} launches per matvec equal the schedule's")
    return out


def ring_vs(name, ring_out, flat_out, ref64):
    """A ring matvec against the unsharded operator's and float64."""
    scale = ref64.abs().max().item()
    d_flat = (ring_out.double() - flat_out.double()).abs().max().item() / scale
    d_ref = (ring_out.double() - ref64).abs().max().item() / scale
    d_flat_ref = (flat_out.double() - ref64).abs().max().item() / scale
    print(f"{name}: ring vs unsharded {d_flat:.3e}, ring vs float64 {d_ref:.3e}, "
          f"unsharded vs float64 {d_flat_ref:.3e} (of max|ref|)")
    return d_flat, d_ref


def slice5(dev, Xn100, yn100, profile_run, compare, timings):
    """Slice 5: the sharded operators and config 5's path on positions of
    the one card (E1–E4, see the module docstring), with the pair kernels
    checked and timed at each path's shard shape. Each path's launches are
    counted from 0 just before it and read just after. Returns the records,
    each with its launches under ``"launches"``."""
    import torch

    from rlaopt_tpu_torch.kernels import (
        KernelConfig,
        LaplaceLinOp,
        RBFLinOp,
        ShardedLaplaceLinOp,
        ShardedRBFLinOp,
    )
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
    from rlaopt_tpu_torch.parallel import make_mesh
    from rlaopt_tpu_torch.preconditioners import NystromConfig
    from rlaopt_tpu_torch.solvers import PCGConfig
    from rlaopt_tpu_torch.spectral_estimators import hutchinson, lanczos_eigsh

    ls = D**0.5
    Xn, yn = synthetic_higgs(N5)
    X = torch.from_numpy(Xn).to(dev)
    y = torch.from_numpy(yn).to(dev)
    reg = 1e-4 * N5
    cfg = PCGConfig(max_iters=ITERS5, rtol=1e-6,
                    precond_config=NystromConfig(rank=RANK5, rho=reg))
    records = {}
    t_phase = time.perf_counter()
    pair_ragged(dev, compare)

    def config5(name, K, refine):
        """Config 5 as written on operator K: Lanczos, Hutchinson, the
        solve (with one evaluate-mode float64 refinement round when
        ``refine``), counted from 0 and profiled; then its checks."""
        iterates = []
        kernel_cuda.reset_launch_counts()
        with profile_run() as prof:
            t0 = time.perf_counter()
            lam = lanczos_eigsh(K, num_iters=LANCZOS5, key=0)
            tr, var = hutchinson(K, PROBES5, "gauss", key=0)
            torch.cuda.synchronize()
            t_est = time.perf_counter() - t0
            sys_ = LinSys(K, y, reg=reg)
            extra = dict(f64_refine_rounds=1, f64_refine_device="accel") if refine else {}
            W, log = sys_.solve(cfg, torch.zeros((N5, 1), device=dev), callback_freq=10, key=0,
                                callback_fn=lambda w, _model: iterates.append(w.clone()),
                                **extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        used = kernel_cuda.launch_counts()
        keys = int_keys(log)
        iters = keys[-1]
        lam_max, trace, se = float(lam[-1]), float(tr), (float(var) / PROBES5) ** 0.5
        print(f"{name}: lambda_max {lam_max:.6e} trace {trace:.6e} ± {se:.3e} (exact c·n = "
              f"{float(N5):.1f}) estimators {t_est:.3f} s; solve wall {wall:.3f} s "
              f"phase_walls {sys_.phase_walls} iters {iters} launches {used}")
        check(np.isfinite(lam_max) and 0 < lam_max <= trace + 5 * se,
              f"{name} lambda_max finite, positive, below the trace")
        check(abs(trace - N5) <= 5 * se, f"{name} Hutchinson within 5 standard errors of c·n")
        # every logged iterate's float64 residual in one plain sweep
        W64 = torch.cat([w.double() for w in iterates[1:]], 1)
        y64 = y.double()[:, None]
        R = y64 - (kernel_plain.gram_matmat_f64("rbf", X, X, W64, ls, row_block=BLOCK)
                   + reg * W64)
        rel64 = (torch.linalg.norm(R, dim=0) / torch.linalg.norm(y64)).cpu().numpy()
        gaps = residual_gaps(name, log, iterates, rel64)
        first = float(log[0]["metrics"]["internal_metrics"]["rel_res"][0])
        last = float(log[iters]["metrics"]["internal_metrics"]["rel_res"][0])
        check(np.isfinite(last) and last < first, f"{name} rel_res falls")
        profile = device_breakdown(prof) if prof else {}
        busy = profile.get("busy_ms")
        rec = {"n": N5, "positions": K.mesh.size, "memory_mode": K.memory_mode,
               "lambda_max": lam_max, "trace": trace, "trace_se": se, "estimators_s": t_est,
               "wall_s": wall, "phase_walls": sys_.phase_walls, "iters": iters,
               "s_per_iter": sys_.phase_walls["train"] / iters,
               "rel_res": {i: log[i]["metrics"]["internal_metrics"]["rel_res"].tolist()
                           for i in keys}, "gaps": gaps, "launches": used, "profile": profile,
               "busy_share": None if busy is None else busy / 1e3 / wall}
        if refine:
            ref = log["f64_refine"]
            final = ref["rel_res_f64"][-1][0]
            R = y64 - (kernel_plain.gram_matmat_f64("rbf", X, X, W, ls, row_block=BLOCK)
                       + reg * W)
            indep = (torch.linalg.norm(R) / torch.linalg.norm(y64)).item()
            print(f"{name} refined: {json.dumps(ref)} independent float64 {indep:.6e}")
            check(W.dtype == torch.float64 and W.is_cuda, f"{name} refined W float64 on the card")
            check(final <= 1e-6, f"{name} refined rel_res_f64 {final:.3e} <= 1e-6 (the base "
                  f"solve logged {last:.3e})")
            check(abs(final - indep) <= 0.01 * indep,
                  f"{name} refined rel_res_f64 within 1% of an independent float64 one")
            check(used["gram_matvec_symmetric_f64"] > 0 and used["gram_matmat_f64"] > 0,
                  f"{name} refinement ran through K7 and K8")
            rec.update({"refine": ref, "refined_independent": indep})
        return rec

    # E1: config 5 as written, one position (make_mesh() on the one card):
    # the replicated row slab, K1 for every product, K1c at the boundaries
    K1 = ShardedRBFLinOp(X, X, KernelConfig(lengthscale=ls), mesh=make_mesh())
    rec = config5("E1", K1, refine=False)
    used = rec["launches"]
    check(used["gram_matmat"] >= rec["iters"] + LANCZOS5 + 2, "E1 ran through K1")
    check(used["gram_matmat_comp"] >= 1, "E1 boundaries ran through K1c")
    records["E1"] = rec
    print("slice5 E1 " + json.dumps(rec))
    print(f"phase: slice 5 E1 done at {time.perf_counter() - t_phase:.1f} s into it")

    # E2: the same on a 4-position ring of the card: the half-ring
    mesh = make_mesh(devices=[dev] * P_RING)
    K2 = ShardedRBFLinOp(X, X, KernelConfig(lengthscale=ls), mesh=mesh, memory_mode="ring")
    rec2 = config5("E2", K2, refine=True)
    used = rec2["launches"]
    pairs = P_RING * (P_RING - 1) // 2
    check(used["gram_pair"] >= pairs * (rec2["iters"] + LANCZOS5), "E2's pairs ran through K4")
    check(used["gram_matvec_symmetric"] >= P_RING * (rec2["iters"] + LANCZOS5),
          "E2's diagonal blocks ran through K2")
    check(abs(rec2["lambda_max"] - rec["lambda_max"]) <= 1e-4 * rec["lambda_max"],
          "E2's lambda_max within 1e-4 of E1's (the same start vector)")
    records["E2"] = rec2
    # one matvec: its launches, against the unsharded operator (K2) and
    # float64; then both timed in turns (ring, flat, flat, ring)
    v = torch.randn((N5, 1), generator=torch.Generator(device=dev).manual_seed(25), device=dev)
    Kflat = RBFLinOp(X, X, KernelConfig(lengthscale=ls))
    ring_out = matvec_launches("E2", K2, v, {"gram_matvec_symmetric": P_RING,
                                             "gram_pair": pairs})
    ref64 = kernel_plain.gram_matmat_f64("rbf", X, X, v.double(), ls, row_block=BLOCK)
    d_flat, d_ref = ring_vs("E2", ring_out, Kflat @ v, ref64)
    check(d_ref <= K_BOUND and d_flat <= 2 * K_BOUND, "E2 ring matvec within the kernel bound")
    t_ring = cuda_ms(lambda: K2 @ v)
    t_flat = cuda_ms(lambda: Kflat @ v)
    t_flat2 = cuda_ms(lambda: Kflat @ v)
    t_ring2 = cuda_ms(lambda: K2 @ v)
    rec2["matvec_ms"] = {"ring": [t_ring, t_ring2], "unsharded_K2": [t_flat, t_flat2],
                         "ratio": (t_ring + t_ring2) / (t_flat + t_flat2)}
    print(f"time E2 ring matvec n={N5} P={P_RING} k=1: {t_ring:.3f} / {t_ring2:.3f} ms, "
          f"unsharded K2 {t_flat:.3f} / {t_flat2:.3f} ms, ratio {rec2['matvec_ms']['ratio']:.3f}")
    print("slice5 E2 " + json.dumps(rec2))
    # K4 at E2's shard shape (two shards of 12,500 points), checked on all rows
    loc = N5 // P_RING
    pair_at(dev, "gram_pair", X[:loc], X[loc:2 * loc], compare, timings, "E2 shards", ls=ls)
    del K1, K2, Kflat, X, y
    print(f"phase: slice 5 E2 done at {time.perf_counter() - t_phase:.1f} s into it")

    # E3: the Laplace half-ring on 3 positions at path B's shape (K5, K6)
    X100 = torch.from_numpy(Xn100).to(dev)
    Y100 = torch.from_numpy(yn100).to(dev)
    n = X100.shape[0]
    reg3 = 1e-4 * n
    K3 = ShardedLaplaceLinOp(X100, X100, KernelConfig(lengthscale=LS_B),
                             mesh=make_mesh(devices=[dev] * P_LAPLACE), memory_mode="ring")
    cfg3 = PCGConfig(max_iters=ITERS, rtol=1e-6, precond_config=NystromConfig(rank=RANK, rho=reg3))
    iterates = []
    kernel_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    sys3 = LinSys(K3, Y100, reg=reg3)
    _, log3 = sys3.solve(cfg3, torch.zeros((n, 1), device=dev), callback_freq=FREQ, key=0,
                         callback_fn=lambda w, _model: iterates.append(w.clone()))
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    used3 = kernel_cuda.launch_counts()
    lpairs = P_LAPLACE * (P_LAPLACE - 1) // 2
    # every logged iterate's float64 residual through K7 (one sweep)
    W64 = torch.cat([w.double() for w in iterates[1:]], 1)
    y64 = Y100.double()[:, None]
    R = y64 - (kernel_cuda.gram_matvec_symmetric_f64("laplace", X100, W64, LS_B) + reg3 * W64)
    rel64 = (torch.linalg.norm(R, dim=0) / torch.linalg.norm(y64)).cpu().numpy()
    gaps3 = residual_gaps("E3", log3, iterates, rel64)
    keys3 = int_keys(log3)
    check(used3["laplace_pair"] >= lpairs * keys3[-1], "E3's pairs ran through K6")
    rec3 = {"n": n, "positions": P_LAPLACE, "wall_s": wall3, "phase_walls": sys3.phase_walls,
            "iters": keys3[-1], "s_per_iter": sys3.phase_walls["train"] / keys3[-1],
            "rel_res": {i: log3[i]["metrics"]["internal_metrics"]["rel_res"].tolist()
                        for i in keys3}, "gaps": gaps3, "launches": used3}
    v = torch.randn((n, 1), generator=torch.Generator(device=dev).manual_seed(26), device=dev)
    ring_out = matvec_launches("E3", K3, v, {"laplace_matvec_symmetric": P_LAPLACE,
                                             "laplace_pair": lpairs})
    Kflat = LaplaceLinOp(X100, X100, KernelConfig(lengthscale=LS_B))
    ref64 = kernel_cuda.gram_matvec_symmetric_f64("laplace", X100, v.double(), LS_B)
    d_flat, d_ref = ring_vs("E3", ring_out, Kflat @ v, ref64)
    check(d_ref <= K_BOUND and d_flat <= 2 * K_BOUND, "E3 ring matvec within the kernel bound")
    t_ring = cuda_ms(lambda: K3 @ v)
    t_flat = cuda_ms(lambda: Kflat @ v)
    rec3["matvec_ms"] = {"ring": t_ring, "unsharded_K5": t_flat, "ratio": t_ring / t_flat}
    print(f"time E3 ring matvec n={n} P={P_LAPLACE} k=1: {t_ring:.3f} ms, unsharded K5 "
          f"{t_flat:.3f} ms")
    records["E3"] = rec3
    print("slice5 E3 " + json.dumps(rec3))
    loc = -(-n // P_LAPLACE)
    pair_at(dev, "laplace_pair", X100[:loc], X100[loc:2 * loc], compare, timings, "E3 shards",
            kind="laplace", ls=LS_B)
    del K3, Kflat
    print(f"phase: slice 5 E3 done at {time.perf_counter() - t_phase:.1f} s into it")

    # E4: the bf16x3 ring at config 6's n on 4 positions (K2b, K4b), five
    # matvecs timed against K2b on the unsharded operator
    X6 = torch.from_numpy(synthetic_higgs(N6)[0]).to(dev)
    K4 = ShardedRBFLinOp(X6, X6, KernelConfig(lengthscale=ls), mesh=make_mesh(devices=[dev] * 4),
                         memory_mode="ring", compute_dtype="bf16x3")
    Kflat = RBFLinOp(X6, X6, KernelConfig(lengthscale=ls), compute_dtype="bf16x3")
    v = torch.randn((N6, 1), generator=torch.Generator(device=dev).manual_seed(27), device=dev)
    kernel_cuda.reset_launch_counts()
    t_ring = cuda_ms(lambda: K4 @ v, reps=5, warm=False)
    used4 = kernel_cuda.launch_counts()
    check(used4 == {**{c: 0 for c in used4}, "gram_matvec_symmetric_tier": 5 * 4,
                    "gram_pair_tier": 5 * pairs}, "E4 launches equal the schedule's")
    t_flat = cuda_ms(lambda: Kflat @ v, reps=5, warm=False)
    idx = torch.as_tensor(sampled_rows(N6, 4096, 28), device=dev)
    ref64 = kernel_plain.gram_matmat_f64("rbf", X6[idx], X6, v.double(), ls, row_block=256)
    ring_out, flat_out = K4 @ v, Kflat @ v
    d_flat, d_ref = ring_vs("E4 rows 4096", ring_out[idx], flat_out[idx], ref64)
    check(d_ref <= BF16X3_F64_BOUND and d_flat <= 2 * BF16X3_F64_BOUND,
          "E4 ring matvec within the tier's bound of float64")
    rec4 = {"n": N6, "positions": 4, "matvec_ms": {"ring": t_ring, "unsharded_K2b": t_flat,
                                                   "ratio": t_ring / t_flat},
            "ring_vs_float64": d_ref, "ring_vs_unsharded": d_flat, "launches": used4}
    print(f"time E4 ring matvec n={N6} P=4 k=1 bf16x3: {t_ring:.3f} ms, unsharded K2b "
          f"{t_flat:.3f} ms, ratio {t_ring / t_flat:.3f}")
    records["E4"] = rec4
    print("slice5 E4 " + json.dumps(rec4))
    del K4, Kflat, ring_out, flat_out
    loc = N6 // 4
    pair_at(dev, "gram_pair_tier", X6[:loc], X6[loc:2 * loc], compare, timings, "E4 shards",
            ls=ls, cd="bf16x3", rows=4096)
    print(f"phase: slice 5 E4 done at {time.perf_counter() - t_phase:.1f} s into it")
    return records


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
    from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand
    from rlaopt_tpu_torch.preconditioners import NystromConfig
    from rlaopt_tpu_torch.solvers import PCGConfig

    t_start = time.perf_counter()
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
    # the kernels this slice redesigned: K2b and #9's short-row schedule
    registers = ptxas_report(lib.with_suffix(".log").read_text(),
                             ("gram_tier_symmetric", "csr_spmm_lanes"))
    print("registers " + json.dumps(registers))
    check(len(registers) > 0 and all("registers" in r for r in registers.values()),
          "the build log reports the registers of K2b and #9's short-row kernel")

    # 3. each kernel against its plain version
    Xn, yn = synthetic_higgs(N)
    X = torch.from_numpy(Xn).to(dev)
    ls = D**0.5
    gen = torch.Generator(device=dev).manual_seed(1)
    Vs = {k: torch.randn((N, k), generator=gen, device=dev) for k in (1, 10, 16, 500)}
    refs = {
        k: kernel_plain.gram_matmat_f64("rbf", X, X, Vs[k], ls, row_block=BLOCK)
        for k in (1, 10, 500)
    }
    names = ("gram_matmat", "gram_matmat_comp", "gram_matvec_symmetric",
             "gram_matmat_tier", "gram_matvec_symmetric_tier", "gram_matmat_f64",
             "gram_matvec_symmetric_f64", "laplace_matmat", "laplace_matmat_comp",
             "laplace_matvec_symmetric", "csr_spmv", "csr_spmm", "gram_pair",
             "gram_pair_tier", "laplace_pair")
    # (kernel, "plain" or "float64") -> [(max abs err, relative)]; "plain"
    # is the kernel's own plain version (float64 for all but the tiers)
    errors = {(kname, versus): [] for kname in names for versus in ("plain", "float64")}

    def compare(kernel, got, ref, what, bound):
        torch.cuda.synchronize()
        diff = (got.double() - ref.double()).abs().max().item()
        rel = diff / ref.double().abs().max().item()
        versus = "float64" if what.endswith("vs float64") else "plain"
        errors[(kernel, versus)].append((diff, rel))
        print(f"check {kernel} {what}: max_abs_err={diff:.3e} rel={rel:.3e} (bound {bound:.1e})")
        check(rel <= bound, f"{kernel} {what} within {bound:.1e}")
        return rel

    for k in refs:
        compare("gram_matmat", kernel_cuda.gram_matmat("rbf", X, X, Vs[k], ls),
                refs[k], f"n=m={N} d={D} k={k}", K_BOUND)
    for k in (1, 10):
        compare("gram_matvec_symmetric",
                kernel_cuda.gram_matvec_symmetric("rbf", X, Vs[k], ls),
                refs[k], f"n={N} d={D} k={k}", K_BOUND)
    rel_k1 = errors[("gram_matmat", "plain")][0][1]
    hi, lo = kernel_cuda.gram_matmat_comp("rbf", X, X, Vs[1], ls)
    rel = compare("gram_matmat_comp", hi.double() + lo.double(), refs[1],
                  f"n=m={N} d={D} k=1 (hi+lo)", COMP_BOUND)
    check(rel <= rel_k1, "gram_matmat_comp no worse than gram_matmat")
    jhi, jlo = plain_twosum_f32("rbf", X, Vs[1], ls)
    diff = (jhi.double() + jlo.double() - refs[1]).abs().max().item()
    twosum_f32_rel = diff / refs[1].abs().max().item()
    print(f"check plain f32 TwoSum (the JAX package's compensated contract) "
          f"n=m={N} d={D} k=1 (hi+lo): max_abs_err={diff:.3e} rel={twosum_f32_rel:.3e}")

    # the bf16 tiers at the HIGGS shape: K1b at k = 1, 10, 500; K2b at 1, 10
    parts = {cd: tier_operand(X / ls, cd) for cd in TIERS}
    for cd in TIERS:
        P = parts[cd]
        for k in (1, 10, 500):
            what = f"{cd} n=m={N} d={D} k={k}"
            got = kernel_cuda.gram_matmat_tier("rbf", P, P, Vs[k])
            reround = cd == "bfloat16" and k > 16
            compare("gram_matmat_tier", got,
                    kernel_plain.gram_matmat_tier("rbf", P, P, Vs[k], row_block=BLOCK),
                    what + " vs its tier", REROUND_BOUND if reround else TIER_BOUND)
            if cd == "bf16x3":
                bound = BF16X3_F64_BOUND
            else:
                bound = 3 * JAX_TIER_ERR[("higgs", cd, "gen", min(k, 10))]
                bound += FAST_CONTRACTION if k > 16 else 0.0
            compare("gram_matmat_tier", got, refs[k], what + " vs float64", bound)
            if k > 16:
                continue
            got = kernel_cuda.gram_matvec_symmetric_tier("rbf", P, Vs[k])
            reround = cd == "bfloat16" and k >= 3
            compare("gram_matvec_symmetric_tier", got,
                    kernel_plain.gram_matvec_symmetric_tier("rbf", P, Vs[k], row_block=BLOCK),
                    f"{cd} n={N} d={D} k={k} vs its tier",
                    REROUND_BOUND if reround else TIER_BOUND)
            bound = (BF16X3_F64_BOUND if cd == "bf16x3"
                     else 3 * JAX_TIER_ERR[("higgs", cd, "sym", k)])
            compare("gram_matvec_symmetric_tier", got, refs[k],
                    f"{cd} n={N} d={D} k={k} vs float64", bound)
    # the float64 kernels at the HIGGS shape, k = 1 and 10
    for k in (1, 10):
        V64 = Vs[k].double()
        ref = kernel_plain.gram_matmat_f64("rbf", X, X, V64, ls, row_block=BLOCK)
        compare("gram_matmat_f64", kernel_cuda.gram_matmat_f64("rbf", X, X, V64, ls),
                ref, f"n=m={N} d={D} k={k}", COMP_BOUND)
        compare("gram_matvec_symmetric_f64",
                kernel_cuda.gram_matvec_symmetric_f64("rbf", X, V64, ls),
                ref, f"n={N} d={D} k={k}", COMP_BOUND)

    # every family at the ragged shape
    A1, A2, W7, S7 = (torch.from_numpy(a).to(dev) for a in ragged_data())
    for kind in SQDIST_KINDS:
        ref = kernel_plain.gram_matmat_f64(kind, A1, A2, W7, 1.3, 0.9)
        rel = compare("gram_matmat", kernel_cuda.gram_matmat(kind, A1, A2, W7, 1.3, 0.9),
                      ref, f"{kind} n=1000 m=777 d=3 k=7", K_BOUND)
        hi, lo = kernel_cuda.gram_matmat_comp(kind, A1, A2, W7, 1.3, 0.9)
        rel_c = compare("gram_matmat_comp", hi.double() + lo.double(), ref,
                        f"{kind} n=1000 m=777 d=3 k=7 (hi+lo)", COMP_BOUND)
        check(rel_c <= rel, f"gram_matmat_comp {kind} ragged no worse than gram_matmat")
        ref_s = kernel_plain.gram_matmat_f64(kind, A1, A1, S7, 1.3, 0.9)
        compare("gram_matvec_symmetric",
                kernel_cuda.gram_matvec_symmetric(kind, A1, S7, 1.3, 0.9),
                ref_s, f"{kind} n=1000 d=3 k=7", K_BOUND)
        for cd in TIERS:
            P1, P2 = tier_operand(A1 / 1.3, cd), tier_operand(A2 / 1.3, cd)
            what = f"{cd} {kind} n=1000 m=777 d=3 k=7"
            got = kernel_cuda.gram_matmat_tier(kind, P1, P2, W7, 0.9)
            compare("gram_matmat_tier", got,
                    kernel_plain.gram_matmat_tier(kind, P1, P2, W7, 0.9),
                    what + " vs its tier", TIER_BOUND)
            compare("gram_matmat_tier", got, ref, what + " vs float64",
                    3 * JAX_TIER_ERR[("ragged", cd, "gen", kind)])
            what = f"{cd} {kind} n=1000 d=3 k=7"
            got = kernel_cuda.gram_matvec_symmetric_tier(kind, P1, S7, 0.9)
            bound = REROUND_BOUND if cd == "bfloat16" else TIER_BOUND
            # Matérn-1/2's cusp: on the diagonal of a symmetric product the
            # tier's squared distance is a cancelled float sum, ~2^-17 |x|^2
            # (bf16x3), whose square root the two summation orders put
            # apart by up to the tier's own error there. The whole product
            # is held to that; the rows whose own row of the right-hand
            # side is zero hold no diagonal value, and are held to the
            # tier's bound (even rows, then odd rows).
            compare("gram_matvec_symmetric_tier", got,
                    kernel_plain.gram_matvec_symmetric_tier(kind, P1, S7, 0.9),
                    what + " vs its tier",
                    JAX_TIER_ERR[("ragged", cd, "sym", kind)] if kind == "matern12" else bound)
            if kind == "matern12":
                for parity in (0, 1):
                    rows = torch.arange(A1.shape[0], device=dev) % 2 == parity
                    Sz = torch.where(rows[:, None], 0.0, S7)
                    compare("gram_matvec_symmetric_tier",
                            kernel_cuda.gram_matvec_symmetric_tier(kind, P1, Sz, 0.9)[rows],
                            kernel_plain.gram_matvec_symmetric_tier(kind, P1, Sz, 0.9)[rows],
                            what + f" rows {parity}::2 off the diagonal vs its tier", bound)
            compare("gram_matvec_symmetric_tier", got,
                    kernel_plain.gram_matmat_f64(kind, A1, A1, S7, 1.3, 0.9),
                    what + " vs float64", 3 * JAX_TIER_ERR[("ragged", cd, "sym", kind)])
    for kind in SQDIST_KINDS + ("laplace",):
        compare("gram_matmat_f64",
                kernel_cuda.gram_matmat_f64(kind, A1, A2, W7.double(), 1.3, 0.9),
                kernel_plain.gram_matmat_f64(kind, A1, A2, W7, 1.3, 0.9),
                f"{kind} n=1000 m=777 d=3 k=7", COMP_BOUND)
        compare("gram_matvec_symmetric_f64",
                kernel_cuda.gram_matvec_symmetric_f64(kind, A1, S7.double(), 1.3, 0.9),
                kernel_plain.gram_matmat_f64(kind, A1, A1, S7, 1.3, 0.9),
                f"{kind} n=1000 d=3 k=7", COMP_BOUND)
    del refs

    # The first shape of each kernel is the one its JSON entry reports.
    def kernel_and_plain(kernel, k, cd=None):
        V = Vs[k]
        P = parts.get(cd)
        V64 = V.double()
        return {
            "gram_matmat": (lambda: kernel_cuda.gram_matmat("rbf", X, X, V, ls),
                            lambda: kernel_plain.gram_matmat("rbf", X, X, V, ls, row_block=BLOCK)),
            "gram_matvec_symmetric": (
                lambda: kernel_cuda.gram_matvec_symmetric("rbf", X, V, ls),
                lambda: kernel_plain.gram_matvec_symmetric("rbf", X, V, ls, row_block=BLOCK)),
            "gram_matmat_comp": (
                lambda: kernel_cuda.gram_matmat_comp("rbf", X, X, V, ls),
                lambda: kernel_plain.gram_matmat_comp("rbf", X, X, V, ls, col_block=BLOCK)),
            "gram_matmat_tier": (
                lambda: kernel_cuda.gram_matmat_tier("rbf", P, P, V),
                lambda: kernel_plain.gram_matmat_tier("rbf", P, P, V, row_block=BLOCK)),
            "gram_matvec_symmetric_tier": (
                lambda: kernel_cuda.gram_matvec_symmetric_tier("rbf", P, V),
                lambda: kernel_plain.gram_matvec_symmetric_tier("rbf", P, V, row_block=BLOCK)),
            "gram_matmat_f64": (
                lambda: kernel_cuda.gram_matmat_f64("rbf", X, X, V64, ls),
                lambda: kernel_plain.gram_matmat_f64("rbf", X, X, V64, ls, row_block=BLOCK)),
            "gram_matvec_symmetric_f64": (
                lambda: kernel_cuda.gram_matvec_symmetric_f64("rbf", X, V64, ls),
                lambda: kernel_plain.gram_matvec_symmetric_f64("rbf", X, V64, ls,
                                                               row_block=BLOCK)),
        }[kernel]

    timings = {}
    # K7's plain version is K8's on (X, X), the same call: timed once per k
    # (13.5 s a run at this shape), for both rows.
    plain_f64_ms = {}
    for kernel, k, cd in (
        ("gram_matmat", 500, None), ("gram_matmat", 1, None), ("gram_matmat", 10, None),
        ("gram_matmat", 16, None),
        ("gram_matvec_symmetric", 1, None), ("gram_matvec_symmetric", 10, None),
        ("gram_matvec_symmetric", 16, None),
        ("gram_matmat_comp", 1, None), ("gram_matmat_comp", 10, None),
        ("gram_matmat_tier", 500, "bf16x3"), ("gram_matmat_tier", 1, "bf16x3"),
        ("gram_matmat_tier", 10, "bf16x3"), ("gram_matmat_tier", 500, "bfloat16"),
        ("gram_matmat_tier", 1, "bfloat16"), ("gram_matmat_tier", 10, "bfloat16"),
        ("gram_matvec_symmetric_tier", 1, "bf16x3"),
        ("gram_matvec_symmetric_tier", 10, "bf16x3"),
        ("gram_matvec_symmetric_tier", 1, "bfloat16"),
        ("gram_matvec_symmetric_tier", 10, "bfloat16"),
        ("gram_matvec_symmetric_f64", 1, None), ("gram_matvec_symmetric_f64", 10, None),
        ("gram_matmat_f64", 1, None), ("gram_matmat_f64", 10, None),
    ):
        fn, plain = kernel_and_plain(kernel, k, cd)
        ms = cuda_ms(fn)
        if kernel.endswith("_f64"):
            if k not in plain_f64_ms:
                plain_f64_ms[k] = cuda_ms(plain)
            plain_ms = plain_f64_ms[k]
        else:
            plain_ms = cuda_ms(plain)
        shape = f"n={N} d={D} k={k}" + (f" {cd}" if cd else "")
        entry = timing_entry(kernel, shape, ms, plain_ms, N, N, D, k, "rbf", cd)
        line = (f"time {kernel} {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                f"bound {entry['bound_ms']:.3f} ms")
        if kernel == "gram_matmat_comp":
            entry["plain_f32_twosum_ms"] = cuda_ms(lambda: plain_twosum_f32("rbf", X, Vs[k], ls))
            line += f", plain f32 TwoSum {entry['plain_f32_twosum_ms']:.3f} ms"
        timings.setdefault(kernel, []).append(entry)
        print(line)
    # K1b at k = 500 once more, a minute after its first timing: the spread
    # within one run
    again = cuda_ms(kernel_and_plain("gram_matmat_tier", 500, "bf16x3")[0])
    timings["gram_matmat_tier"][0]["ms_again"] = again
    print(f"time gram_matmat_tier n={N} d={D} k=500 bf16x3 again: kernel {again:.3f} ms")
    laplace_kernels(dev, X, compare, timings)
    print(f"phase: kernel checks and times done at {time.perf_counter() - t_start:.1f} s")

    # 4. slice 1, config 3 whole, through the entry points a user calls
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
    before = kernel_cuda.launch_counts()
    sys_r = LinSys(K, Y1, reg=reg)
    t0 = time.perf_counter()
    W64, log_r = sys_r.solve(
        cfg, torch.zeros((N, 1), device=dev), callback_freq=FREQ, key=0,
        f64_refine_rounds=2, f64_refine_device="accel",
    )
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    after = kernel_cuda.launch_counts()
    counts_slice1 = kernel_cuda.launch_counts()
    used_r = {n_: after[n_] - before[n_] for n_ in after}

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
            W64i = Wi.double()
            KW = kernel_plain.gram_matmat_f64("rbf", X, X, W64i, ls, row_block=BLOCK)
            R64 = B64 - (KW + reg * W64i)
            rel64 = torch.linalg.norm(R64, dim=0).cpu().numpy() / b_norms
            gaps = np.abs(np.array(hist[i]) - rel64) / rel64
            print(f"slice k={k} iter {i}: independent float64 rel_res "
                  f"{rel64.tolist()}; gaps {gaps.tolist()}")
            check(np.all(gaps <= 0.01),
                  f"k={k} rel_res at iteration {i} within 1% of float64")
        print("slice " + json.dumps({"k": k, "iters": iters, "s_per_iter": s_iter}))

    # the refined k = 1 solve (config 3's two rounds, evaluate/full)
    ref_r = log_r["f64_refine"]
    iters_r = int_keys(log_r)[-1]
    base_r = float(log_r[iters_r]["metrics"]["internal_metrics"]["rel_res"][0])
    final_r = ref_r["rel_res_f64"][-1][0]
    y64 = Y1.double()[:, None]
    KW = kernel_plain.gram_matmat_f64("rbf", X, X, W64, ls, row_block=BLOCK)
    indep_r = (torch.linalg.norm(y64 - (KW + reg * W64)) / torch.linalg.norm(y64)).item()
    print(f"slice k=1 refined: wall {wall_r:.3f} s phase_walls {sys_r.phase_walls} "
          f"base rel_res {base_r:.6e} refine {json.dumps(ref_r)} "
          f"independent float64 rel_res {indep_r:.6e} launches {used_r}")
    check(W64.dtype == torch.float64 and W64.is_cuda, "refined W is float64 on the card")
    check(final_r < base_r and final_r <= 1e-6,
          f"refined rel_res_f64 {final_r:.3e} below the base {base_r:.3e} and 1e-6")
    check(abs(final_r - indep_r) <= 0.01 * indep_r,
          "refined rel_res_f64 within 1% of the independent float64 residual")
    check(used_r["gram_matvec_symmetric_f64"] > 0, "refinement ran through K7")
    print(f"phase: slice 1 done at {time.perf_counter() - t_start:.1f} s")

    # path B: Nyström-PCG on the Laplace operator at the same shape
    counts_slice3 = slice3(dev, X, Xn, Y1)
    print(f"phase: slice 3 path B done at {time.perf_counter() - t_start:.1f} s")

    # 5. where the time goes: one more solve of each, profiled
    def profiled():
        return torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
        )

    for B in (Y1, Y10):
        k = 1 if B.ndim == 1 else B.shape[1]
        sys_ = LinSys(K, B, reg=reg)
        with profiled() as prof:
            t0 = time.perf_counter()
            sys_.solve(cfg, torch.zeros((N, k), device=dev), callback_freq=FREQ, key=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile = {"k": k, "wall_s": wall, "phase_walls": sys_.phase_walls}
        profile.update(device_breakdown(prof))
        print("profile " + json.dumps(profile))
    del K, parts, Vs, X
    torch.cuda.empty_cache()

    # 6. slice 2, config 6: the n = 1M north star, counted and profiled
    ns = north_star(dev, profiled, compare, timings)
    print("config6 " + json.dumps(ns))
    print(f"phase: config 6 done at {time.perf_counter() - t_start:.1f} s")

    # 7. slice 3, paths A and A': config 4's data (numpy, seed 0), made once
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    X4 = torch.from_numpy(
        (rng.standard_normal((N4, D4), dtype=np.float32) / np.float32(D4**0.5))).to(dev)
    y4 = torch.from_numpy(rng.standard_normal(N4, dtype=np.float32)).to(dev)
    torch.cuda.synchronize()
    print(f"config4 data: {time.perf_counter() - t0:.3f} s")
    rec_a = config4(dev, X4, y4, profiled, compare, timings, laplace=True)
    print(f"phase: slice 3 path A done at {time.perf_counter() - t_start:.1f} s")
    rec_a2 = config4(dev, X4, y4, profiled, compare, timings, laplace=False)
    print(f"phase: slice 3 path A' done at {time.perf_counter() - t_start:.1f} s")
    del X4, y4
    torch.cuda.empty_cache()

    # 8. slice 4: path S (sparse LSQR + SkPre through #9), then path C'
    rec_s = slice4(dev, profiled, compare, timings)
    torch.cuda.empty_cache()
    print(f"phase: slice 4 path S done at {time.perf_counter() - t_start:.1f} s")
    rec_c2 = config2(dev, profiled)
    print(f"phase: slice 4 path C' (config 2) done at {time.perf_counter() - t_start:.1f} s")

    # 9. slice 5: the sharded operators on positions of the card (E1-E4)
    torch.cuda.empty_cache()
    rec5 = slice5(dev, Xn, yn, profiled, compare, timings)
    print(f"phase: slice 5 done at {time.perf_counter() - t_start:.1f} s")

    # 10. result lines
    kernels = []
    comp = timings["gram_matmat_comp"][0]
    comp["plain_f32_twosum_rel_err"] = twosum_f32_rel
    paths = {"slice1": counts_slice1, "config6": ns["launches"], "slice3": counts_slice3,
             "config4_laplace": rec_a["launches"], "config4": rec_a2["launches"],
             "slice4_sparse": rec_s["launches"], "config2": rec_c2["launches"],
             **{path: rec["launches"] for path, rec in rec5.items()}}
    for kname, source, replaces in (
        ("gram_matmat", SOURCES["gram"], f"{PALLAS}:733"),
        ("gram_matmat_comp", SOURCES["gram"], f"{PALLAS}:733"),
        ("gram_matvec_symmetric", SOURCES["gram"], f"{PALLAS}:1366"),
        ("gram_matmat_tier", SOURCES["tier"], f"{PALLAS}:733"),
        ("gram_matvec_symmetric_tier", SOURCES["tier"], f"{PALLAS}:1366"),
        ("gram_matvec_symmetric_f64", SOURCES["f64"], f"{VALUE64}:467"),
        ("gram_matmat_f64", SOURCES["f64"], f"{VALUE64}:684"),
        ("laplace_matmat", SOURCES["laplace"], f"{PALLAS}:592"),
        ("laplace_matmat_comp", SOURCES["laplace"], f"{PALLAS}:592"),
        ("laplace_matvec_symmetric", SOURCES["laplace"], f"{PALLAS}:1930"),
        ("csr_spmv", SOURCES["spmv"], f"{LANED}:136"),
        ("csr_spmm", SOURCES["spmv"], f"{LANED}:136"),
        ("gram_pair", SOURCES["pair"], f"{PALLAS}:1563"),
        ("gram_pair_tier", SOURCES["pair"], f"{PALLAS}:1563"),
        ("laplace_pair", SOURCES["pair"], f"{PALLAS}:2063"),
    ):
        main_t = timings[kname][0]
        vs_f64 = errors[(kname, "float64")]
        by_path = {path: counts[kname] for path, counts in paths.items()}
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(e[0] for e in errors[(kname, "plain")]),
            "max_rel_err": max(e[1] for e in errors[(kname, "plain")]),
            "ms": main_t["ms"],
            "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"],
            # cuSPARSE for #9; no single PyTorch call computes c·k(X1, X2) @ V
            "library_ms": main_t.get("library_ms"),
            "shape": main_t["shape"],
            "timings": timings[kname],
        })
        if vs_f64:
            kernels[-1]["max_rel_err_vs_float64"] = max(e[1] for e in vs_f64)
        mine = {key: r for key, r in registers.items()
                if key.startswith("gram_tier_symmetric" if kname.endswith("symmetric_tier")
                                  else "csr_spmm_lanes" if kname.startswith("csr") else "-")}
        if mine:
            kernels[-1]["registers"] = mine
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
