#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on a CUDA card and check them.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (the kernels are built from
``rlaopt_tpu_torch/csrc/*.cu`` into ``build/`` on first use). It runs
straight through and exits non-zero at the first failure:

1. device: the card's name and power limit, the two TF32 flags (set off);
2. build of the Gram kernels and the ceiling probes, timed, and the
   registers and spills of the kernels redesigned for Hopper (K2b, #9's
   short-row, wide and segmented schedules, K1b's forward strip and wide
   kernel, K4b's pair strip, the float64 tile in its triangle (K1c, K3c
   and K7 on one data set), forward (the general K1c, K3c and K8) and pair
   (the certified pairs) forms, the register tile in its forward (K1, K3),
   triangle (K2, K5) and pair (K4, K6) forms, the 3xTF32 wide kernel of K1
   and K3) and of the probes from the build's ``-Xptxas -v`` log;
2b. the ceilings: each probe (TPU kernels #10-#13: the L1 pair rate in
   float32 and float64, the elementwise chain, the exp chain, the exp and
   epilogue rates) against its plain version at a small size, then, with
   the probes' counts set to 0, each at its TPU probe's shapes (the L1
   probes in as many instances as fill four or more whole rounds of the
   card's blocks), timed with CUDA events over 50 ms or more a timing
   (median of 3) and held against its plain version there, its rate by
   the TPU probe's own count printed, the SM clock and power draw sampled
   by ``nvidia-smi`` while the longest probe runs, and the pipes' peak
   rate for the L1 pair at that clock, and ``torch.cdist(p=1)`` on the L1
   probes' operands timed as their library call; each Laplace kernel's
   time is read against these rates at the end;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes (HIGGS-100k: n = 100,000, d = 28) and at a ragged shape
   for every family: K1, K1c (general and triangle), K2 against float64;
   K1b and K2b on both bf16 tiers against the plain version of the same
   tier and against float64; K7 and K8, all five families, against the
   float64 plain version, K7 also at k = 1, 2, 4, 5, 10, 16 with a scalar
   and an ARD lengthscale (before any path takes it as the reference of
   a certified residual); kernel and plain version timed (median of 5, CUDA
   events), the triangle K1c beside the general one, and a bf16
   ``torch.matmul`` of 8192^3 timed as the tensor cores' measured rate;
   K1 (its tile up to 16 columns, the 3xTF32 kernel past that) and K2 in
   every squared-distance family against float64 at the HIGGS shape on
   4,096 rows (K1 at k = 1, 3, 16, 17, 200, 500; K2 at 1, 2, 3, 10, 16), at
   ragged shapes (d = 3, 28, 50; scalar and ARD lengthscales) and K2 at
   E2's shard shape, the forward form the same bits twice; K1 timed at
   config 5's n (E1); the float64 tile's forward form (K1c, K3c, K8) at
   k = 16 and 17 at the HIGGS shape, at E2's shard, E1's slab and E3's
   shard, each the same bits twice and on sampled rows against float64,
   timed, in every family at ragged shapes (n < 128 too; d = 3, 28, 50;
   scalar and ARD lengthscales; k = 1, 3, 10, 17) with the certified pairs
   (both outputs), the pairs checked and timed at E2's and E3's shard pairs,
   and ``comp_operand``'s build timed;
4. slice 1, config 3 whole: RBF kernel ridge regression, Nyström-PCG (rank
   500) through ``LinSys.solve`` with k = 1 and k = 10 right-hand sides,
   then the k = 1 solve again with two float64 refinement rounds; every
   kernel of the path must have launched, the residual must fall, every
   logged residual must agree within 1% with an independent float64 one,
   and the refined residual must clear 1e-6 and agree with its own;
4b. the ported utils on slice 1's operator, counted as a path of their
   own: a 10-iteration solve with ``checkpoint_dir``, resumed to 20 and
   held to 1e-6 of one uninterrupted 20-iteration solve (the log holding
   every boundary); the four ``get_sketch`` classes in both modes at s =
   500, d = 100,000, drawn on the card by default, each apply against the
   materialized ``Omega_mat``; ``trace`` around one K2 matvec writing a
   trace file that names K2's kernel; ``Profiler.phase`` around one
   reading at least its CUDA-event time; ``debug_nans`` passing a healthy
   matvec and raising on one whose V holds a NaN;
5. one more solve of each k under ``torch.profiler``: the card's busy time
   and each kernel's share (where the time goes);
6. slice 2, config 6: the n = 1,000,000 north-star solve on the bf16x3
   operator with update-mode refinement and the sampled certificate, under
   ``torch.profiler`` (the K1b sketch and the triangle K1c's confirms timed
   from it); the certificate, a full float64 sweep of the
   delivered solution and an independent sampled float64 residual (plain
   version, other rows) must all put it at or under 1e-6; then K1b (k =
   500), K2b (k = 1 and 10), K1c (both forms), K7 and K8 against their
   plain versions
   at the path's n = m = 1,000,000, on those 4,096 rows, and K2b timed
   beside the exact K2 on the same points at k = 1 and 10; K8 at the
   sampled certificate's 8,192 x 1,000,000 the same bits twice, checked and
   timed, and ``comp_operand``'s build of the 10⁶ points timed;
7. slice 3: the Laplace kernels K3 (its Hopper tile up to 16 columns, the
   3xTF32 wide kernel past that, at k = 17, 32, 64, 200, 500), K3c
   (general and triangle) and K5 (the tile's triangle form, at k = 1, 3,
   10 and 16) against the float64 plain version at the HIGGS shape (on
   4,096 rows; the wide K3 also at path A's lengthscale) and at ragged
   shapes (n, m not multiples of 128; d = 3, 28, 50, 70; an ARD
   lengthscale), the tile's split product and the wide K3 the same bits
   twice, timed (the wide K3 also at E3's shard pair), the triangle K3c
   beside the general;
   path B, Nyström-PCG on ``LaplaceLinOp`` at the HIGGS-100k shape (k = 1,
   k = 10, k = 1 refined), every logged residual within 1% of a float64 one,
   the sketch through the wide K3 on the operator's kept operand (built
   once in the path);
   path A, ASkotch (SAP) on ``LaplaceLinOp`` at config 4's n = 1,000,000,
   d = 50, and path A', config 4 as written (bf16x3 RBF), both under
   ``torch.profiler`` with sampled metrics, each sampled estimate within
   5 sigma of an independent float64 residual on other rows, path A's row
   oracle through K3's tile every step and its final residual through the
   triangle K3c; then K3, K3c, K1b and
   K1c at the paths' block-oracle shape (10,000 x 1,000,000), checked on
   4,096 rows, the triangle K3c at path A's n = 1,000,000 checked on those
   rows and timed beside the general K3c, and the dense block's peak
   memory;
8. slice 4: path S, ``LstSq(SparseCSRTensor(A), b)`` with LSQR and the
   sparse SkPre sketch on a 2^20 x 1,024 CSR operand with 16 nonzeros a row
   (k = 1, k = 10), every logged rel_res against scipy's float64 one, the
   launches of #9 (``csr_spmv``, ``csr_spmm``) against the path's count, the
   sketch's peak memory; #9 against its float64 plain version at the path's
   shapes (k = 1 and 10 both ways, the sketch) and on two ragged operands
   (rows of 0 to 20,000 entries) at k = 1, 3, 10 and 300 in every schedule
   (each lanes value, every row whole and the long rows in segments),
   float32 and float64, the same bits twice, empty rows 0, timed beside its
   plain version and cuSPARSE (the forward SpMV at every lanes value too,
   the ragged operands and the sketch with every row whole and at segments
   of 256 to 2,048 entries); a k = 1 solve profiled; then
   path C', config 2 as written (dense, SRHT);
9. slice 5, the sharded operators on positions of the one card
   (``make_mesh(devices=[card] * P)``): the exact pair (K4, K6: the
   register tile's pair form) in every family at k = 1, 2, 3, 10, 16
   against float64 (out1 against the plain K1/K3 on (X1, X2, V2), out2 on
   (X2, X1, V1), V1 and V2 apart) at two ragged shapes (n1 > n2 and n1 <
   n2) and at E2's and E3's shard shapes, K4 timed at E2's (k = 1, 10, 16),
   K6 at E3's (k = 1, 10); K4b against float64 and its tier's plain
   version at k = 1, 2, 3, 16 at a ragged shape and at k = 1, 3, 16 at
   E4's shard shape, timed there; path E1, config
   5 as written (``benchmarks/run.py::config5_sharded_krr``: n = 50,000,
   ``ShardedRBFLinOp`` on ``make_mesh()``, ``lanczos_eigsh``, ``hutchinson``,
   Nyström-PCG), profiled; E2, the same on a 4-position ring (the symmetric
   half-ring: K2 and K4) with one float64 refinement round; E3, the Laplace
   half-ring on 3 positions at path B's shape (K5, K6), profiled; on both
   the certified routes take the half-ring (per call P triangle and
   P(P − 1)/2 pair launches, compensated and float64, no general launch),
   from the path's launches and from one call of each; E4, the bf16x3 ring
   at config 6's n = 1,000,000 on 4 positions (K2b, K4b), five matvecs
   timed against K2b on the unsharded operator. Each ring matvec against
   the unsharded operator's and float64, its launches against the
   schedule's count, every logged rel_res against an independent float64
   one, Hutchinson's trace against the exact c·n;
9b. config 8 as written (``benchmarks/run.py::config8_accelerated_sap_
   certified``: n = 100,000, d = 10, bf16x3 RBF, SAP with blocks of
   12,500 and block Nyström of rank 256, true metrics every 25
   iterations): a 50-iteration plain pilot, whose contraction gives the
   accelerated (mu, nu), profiled; 300 plain iterations; 300 accelerated
   ones with two evaluate-mode float64 refinement rounds on the card (K7);
   K1b every iteration, the triangle K1c at every boundary; the refined
   answer certified at 1e-6 by the float64 plain version (neither K7 nor
   K8), the refinement's claim within 1% of it, and the accelerated
   rel_res at 300 below the plain one;
10. each Laplace kernel's share of its bound, of the probe-measured
   ceiling and of the pipes' peak rate, the kernels' JSON line (each
   with its bound, ``bound_ms``), the card line, and the result line last.

It imports nothing of JAX.
"""

import contextlib
import json
import math
import os
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
    "wide": "rlaopt_tpu_torch/csrc/gram_wide.cu",
    "tile": "rlaopt_tpu_torch/csrc/gram_tile.cuh",
    "comp": "rlaopt_tpu_torch/csrc/gram_comp.cu",
    "laplace": "rlaopt_tpu_torch/csrc/gram_laplace.cu",
    "tier": "rlaopt_tpu_torch/csrc/gram_tier.cu",
    "spmv": "rlaopt_tpu_torch/csrc/spmv.cu",
    "pair": "rlaopt_tpu_torch/csrc/gram_pair.cu",
    "probes": "rlaopt_tpu_torch/csrc/probes.cu",
}
PALLAS = "rlaopt_tpu/ops/kernel_pallas.py"
VALUE64 = "rlaopt_tpu/ops/kernel_value64.py"
LANED = "rlaopt_tpu/sparse/laned.py"
# K1 and K2 are held to the exact f32 tier's contract with room for fp32
# atomics; K1c, K3c, K7, K8 and the certified pairs work in float64, so they
# are held to 1e-10 of the float64 plain version.
K_BOUND, COMP_BOUND = 2e-5, 1e-10
# K1b and K2b against the plain version of their tier: the same bf16
# roundings, so only the order of the f32 sums and expf differ. Where the
# one-pass tier re-rounds float32 kernel values to bf16 (the "fast"
# contraction at k > 16, the mirror rows at k >= 3), a value that differs
# from the plain version's in its last float bit now and then rounds the
# other way, 2^-8 of that product: held to 5e-4 there.
TIER_BOUND, REROUND_BOUND = 1e-5, 5e-4


def reround_bound(V, ref, c: float) -> float:
    """The re-rounded product's bound where it depends on the data: one
    bf16 step moves an output by at most c·2^-8·|v| (kernel values below
    1), and two such steps in one output row are allowed, relative to
    max|ref|. At the HIGGS width (d = 28) one step is large against
    max|ref| of a 700-row sum: K4b's mirror reached 8.4e-4 of it over 21
    draws of V on an H100, one step each time, above REROUND_BOUND."""
    return 2 * c * 2.0**-8 * V.abs().max().item() / ref.abs().max().item()


def reround_steps(K, V, got, ref, c: float):
    """Whether the one-pass mirror's largest error, ``got − ref`` of
    ``c·bf16(K)ᵀ @ bf16(V)``, is re-rounding: returns the error and, of
    the sums of at most two steps c·(K′ − bf16(K))·bf16(v) of its output's
    column, the nearest and what remains of the error (all relative to
    max|ref|). A step's K is within 4 float32 ulps of a bf16 rounding
    boundary and K′ its other bf16 neighbour."""
    import torch

    err = got - ref
    j, col = divmod(int(err.abs().argmax()), err.shape[1])
    Kj = K[:, j]
    Kb = Kj.bfloat16().float()
    v = V[:, col].bfloat16().float()
    steps = []
    for way in (-float("inf"), float("inf")):
        Kp = Kj
        for _ in range(4):
            Kp = torch.nextafter(Kp, torch.full_like(Kp, way))
            flip = Kp.bfloat16().float() - Kb
            steps += (c * flip * v)[flip != 0].tolist()
    e, scale = err[j, col].item(), ref.abs().max().item()
    sums = [0.0] + sorted(set(steps))
    best = min((a + b for i, a in enumerate(sums) for b in sums[i:]), key=lambda t: abs(e - t))
    return e / scale, best / scale, abs(e - best) / scale
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
# No kernel here puts work on the FP64 tensor cores (67 TFLOP/s); work
# there would count at that peak ("fp64_tc"), so that no share reads over
# 100%. K1 and K3 past 16 columns contract on the TF32 tensor cores, 495
# TFLOP/s dense on the data sheet ("tf32_tc").
PEAK = {"fp32": 67e12, "fp64": 34e12, "fp64_tc": 67e12, "bf16_tc": 989e12,
        "tf32_tc": 495e12, "sfu": 16 * 132 * 1.98e9}
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
# The kernels redesigned for Hopper, whose registers and spills the
# build's -Xptxas -v log reports (the `registers` line and their JSON
# entries): the CUDA function names, by wrapper (the float64 tile's forms
# by family and V's type, comp_wrapper).
REGISTERS_OF = {"gram_matmat": ("tile_forward", "gram_wide_tf32"),
                "gram_matvec_symmetric": ("tile_triangle",),
                "laplace_matmat": ("gram_wide_tf32",),
                "gram_pair": ("tile_pair",), "laplace_pair": ("tile_pair",),
                "gram_matvec_symmetric_tier": ("gram_tier_symmetric",),
                "gram_matmat_tier": ("gram_tier_forward", "gram_tier_wide"),
                "gram_pair_tier": ("gram_tier_pair",),
                "gram_matvec_symmetric_comp": ("gram_comp_symmetric",),
                "gram_matvec_symmetric_f64": ("gram_comp_symmetric",),
                "gram_matmat_comp": ("gram_comp_forward",),
                "laplace_matmat_comp": ("gram_comp_forward",),
                "gram_matmat_f64": ("gram_comp_forward",),
                "gram_pair_comp": ("gram_comp_pair",), "gram_pair_f64": ("gram_comp_pair",),
                "csr_spmv": ("csr_spmm_lanes",),
                "csr_spmm": ("csr_spmm_lanes", "csr_spmm_wide", "csr_spmm_sum_segments"),
                "laplace_matmat_narrow": ("tile_forward",),
                "laplace_matvec_symmetric": ("tile_triangle",),
                "probe_l1": ("probe_l1",), "probe_elem": ("probe_chain",),
                "probe_exp_chain": ("probe_chain",), "probe_vmem_chain": ("probe_chain",)}
REDESIGNED = tuple(dict.fromkeys(f for fs in REGISTERS_OF.values() for f in fs))
COMP_KERNELS = ("gram_matmat_comp", "gram_matvec_symmetric_comp", "laplace_matmat_comp",
                "gram_pair_comp")
F64_KERNELS = ("gram_matmat_f64", "gram_matvec_symmetric_f64", "gram_pair_f64")
TIER_KERNELS = ("gram_matmat_tier", "gram_matvec_symmetric_tier", "gram_pair_tier")
PAIR_KERNELS = ("gram_pair", "gram_pair_tier", "laplace_pair", "gram_pair_comp",
                "gram_pair_f64")
CSR_KERNELS = ("csr_spmv", "csr_spmm")
# The ceiling probes (rlaopt_tpu_torch/ops/probes.py), by wrapper: the TPU
# probe each replaces (the line of its def) and the SPECS names it runs at.
PROBES = {
    "probe_l1": ("bench.py:146", ("vpu_peak", "bcast_256x256", "bcast_512x1024",
                                  "bcast_256x1024")),
    "probe_vmem_chain": ("bench.py:215", ("exp_peak", "epilogue_bound")),
    "probe_elem": ("benchmarks/vpu_probe_study.py:125", ("elem_256x256", "elem_512x1024")),
    "probe_exp_chain": ("benchmarks/exp_probe_study.py:116", ("exp_chain_512x1024",
                                                              "exp_chain_256x256")),
}
# Operations a probe event takes by unit, as bound_ms counts them (an
# absolute value or a negation is an operand modifier and not counted, an
# exp is one SFU operation): the L1 pair and the elementwise step, a
# subtraction and an add; the exp chain's step a subtraction and the exp;
# make_exp_peak's a multiplication, the exp and the sum's add;
# make_epilogue_bound's two subtractions, the exp, a multiplication and an
# add.
PROBE_OPS = {"l1": {"fp32": 2}, "elem": {"fp32": 2}, "exp_chain": {"fp32": 1, "sfu": 1},
             "exp": {"fp32": 2, "sfu": 1}, "epilogue": {"fp32": 4, "sfu": 1}}
# Timings of the ceilings phase: at least this long each (ms), median of 3.
PROBE_TIMING_MS = 50.0


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
    for the contraction, except K1 and K3 past 16 columns (``gram_matmat``
    and ``laplace_matmat`` at k > 16, float32), which contract on the TF32
    tensor cores in three passes (hi·hi, hi·lo, lo·hi: 6k operations a
    value, ``PEAK["tf32_tc"]``), their distance (squared, or K3's L1 at 2
    operations a feature) and exponential counted once a value as for any
    other kernel (the kernel evaluates each value once per 128 output
    columns): 60.6 ms at 100k², k = 500, for either. The
    triangle kernels (a name that holds
    "symmetric": K2, K2b, K5, K7 and K1c's triangle form,
    ``gram_matvec_symmetric_comp``) evaluate each
    of the n^2/2 values of a pair of tiles once and contract it both ways;
    the pair kernels each of the n·m values once, contracted both ways (4k),
    reading V1 (n, k) besides V2 and writing out2 (m, k) besides out1. The
    float64 tile's outputs take 8 bytes an entry: K1c's and K3c's (hi, lo),
    K7's and K8's float64, the certified pairs' float64 sums; its V 4
    (float32) or 8 bytes (K7, K8, ``gram_pair_f64``).
    The tiers: the cross term on the tensor cores (2 operations per feature
    of d, per pass: :func:`tier_tc_ops`), three float32 operations and the
    exponential (SFU) of epilogue per value, the
    contraction in float32 up to 16 columns and on the tensor cores (per
    pass) past that; their points are read as d bf16 parts (two with
    bf16x3) and a float32 norm each. The CSR product (``csr_spmv``,
    ``csr_spmm``; n rows, m columns, ``nnz`` nonzeros, values of type ``cd``,
    float32 by default): each nonzero's index and value, the int64 indptr,
    X (m, k) and Y (n, k) once; an FMA per nonzero and column. No kernel
    here runs on the FP64 tensor cores; work there would count at
    ``PEAK["fp64_tc"]``."""
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
        nbytes = 4 * (n + (0 if sym else m)) * d + vb * m * k + 8 * n * k
        if pair:
            nbytes += vb * n * k + 8 * m * k
    elif kernel in TIER_KERNELS:
        passes = 3 if cd == "bf16x3" else 1
        ops["bf16_tc"] = tier_tc_ops(values, contraction, d, k, cd)
        ops["fp32"] = values * 3 + (contraction if k <= 16 else 0)
        parts = 2 * d * (2 if passes == 3 else 1) + 4
        nbytes = parts * (n + (0 if sym else m)) + 4 * m * k + 4 * n * k + vk
    elif kernel in ("gram_matmat", "laplace_matmat") and k > 16:
        ops["fp32"] = values * per_feature * d
        ops["tf32_tc"] = 3 * contraction
        nbytes = 4 * (n + m) * d + 4 * m * k + 4 * n * k
    else:
        ops["fp32"] = values * per_feature * d + contraction
        nbytes = 4 * (n + (0 if sym else m)) * d + 4 * m * k + 4 * n * k + vk
    t_ops = max(v / PEAK[unit] for unit, v in ops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def tier_tc_ops(values, contraction, d, k, cd):
    """The tiers' tensor-core operations: the cross term (2 per feature of
    d and pass) and, past 16 columns, the contraction (per pass)."""
    passes = 3 if cd == "bf16x3" else 1
    return values * 2 * d * passes + (contraction * passes if k > 16 else 0)


def probe_bound_ms(spec: dict, instances: int = 1, cd: str = "float32"):
    """``(ms, "bytes" or "operations")`` of one call of a ceiling probe at
    its TPU probe's shapes (``ops.probes.SPECS``) with ``instances``
    instances: its events times ``PROBE_OPS`` over the unit's peak (float64
    for the L1 probe in float64), or X and Y read once and the output
    written once over the HBM rate, the larger."""
    from rlaopt_tpu_torch.ops import probes

    ev = probes.events(spec, instances)
    ops = dict(PROBE_OPS[spec["kind"]])
    if cd == "float64":
        ops = {"fp64": ops.pop("fp32")}
    t_ops = max(ev * v / PEAK[unit] for unit, v in ops.items())
    vb = 8 if cd == "float64" else 4
    if spec["kind"] == "l1":
        elems = instances * (spec["nb"] * spec["fb"] * (spec["tm"] + spec["tn"])
                             + spec["tm"] * spec["tn"])
    else:
        elems = 3.0 * spec["grid"] * spec["tm"] * spec["tn"] * instances
    t_bytes = elems * vb / HBM_BYTES_PER_S
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


# The float64 tile's three forms (csrc/gram_comp.cu) and their finishing
# pass serve the wrappers of K1c, K3c, K7, K8 and the certified pairs, told
# apart by the form (the kernel's name; the finishing pass's last template
# argument, 0 triangle, 1 forward, 2 pair, absent in builds before the
# forward and pair forms), V's type ("d" in ptxas_report's keys, "double"
# in a demangled name) and the family (the forward form's first argument,
# LAPLACE_CODE: K3c).
COMP_FNS = ("gram_comp_symmetric", "gram_comp_forward", "gram_comp_pair", "gram_comp_finish")
COMP_FORMS = {"gram_comp_symmetric": 0, "gram_comp_forward": 1, "gram_comp_pair": 2}


def comp_wrapper(fn: str, args: str) -> str:
    """The wrapper of a float64-tile instantiation ``fn<args>`` (as in
    ``"0, 4, double"``)."""
    parts = [a.strip(" <>") for a in args.split(",")]
    if fn == "gram_comp_finish":
        vt, form = parts[0], int(parts[1]) if len(parts) > 1 else 0
    else:
        vt, form = parts[-1], COMP_FORMS[fn]
    f64 = vt in ("d", "double")
    if form == 0:
        return "gram_matvec_symmetric_f64" if f64 else "gram_matvec_symmetric_comp"
    if form == 2:
        return "gram_pair_f64" if f64 else "gram_pair_comp"
    if f64:
        return "gram_matmat_f64"
    laplace = fn != "gram_comp_finish" and parts[0] == str(LAPLACE_CODE)
    return "laplace_matmat_comp" if laplace else "gram_matmat_comp"


# The register tile's three forms and the 3xTF32 wide kernel serve the
# squared-distance wrappers (K1, K2, K4) and the Laplace ones (K3, K5, K6),
# told apart by the family, their first template argument (LAPLACE_CODE).
TILE_FORMS = {"tile_forward": ("gram_matmat", "laplace_matmat_narrow"),
              "tile_triangle": ("gram_matvec_symmetric", "laplace_matvec_symmetric"),
              "tile_pair": ("gram_pair", "laplace_pair"),
              "gram_wide_tf32": ("gram_matmat", "laplace_matmat")}


def tile_wrapper(fn: str, args: str) -> str:
    """The wrapper of a register-tile instantiation ``fn<args>``."""
    family = args.strip(" <>").split(",")[0].strip()
    return TILE_FORMS[fn][family == str(LAPLACE_CODE)]


def registers_of(kname: str, registers: dict) -> dict:
    """The entries of ``ptxas_report`` that belong to the wrapper ``kname``."""
    mine = {}
    for key, r in registers.items():
        fn, _, args = key.partition("<")
        if fn in REGISTERS_OF.get(kname, ()) and (
                fn not in COMP_FNS or comp_wrapper(fn, args) == kname) and (
                fn not in TILE_FORMS or tile_wrapper(fn, args) == kname):
            mine[key] = r
    return mine


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


# The narrow kernel of builds before the float64 tile's forward form
# (gram_matmat_narrow<KIND, KC, MODE>, in old profiles): the family first
# (LAPLACE is 4), the Mode last (COMP 1, F64 2).
_NARROW = {1: "gram_matmat_comp", 2: "gram_matmat_f64"}
_LAPLACE = {"gram_matmat_comp": "laplace_matmat_comp"}
LAPLACE_CODE = 4


# Kernels of their own, by name (their template arguments do not select the
# group): K2b, K1b's forward strip and wide kernel, K4b; the float64 tile's
# by form, family and V's type (comp_wrapper).
_OWN = {"gram_tier_symmetric": "gram_matvec_symmetric_tier",
        "gram_tier_forward": "gram_matmat_tier", "gram_tier_wide": "gram_matmat_tier",
        "gram_tier_pair": "gram_pair_tier"}
# Kernels whose names hold no gram_ prefix: the probes, and K3's tile in its
# two forms as earlier builds named them (K3, K5); the register tile's forms
# and the wide kernel by family (TILE_FORMS).
_OWN_NAMED = {"laplace_forward": "laplace_matmat_narrow",
              "laplace_triangle": "laplace_matvec_symmetric", "probe_l1": "probe_l1",
              "probe_chain": "probe_chain"}


def _kernel_group(name: str) -> str:
    if "sum_splits" in name:
        return "sum_splits"
    if "csr_spmm" in name:
        return "csr_spmm"
    m = re.search(r"(tile_forward|tile_triangle|tile_pair|gram_wide_tf32)<([^>]*)>", name)
    if m:
        return tile_wrapper(m.group(1), m.group(2))
    for own, group in _OWN_NAMED.items():
        if own in name:
            return group
    m = re.search(r"(gram_\w+)(?:<([^>]*)>)?", name)
    if m is None:
        return "other"
    if m.group(1) in COMP_FNS:
        return comp_wrapper(m.group(1), m.group(2) or "")
    if m.group(1) in _OWN:
        return _OWN[m.group(1)]
    if m.group(2) is None:
        return "other"
    args = [a.strip() for a in m.group(2).split(",")]
    # gram_matmat_narrow<KIND, KC, MODE> ends in MODE
    try:
        family = int(args[0])
        group = _NARROW.get(int(args[-1]), "other")
    except (ValueError, IndexError):
        return "other"
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
    profile = device_breakdown(prof) if prof else {}
    # the sketch (K1b, k = 500) and the confirms (the triangle K1c) at the
    # path's n, a launch each from the profile
    profiled_entries(timings, profile.get("kernels", {}), used, "config 6", N6, D,
                     [("gram_matmat_tier", RANK, "bf16x3"), ("gram_matvec_symmetric_comp", 1, None),
                      ("gram_matvec_symmetric_f64", 1, None)])
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
    check(used["gram_matvec_symmetric_comp"] > 0 and used["gram_matmat_comp"] == 0,
          "config 6's confirms ran through K1c's triangle form")
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
    # K8 at the sampled certificate's shape (8,192 rows against the 10⁶
    # points) on a random right-hand side: the same bits twice, checked on
    # 1,024 of its rows, timed; and the float64 operand each K8 call builds
    # of the 10⁶ points
    X8 = X[torch.as_tensor(sampled_rows(N6, 8192, 7), device=dev)]
    V8 = torch.randn((N6, 1), generator=torch.Generator(device=dev).manual_seed(8), device=dev,
                     dtype=torch.float64)
    certify = (lambda: kernel_cuda.gram_matmat_f64("rbf", X8, X, V8, ls))
    one, two = certify(), certify()
    torch.cuda.synchronize()
    what = f"config 6 certificate n=8192 m={N6} d={D} k=1"
    check(torch.equal(one, two), f"gram_matmat_f64 {what}: the same bits twice")
    compare("gram_matmat_f64", one[:1024],
            kernel_plain.gram_matmat_f64("rbf", X8[:1024], X, V8, ls, row_block=256),
            f"{what} rows 1024", COMP_BOUND)
    del one, two
    ms = cuda_ms(certify, reps=3)
    timings.setdefault("gram_matmat_f64", []).append(
        timing_entry("gram_matmat_f64", what, ms, None, 8192, N6, D, 1))
    print(f"time gram_matmat_f64 {what}: kernel {ms:.3f} ms, bound "
          f"{timings['gram_matmat_f64'][-1]['bound_ms']:.3f} ms")
    op_ms = cuda_ms(lambda: kernel_cuda.comp_operand(X, ls), reps=3)
    print(f"time comp_operand n={N6} d={D}: {op_ms:.3f} ms")
    del X8, V8
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
            hi, lo = kernel_cuda.gram_matvec_symmetric_comp("rbf", X, V, ls)
            compare("gram_matvec_symmetric_comp", (hi.double() + lo.double())[idx], ref64,
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
        "launches": used, "profile": profile,
    }


def sampled_rows(n: int, s: int, seed: int) -> np.ndarray:
    return np.sort(np.random.default_rng(seed).choice(n, s, replace=False))


def timing_entry(kernel, shape, ms, plain_ms, n, m, d, k, kind="rbf", cd=None, nnz=None,
                 **extra):
    """One timed shape of a kernel, with its bound at that shape."""
    bound, by = bound_ms(kernel, n, m, d, k, kind, cd, nnz)
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "n": n, "m": m, "d": d, "k": k, "kind": kind, "cd": cd, **extra}


def profiled_entries(timings, prof_kernels, used, what, n, d, kernels, kind="rbf"):
    """Per-launch timings of ``kernels`` ((wrapper, k, tier) each) from a
    profiled path: the group's device time over the path's launches of
    that wrapper (the triangle's group holds its finishing pass)."""
    for kname, k, cd in kernels:
        group = prof_kernels.get(kname)
        if not group or not used[kname]:
            continue
        ms = group["ms"] / used[kname]
        timings.setdefault(kname, []).append(timing_entry(
            kname, f"{what} n=m={n} d={d} k={k}" + (f" {cd}" if cd else "")
            + f" (profile: {used[kname]} launches, {group['ms']:.3f} ms)",
            ms, None, n, n, d, k, kind, cd, launches=used[kname]))
        print(f"time {kname} {what} n=m={n} d={d} k={k}: {ms:.3f} ms a launch (profile), "
              f"bound {timings[kname][-1]['bound_ms']:.3f} ms")


def probe_instances(spec: dict, sms: int) -> int:
    """Instances of an L1 probe (``ops.probes.SPECS``) in a timed call: the
    fewest that fill whole rounds of the card's block slots (one 128 x 128
    block an SM), four rounds or more, so that no round runs part full."""
    per = spec["tm"] // 128 * spec["tn"] // 128
    base = sms // math.gcd(sms, per)
    return base * -(-4 * sms // (base * per))


def timed_probe(fn):
    """``(ms a call, calls a timing)``: a pilot call sizes each timing to
    PROBE_TIMING_MS or more; the median of 3 such timings."""
    pilot = cuda_ms(fn, reps=1)
    inner = max(1, int(np.ceil(PROBE_TIMING_MS / pilot)))
    return cuda_ms(fn, reps=3, inner=inner), inner


def sample_smi(fn, seconds=2.0):
    """Run ``fn`` back to back for about ``seconds`` while ``nvidia-smi``
    samples the SM clock (MHz) and power draw (W) every 100 ms; returns
    the samples and the ms a call over that window (CUDA events)."""
    import torch

    pilot = cuda_ms(fn, reps=1)
    calls = max(1, int(seconds * 1e3 / pilot))
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)
        ms = cuda_ms(fn, reps=1, warm=False, inner=calls)
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    samples = []
    for line in out.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2:
            try:
                samples.append((float(parts[0]), float(parts[1])))
            except ValueError:
                continue
    return samples, ms


def ceilings(dev, compare, timings):
    """Phase 2b: the ceiling probes (TPU #10-#13). Each against its plain
    version at a small size, then, counted, each at its TPU probe's shapes,
    timed and held against its plain version there too; the float32 L1
    probe also in float64, and once more for about 2 s with ``nvidia-smi``
    sampling the SM clock and power draw. Returns the measured rates
    (events a second, by the TPU probes' count), the samples, the pipes'
    peak rates for the L1 pair at the median SM clock and the probes'
    launches."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda, probes

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(20)
    # The L1 probe sums in the plain version's order (block by block,
    # feature by feature) and the elementwise chain does its operations:
    # the same bits (1e-6 is room, not a measured gap). The exp chains and
    # sums take __expf, a few float32 ulps from torch.exp, each chain step
    # contracting an error (its derivative is at most 1 in size): 1e-5.
    bounds = {"l1": {"float32": 1e-6, "float64": 1e-14}, "elem": 1e-6, "exp_chain": 1e-5,
              "exp": 1e-5, "epilogue": 1e-5}
    for dt in (torch.float32, torch.float64):
        cd = str(dt)[6:]
        X = torch.randn((3, 2, 256, 64), generator=gen, device=dev, dtype=dt)
        Y = torch.randn((3, 2, 64, 384), generator=gen, device=dev, dtype=dt)
        compare("probe_l1", probes.probe_l1(X, Y), probes.probe_l1_plain(X, Y),
                f"3 instances nb=2 tm=256 tn=384 fb=64 {cd}", bounds["l1"][cd])
    X, Y = (torch.randn((512, 1024), generator=gen, device=dev) for _ in range(2))
    U, U2 = (torch.rand((512, 1024), generator=gen, device=dev) for _ in range(2))
    compare("probe_elem", probes.probe_elem(X, Y), probes.probe_elem_plain(X, Y),
            "512x1024 normal", bounds["elem"])
    compare("probe_exp_chain", probes.probe_exp_chain(X, Y), probes.probe_exp_chain_plain(X, Y),
            "512x1024 normal", bounds["exp_chain"])
    for step in ("exp", "epilogue"):
        compare("probe_vmem_chain", probes.probe_vmem_chain(U, U2, step),
                probes.probe_vmem_chain_plain(U, U2, step), f"{step} 512x1024 uniform",
                bounds[step])
    del X, Y, U, U2

    probes.reset_launch_counts()
    rates, fns = {}, {}
    for kname, (tpu, names) in PROBES.items():
        for sname in names:
            spec = probes.SPECS[sname]
            for cd in (("float32", "float64") if sname == "vpu_peak" else ("float32",)):
                dt = torch.float32 if cd == "float32" else torch.float64
                draw = torch.randn if spec["data"] == "normal" else torch.rand
                if spec["kind"] == "l1":
                    inst = probe_instances(spec, sms)
                    X = draw((inst, spec["nb"], spec["tm"], spec["fb"]), generator=gen,
                             device=dev, dtype=dt)
                    Y = draw((inst, spec["nb"], spec["fb"], spec["tn"]), generator=gen,
                             device=dev, dtype=dt)
                    fn = (lambda X=X, Y=Y: probes.probe_l1(X, Y))
                    plain = (lambda X=X, Y=Y: probes.probe_l1_plain(X, Y))
                    bound_err = bounds["l1"][cd]
                else:
                    inst = 1
                    shape = (spec["grid"] * spec["tm"], spec["tn"])
                    X = draw(shape, generator=gen, device=dev)
                    Y = draw(shape, generator=gen, device=dev)
                    fn, plain = {
                        "elem": (lambda X=X, Y=Y: probes.probe_elem(X, Y),
                                 lambda X=X, Y=Y: probes.probe_elem_plain(X, Y)),
                        "exp_chain": (lambda X=X, Y=Y: probes.probe_exp_chain(X, Y),
                                      lambda X=X, Y=Y: probes.probe_exp_chain_plain(X, Y)),
                        "exp": (lambda X=X, Y=Y: probes.probe_vmem_chain(X, Y, "exp"),
                                lambda X=X, Y=Y: probes.probe_vmem_chain_plain(X, Y, "exp")),
                        "epilogue": (
                            lambda X=X, Y=Y: probes.probe_vmem_chain(X, Y, "epilogue"),
                            lambda X=X, Y=Y: probes.probe_vmem_chain_plain(X, Y, "epilogue")),
                    }[spec["kind"]]
                    bound_err = bounds[spec["kind"]]
                ms, inner = timed_probe(fn)
                what = f"{sname} {cd}" + (f" x{inst} instances" if inst > 1 else "")
                lib_ms = None
                if spec["kind"] == "l1":
                    # one PyTorch call computes the same L1 matrix: torch.cdist
                    # (p = 1) of the operands as points of nb * fb features,
                    # reshaped outside the timing; held to the probe at the
                    # round-off of a sum of up to 4,096 terms in another order
                    # (~sqrt(4096) 2^-24 typical, 1e-4 of max|ref| float32)
                    Xp = X.permute(0, 2, 1, 3).reshape(inst, spec["tm"], -1).contiguous()
                    Yp = Y.permute(0, 3, 1, 2).reshape(inst, spec["tn"], -1).contiguous()
                    lib_ms = cuda_ms(lambda: torch.cdist(Xp, Yp, p=1), reps=3)
                    got, lib = fn(), torch.cdist(Xp, Yp, p=1)
                    rel = ((got.double() - lib.double()).abs().max()
                           / lib.double().abs().max()).item()
                    print(f"library torch.cdist(p=1) {what}: {lib_ms:.4f} ms, probe vs it "
                          f"{rel:.3e} of max|ref|")
                    check(rel <= {"float32": 1e-4, "float64": 1e-12}[cd],
                          f"torch.cdist(p=1) computes probe_l1's function at {what}")
                    del Xp, Yp, got, lib
                # the plain version once at every timed shape, timed, and
                # the probe held against it there
                held = {}
                p_ms = cuda_ms(lambda: held.setdefault("ref", plain()), reps=1, warm=False)
                compare(kname, fn(), held.pop("ref"), f"{what} (timed shape)", bound_err)
                ev = probes.events(spec, inst)
                rate = ev / (ms * 1e-3)
                bound, by = probe_bound_ms(spec, inst, cd)
                timings.setdefault(kname, []).append({
                    "shape": what, "ms": ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                    "library_ms": lib_ms, "tpu": spec["tpu"], "number": spec["number"],
                    "instances": inst, "events": ev, "rate_per_s": rate, "calls_a_timing": inner,
                    "kind": spec["kind"], "cd": cd})
                rates[f"{sname} {cd}"] = rate
                fns[f"{sname} {cd}"] = fn
                print(f"ceiling {kname} #{spec['number']} {what}: {ms:.4f} ms a call "
                      f"({inner} calls a timing), {rate / 1e12:.4f} T events/s, bound "
                      f"{bound:.4f} ms ({by}), {bound / ms:.1%} of it; plain {p_ms:.3f} ms")
                del X, Y
    samples, ms = sample_smi(fns["vpu_peak float32"])
    check(len(samples) > 0, "nvidia-smi sampled the SM clock and power draw")
    clocks = sorted(c for c, _ in samples)
    watts = sorted(w for _, w in samples)
    ev = probes.events(probes.SPECS["vpu_peak"], timings["probe_l1"][0]["instances"])
    smi = {"probe": "vpu_peak float32", "samples": len(samples), "ms_a_call": ms,
           "rate_per_s": ev / (ms * 1e-3),
           "sm_clock_mhz": {"min": clocks[0], "median": statistics.median(clocks),
                            "max": clocks[-1]},
           "power_w": {"min": watts[0], "median": statistics.median(watts), "max": watts[-1]}}
    print("ceilings smi " + json.dumps(smi))
    used = probes.launch_counts()
    for kname in PROBES:
        check(used[kname] > 0, f"the ceilings phase launched {kname}")
    # the L1 pair rate the pipes allow at the median SM clock, two adds a
    # pair: 128 FP32 and 64 FP64 lanes a clock per SM
    hz = smi["sm_clock_mhz"]["median"] * 1e6
    pipes = {"float32": 128 * sms * hz / 2, "float64": 64 * sms * hz / 2}
    smi["fp32_pairs_per_s"], smi["fp64_pairs_per_s"] = pipes["float32"], pipes["float64"]
    print(f"ceilings: L1 pairs {rates['vpu_peak float32'] / 1e12:.4f} T/s float32 "
          f"({rates['vpu_peak float32'] / pipes['float32']:.1%} of the FP32 pipes' "
          f"{pipes['float32'] / 1e12:.4f} T pairs/s at the median SM clock), "
          f"{rates['vpu_peak float64'] / 1e12:.4f} T/s float64 "
          f"({rates['vpu_peak float64'] / pipes['float64']:.1%} of the FP64 pipes' "
          f"{pipes['float64'] / 1e12:.4f}); exp {rates['exp_peak float32'] / 1e12:.4f} T/s, "
          f"epilogue {rates['epilogue_bound float32'] / 1e12:.4f} T values/s")
    rec = {"rates": rates, "pipes": pipes, "smi": smi,
           "launches": {**kernel_cuda.launch_counts(), **used}}
    print("ceilings " + json.dumps(rec))
    return rec


def ceiling_shares(timings, rates, pipes):
    """Each Laplace row's share of ``bound_ms``, of the probe-measured
    ceiling and of the pipes' peak rate: its pairs (n·m·d, n²/2·d for the
    triangles) over the L1 probe's rate (float64 for the compensated
    kernels), kept in the entry as ``ceiling_ms``, and over the FP32 (FP64)
    pipes' pair rate at the SM clock read during the probe, as
    ``pipe_ms``. K3 past 16 columns (``laplace_matmat``) has no such row:
    its time goes to the TF32 contraction (``bound_ms``), not the L1 pair."""
    for kname in ("laplace_matmat_narrow", "laplace_matmat_comp",
                  "gram_matvec_symmetric_comp", "laplace_matvec_symmetric", "laplace_pair",
                  "gram_pair_comp"):
        for e in timings.get(kname, []):
            if e.get("kind") != "laplace" or not e.get("ms"):
                continue
            n, m, d = e["n"], e["m"], e["d"]
            pairs = (n * n / 2 if "symmetric" in kname else float(n) * m) * d
            cd = "float64" if kname in COMP_KERNELS else "float32"
            e["ceiling_ms"] = pairs / rates[f"vpu_peak {cd}"] * 1e3
            e["pipe_ms"] = pairs / pipes[cd] * 1e3
            print(f"share {kname} {e['shape']}: {e['bound_ms'] / e['ms']:.1%} of bound_ms "
                  f"({e['bound_by']}), {e['ceiling_ms'] / e['ms']:.1%} of the measured {cd} "
                  f"L1 ceiling ({e['ceiling_ms']:.3f} ms), {e['pipe_ms'] / e['ms']:.1%} of the "
                  f"FP{cd[5:]} pipes' peak rate ({e['pipe_ms']:.3f} ms)")


# K3 past 16 columns (K1's 3xTF32 kernel with the L1 step) is checked at
# these widths: one n-tile of 8 columns and a ragged one (17), 64 output
# columns a block (32, 64), 128 (200, path B's 500).
WIDE_KS = (17, 32, 64, 200, RANK)


def laplace_kernels(dev, X, compare, timings):
    """K3 (its tile up to 16 columns, the 3xTF32 wide kernel past that),
    K3c (general and triangle) and K5 (the tile's triangle form) against
    the float64 plain version at the HIGGS shape (lengthscale 32, on 4,096
    rows of each full product; K5 at k = 1, 10 and 16; K3 past 16 at k =
    17, 32, 64, 200, 500, also at path A's lengthscale 8, on the operand an
    operator keeps, the same bits twice and the same bits on an operand
    built in the call) and at ragged shapes: n and m not multiples of 128,
    d = 3, 28, 50 and 70, a scalar and an ARD lengthscale (K5 at k = 1, 3,
    10 and 16); the tile's split product the same bits twice. Then each
    kernel and its plain version timed at the HIGGS shape (K5 and the wide
    K3 on the operand an operator keeps; the wide K3 also at E3's shard
    pair, 33,334 points a side, k = 500, checked there on 4,096 rows) and
    the triangle K3c beside the general. The plain versions sum distances
    directly, seconds a call here: one timed run each, without a warm-up."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain

    n = X.shape[0]
    idx = torch.as_tensor(sampled_rows(n, 4096, 5), device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    Vs = {k: torch.randn((n, k), generator=gen, device=dev) for k in (1, 10, 16) + WIDE_KS}
    cols, at = {}, 0
    for k in Vs:
        cols[k] = slice(at, at + k)
        at += k
    t0 = time.perf_counter()
    ref = kernel_plain.gram_matmat_f64("laplace", X[idx], X, torch.cat(list(Vs.values()), 1),
                                       LS_B, row_block=512)
    torch.cuda.synchronize()
    print(f"laplace float64 reference, 4096 rows: {time.perf_counter() - t0:.3f} s")
    shape = f"rows 4096 of n=m={n} d={D}"
    for k in (1, 10, 16):
        compare("laplace_matmat_narrow", kernel_cuda.laplace_matmat(X, X, Vs[k], LS_B)[idx],
                ref[:, cols[k]], f"{shape} k={k}", K_BOUND)
    # past 16 columns on the operand an operator keeps (path B's sketch), and
    # at path A's lengthscale; no atomics: the same bits twice, and on an
    # operand built in the call
    XT = kernel_cuda.tile_operand(X, LS_B)
    kept = (lambda: (XT, XT))
    Wa, cols_a = concat_columns({k: Vs[k] for k in WIDE_KS})
    ref_a = kernel_plain.gram_matmat_f64("laplace", X[idx], X, Wa, LS_A, row_block=512)
    del Wa
    for k in WIDE_KS:
        got = kernel_cuda.laplace_matmat(X, X, Vs[k], LS_B, 1.0, kept)
        compare("laplace_matmat", got[idx], ref[:, cols[k]], f"{shape} k={k}", K_BOUND)
        if k in (17, RANK):
            again = kernel_cuda.laplace_matmat(X, X, Vs[k], LS_B, 1.0, kept)
            built = kernel_cuda.laplace_matmat(X, X, Vs[k], LS_B)
            torch.cuda.synchronize()
            check(torch.equal(got, again) and torch.equal(got, built),
                  f"laplace_matmat k={k}: the same bits twice, and on an operand built in "
                  "the call")
            del again, built
        del got
        compare("laplace_matmat", kernel_cuda.laplace_matmat(X, X, Vs[k], LS_A)[idx],
                ref_a[:, cols_a[k]], f"{shape} k={k} lengthscale {LS_A}", K_BOUND)
    del ref_a
    for k in (1, 10, 16):
        compare("laplace_matvec_symmetric",
                kernel_cuda.laplace_matvec_symmetric(X, Vs[k], LS_B)[idx],
                ref[:, cols[k]], f"{shape} k={k}", K_BOUND)
    for k in (1, 10):
        hi, lo = kernel_cuda.gram_matvec_symmetric_comp("laplace", X, Vs[k], LS_B)
        compare("gram_matvec_symmetric_comp", (hi.double() + lo.double())[idx], ref[:, cols[k]],
                f"laplace {shape} k={k} (hi+lo)", COMP_BOUND)
    hi, lo = kernel_cuda.laplace_matmat_comp(X, X, Vs[1], LS_B)
    compare("laplace_matmat_comp", (hi.double() + lo.double())[idx], ref[:, cols[1]],
            f"{shape} k=1 (hi+lo)", COMP_BOUND)
    del ref, hi, lo
    A1, A2, W7, S7 = (torch.from_numpy(a).to(dev) for a in ragged_data())
    ref = kernel_plain.gram_matmat_f64("laplace", A1, A2, W7, 1.3, 0.9)
    rel = compare("laplace_matmat_narrow", kernel_cuda.laplace_matmat(A1, A2, W7, 1.3, 0.9),
                  ref, "n=1000 m=777 d=3 k=7", K_BOUND)
    hi, lo = kernel_cuda.laplace_matmat_comp(A1, A2, W7, 1.3, 0.9)
    rel_c = compare("laplace_matmat_comp", hi.double() + lo.double(), ref,
                    "n=1000 m=777 d=3 k=7 (hi+lo)", COMP_BOUND)
    check(rel_c <= rel, "laplace_matmat_comp ragged no worse than laplace_matmat")
    ref_s = kernel_plain.gram_matmat_f64("laplace", A1, A1, S7, 1.3, 0.9)
    compare("laplace_matvec_symmetric", kernel_cuda.laplace_matvec_symmetric(A1, S7, 1.3, 0.9),
            ref_s, "n=1000 d=3 k=7", K_BOUND)
    hi, lo = kernel_cuda.gram_matvec_symmetric_comp("laplace", A1, S7, 1.3, 0.9)
    compare("gram_matvec_symmetric_comp", hi.double() + lo.double(), ref_s,
            "laplace n=1000 d=3 k=7 (hi+lo)", COMP_BOUND)
    # K3's tile at ragged shapes: every k it takes the kernel at (1, 2, 4,
    # 8, 16 columns a block) at d = 28 and 50 (a last chunk of 12 and 2
    # features), with a scalar and an ARD lengthscale
    rng, rng5 = np.random.default_rng(31), np.random.default_rng(37)
    for n1, m1, d in ((1000, 777, 28), (1000, 777, 50), (300, 1300, 50)):
        P1 = torch.from_numpy(rng.standard_normal((n1, d)).astype(np.float32)).to(dev)
        P2 = torch.from_numpy(rng.standard_normal((m1, d)).astype(np.float32)).to(dev)
        ard = torch.linspace(0.6, 1.4, d, device=dev) * (2 * d / np.pi**0.5)
        for k in (1, 2, 3, 5, 16):
            V = torch.from_numpy(rng.standard_normal((m1, k)).astype(np.float32)).to(dev)
            for ls, tag in ((2 * d / np.pi**0.5, "scalar"), (ard, "ARD")):
                compare("laplace_matmat_narrow", kernel_cuda.laplace_matmat(P1, P2, V, ls, 0.9),
                        kernel_plain.gram_matmat_f64("laplace", P1, P2, V, ls, 0.9),
                        f"n={n1} m={m1} d={d} k={k} {tag} lengthscale", K_BOUND)
        # K5, the tile's triangle form, on P1 at every KC it takes
        for k in (1, 3, 10, 16):
            W = torch.from_numpy(rng5.standard_normal((n1, k)).astype(np.float32)).to(dev)
            for ls, tag in ((2 * d / np.pi**0.5, "scalar"), (ard, "ARD")):
                compare("laplace_matvec_symmetric",
                        kernel_cuda.laplace_matvec_symmetric(P1, W, ls, 0.9),
                        kernel_plain.gram_matmat_f64("laplace", P1, P1, W, ls, 0.9),
                        f"n={n1} d={d} k={k} {tag} lengthscale", K_BOUND)
        S = torch.from_numpy(rng.standard_normal((n1, 3)).astype(np.float32)).to(dev)
        hi, lo = kernel_cuda.gram_matvec_symmetric_comp("laplace", P1, S, ard.double(), 0.9)
        compare("gram_matvec_symmetric_comp", hi.double() + lo.double(),
                kernel_plain.gram_matmat_f64("laplace", P1, P1, S, ard.double(), 0.9),
                f"laplace n={n1} d={d} k=3 ARD lengthscale (hi+lo)", COMP_BOUND)
    # the wide K3 at ragged shapes: d = 3, 28, 50 and 70 (one, two and three
    # chunks of 32 features, ragged last ones), every width of WIDE_KS
    rngw = np.random.default_rng(43)
    for n1, m1, d in ((1000, 777, 3), (1000, 777, 28), (300, 1300, 50), (777, 1000, 70)):
        P1 = torch.from_numpy(rngw.standard_normal((n1, d)).astype(np.float32)).to(dev)
        P2 = torch.from_numpy(rngw.standard_normal((m1, d)).astype(np.float32)).to(dev)
        W, cw = concat_columns({k: torch.from_numpy(rngw.standard_normal((m1, k)).astype(
            np.float32)).to(dev) for k in WIDE_KS})
        ard = torch.linspace(0.6, 1.4, d, device=dev) * (2 * d / np.pi**0.5)
        for ls, tag in ((2 * d / np.pi**0.5, "scalar"), (ard, "ARD")):
            refw = kernel_plain.gram_matmat_f64("laplace", P1, P2, W, ls, 0.9)
            for k in WIDE_KS:
                compare("laplace_matmat", kernel_cuda.laplace_matmat(P1, P2, W[:, cw[k]], ls, 0.9),
                        refw[:, cw[k]], f"n={n1} m={m1} d={d} k={k} {tag} lengthscale", K_BOUND)
    # the m axis in runs: the same bits on two calls
    P1 = torch.from_numpy(rng.standard_normal((1000, 50)).astype(np.float32)).to(dev)
    P2 = torch.from_numpy(rng.standard_normal((300_000, 50)).astype(np.float32)).to(dev)
    V = torch.from_numpy(rng.standard_normal((300_000, 3)).astype(np.float32)).to(dev)
    runs = kernel_cuda.tile_splits(1000, 300_000, 3, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    one, two = (kernel_cuda.laplace_matmat(P1, P2, V, 8.0) for _ in range(2))
    torch.cuda.synchronize()
    check(runs > 1 and torch.equal(one, two),
          f"laplace_matmat_narrow in {runs} runs gives the same bits twice")
    compare("laplace_matmat_narrow", one[:256],
            kernel_plain.gram_matmat_f64("laplace", P1[:256], P2, V, 8.0, row_block=256),
            f"rows 256 of n=1000 m=300000 d=50 k=3, {runs} runs", K_BOUND)
    del P1, P2, V, one, two

    # K5's plain version is K3's on (X, X), the same call, and the
    # triangle K3c's the general one's: timed once per k
    plain_ms = {}
    for kernel, k in (("laplace_matmat", RANK), ("laplace_matmat", 17), ("laplace_matmat", 64),
                      ("laplace_matmat_narrow", 1),
                      ("laplace_matmat_narrow", 10), ("laplace_matmat_narrow", 16),
                      ("laplace_matvec_symmetric", 1), ("laplace_matvec_symmetric", 10),
                      ("laplace_matvec_symmetric", 16),
                      ("laplace_matmat_comp", 1), ("laplace_matmat_comp", 10),
                      ("gram_matvec_symmetric_comp", 1), ("gram_matvec_symmetric_comp", 10)):
        V = Vs[k]
        extra = {}
        if kernel == "laplace_matmat_comp":
            ms = cuda_ms(lambda: kernel_cuda.laplace_matmat_comp(X, X, V, LS_B))
            p_ms = cuda_ms(lambda: kernel_plain.gram_matmat_comp(
                "laplace", X, X, V, LS_B, col_block=BLOCK), reps=1, warm=False) if k == 1 else None
            plain_ms[("comp", k)] = p_ms
        elif kernel == "gram_matvec_symmetric_comp":
            ms = cuda_ms(lambda: kernel_cuda.gram_matvec_symmetric_comp("laplace", X, V, LS_B))
            p_ms = plain_ms[("comp", k)]
            extra["general_ms"] = next(t["ms"] for t in timings["laplace_matmat_comp"]
                                       if t["k"] == k and t["n"] == n)
        else:
            if kernel == "laplace_matvec_symmetric":
                # on the operand an operator keeps (path B, E3)
                ms = cuda_ms(lambda: kernel_cuda.laplace_matvec_symmetric(X, V, LS_B, 1.0, XT))
            elif kernel == "laplace_matmat":
                ms = cuda_ms(lambda: kernel_cuda.laplace_matmat(X, X, V, LS_B, 1.0, kept))
            else:
                ms = cuda_ms(lambda: kernel_cuda.laplace_matmat(X, X, V, LS_B))
            if k not in plain_ms and k in (1, 10, RANK):
                plain_ms[k] = cuda_ms(lambda: kernel_plain.gram_matmat(
                    "laplace", X, X, V, LS_B, row_block=BLOCK), reps=1, warm=False)
            p_ms = plain_ms.get(k)
        what = ("laplace " if kernel == "gram_matvec_symmetric_comp" else "") + f"n={n} d={D} k={k}"
        entry = timing_entry(kernel, what, ms, p_ms, n, n, D, k, "laplace", **extra)
        timings.setdefault(kernel, []).append(entry)
        line = (f"time {kernel} {what}: kernel {ms:.3f} ms, plain "
                + (f"{p_ms:.3f} ms" if p_ms is not None else "not timed")
                + f", bound {entry['bound_ms']:.3f} ms")
        if "general_ms" in extra:
            line += f", general K3c {extra['general_ms']:.3f} ms"
        print(line)
    # the wide K3 at E3's shard pair (path B's points in 3 shards), k = 500:
    # the sketch's general calls of the Laplace half-ring
    loc = -(-n // P_LAPLACE)
    X1, X2 = X[:loc], X[loc:2 * loc]
    XT1, XT2 = kernel_cuda.tile_operand(X1, LS_B), kernel_cuda.tile_operand(X2, LS_B)
    V = torch.randn((X2.shape[0], RANK), generator=gen, device=dev)
    got = kernel_cuda.laplace_matmat(X1, X2, V, LS_B, 1.0, lambda: (XT1, XT2))
    i3 = torch.as_tensor(sampled_rows(loc, 4096, 8), device=dev)
    what = f"E3 shards n1={loc} n2={X2.shape[0]} d={D} k={RANK}"
    compare("laplace_matmat", got[i3],
            kernel_plain.gram_matmat_f64("laplace", X1[i3], X2, V, LS_B, row_block=512),
            f"{what} rows 4096", K_BOUND)
    ms = cuda_ms(lambda: kernel_cuda.laplace_matmat(X1, X2, V, LS_B, 1.0, lambda: (XT1, XT2)))
    p_ms = cuda_ms(lambda: kernel_plain.gram_matmat("laplace", X1, X2, V, LS_B, row_block=BLOCK),
                   reps=1, warm=False)
    entry = timing_entry("laplace_matmat", what, ms, p_ms, loc, X2.shape[0], D, RANK, "laplace")
    timings["laplace_matmat"].append(entry)
    print(f"time laplace_matmat {what}: kernel {ms:.3f} ms, plain {p_ms:.3f} ms, bound "
          f"{entry['bound_ms']:.3f} ms")


def concat_columns(Vs: dict):
    """The right-hand sides side by side, and the column range of each."""
    import torch

    cols, at = {}, 0
    for key, V in Vs.items():
        cols[key] = slice(at, at + V.shape[1])
        at += V.shape[1]
    return torch.cat(list(Vs.values()), 1), cols


def sqdist_kernels(dev, X, compare, timings):
    """K1 (the register tile's forward form up to 16 columns, the 3xTF32
    wide kernel past 16) and K2 (the tile's triangle form) in every
    squared-distance family against the float64 plain version: at the
    HIGGS shape on 4,096 sampled rows (lengthscale sqrt(28), K1 at k = 1,
    3, 16, 17, 200, 500, K2 at 1, 2, 3, 10, 16), at ragged shapes (n, m not
    multiples of 128; d = 3, 28, 50; a scalar and an ARD lengthscale), K2
    at E2's shard shape (12,500 points of the half-ring, d = 28); the
    forward form the same bits twice (also in runs of the m axis); and K1
    timed at config 5's (E1's) shapes, n = m = 50,000: k = 1, 32, 200."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain

    n, d = X.shape
    ls = d**0.5
    idx = torch.as_tensor(sampled_rows(n, 4096, 6), device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    k1s, k2s = (1, 3, 16, 17, 200, 500), (1, 2, 3, 10, 16)
    V1 = {k: torch.randn((n, k), generator=gen, device=dev) for k in k1s}
    V2 = {k: torch.randn((n, k), generator=gen, device=dev) for k in k2s}
    Vall, cols = concat_columns({**{("k1", k): V1[k] for k in k1s},
                                 **{("k2", k): V2[k] for k in k2s}})
    XT = kernel_cuda.tile_operand(X, ls)
    ops = (lambda: (XT, XT))
    shape = f"rows 4096 of n=m={n} d={d}"
    for kind in SQDIST_KINDS:
        t0 = time.perf_counter()
        ref = kernel_plain.gram_matmat_f64(kind, X[idx], X, Vall, ls, row_block=512)
        torch.cuda.synchronize()
        print(f"{kind} float64 reference, 4096 rows, {Vall.shape[1]} columns: "
              f"{time.perf_counter() - t0:.3f} s")
        for k in k1s:
            got = kernel_cuda.gram_matmat(kind, X, X, V1[k], ls, 1.0, ops)
            compare("gram_matmat", got[idx], ref[:, cols[("k1", k)]], f"{kind} {shape} k={k}",
                    K_BOUND)
            if k in (3, 500):
                again = kernel_cuda.gram_matmat(kind, X, X, V1[k], ls, 1.0, ops)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"gram_matmat {kind} k={k}: the same bits twice")
            del got
        for k in k2s:
            compare("gram_matvec_symmetric",
                    kernel_cuda.gram_matvec_symmetric(kind, X, V2[k], ls, 1.0, XT)[idx],
                    ref[:, cols[("k2", k)]], f"{kind} {shape} k={k}", K_BOUND)
        del ref
    del Vall, V1, V2
    # ragged shapes: n, m not multiples of 128, the last feature chunk 3, 28
    # and 18 features, a scalar and an ARD lengthscale
    rng = np.random.default_rng(41)
    for n1, m1, dd in ((1000, 777, 3), (1000, 777, 28), (300, 1300, 50)):
        P1 = torch.from_numpy(rng.standard_normal((n1, dd)).astype(np.float32)).to(dev)
        P2 = torch.from_numpy(rng.standard_normal((m1, dd)).astype(np.float32)).to(dev)
        W1, c1 = concat_columns({k: torch.from_numpy(rng.standard_normal((m1, k)).astype(
            np.float32)).to(dev) for k in k1s})
        W2, c2 = concat_columns({k: torch.from_numpy(rng.standard_normal((n1, k)).astype(
            np.float32)).to(dev) for k in k2s})
        ard = torch.linspace(0.6, 1.4, dd, device=dev) * dd**0.5
        for lsr, tag in ((dd**0.5, "scalar"), (ard, "ARD")):
            for kind in SQDIST_KINDS:
                ref1 = kernel_plain.gram_matmat_f64(kind, P1, P2, W1, lsr, 0.9)
                ref2 = kernel_plain.gram_matmat_f64(kind, P1, P1, W2, lsr, 0.9)
                for k in k1s:
                    compare("gram_matmat",
                            kernel_cuda.gram_matmat(kind, P1, P2, W1[:, c1[k]], lsr, 0.9),
                            ref1[:, c1[k]], f"{kind} n={n1} m={m1} d={dd} k={k} {tag} "
                            "lengthscale", K_BOUND)
                for k in k2s:
                    compare("gram_matvec_symmetric",
                            kernel_cuda.gram_matvec_symmetric(kind, P1, W2[:, c2[k]], lsr, 0.9),
                            ref2[:, c2[k]], f"{kind} n={n1} d={dd} k={k} {tag} lengthscale",
                            K_BOUND)
    # the triangle at the shard shape of E2's half-ring (N5 / P_RING points)
    ns = N5 // P_RING
    Xs = X[:ns].contiguous()
    W2, c2 = concat_columns({k: torch.randn((ns, k), generator=gen, device=dev) for k in k2s})
    ard = torch.linspace(0.6, 1.4, d, device=dev) * ls
    for lsr, tag in ((ls, "scalar"), (ard, "ARD")):
        for kind in SQDIST_KINDS:
            ref = kernel_plain.gram_matmat_f64(kind, Xs, Xs, W2, lsr, row_block=2048)
            for k in k2s:
                compare("gram_matvec_symmetric",
                        kernel_cuda.gram_matvec_symmetric(kind, Xs, W2[:, c2[k]], lsr),
                        ref[:, c2[k]], f"{kind} E2 shard n={ns} d={d} k={k} {tag} lengthscale",
                        K_BOUND)
    # the forward form in runs of the m axis: the same bits twice
    P1 = torch.from_numpy(rng.standard_normal((1000, 28)).astype(np.float32)).to(dev)
    P2 = torch.from_numpy(rng.standard_normal((300_000, 28)).astype(np.float32)).to(dev)
    W = torch.from_numpy(rng.standard_normal((300_000, 3)).astype(np.float32)).to(dev)
    runs = kernel_cuda.tile_splits(1000, 300_000, 3, kernel_cuda.sm_count(dev))
    one, two = (kernel_cuda.gram_matmat("matern32", P1, P2, W, ls) for _ in range(2))
    torch.cuda.synchronize()
    check(runs > 1 and torch.equal(one, two), f"gram_matmat in {runs} runs: the same bits twice")
    compare("gram_matmat", one[:256],
            kernel_plain.gram_matmat_f64("matern32", P1[:256], P2, W, ls, row_block=256),
            f"matern32 rows 256 of n=1000 m=300000 d=28 k=3, {runs} runs", K_BOUND)
    del P1, P2, W, one, two

    # K1 at config 5's n (E1's operator, the unsharded mesh of one card)
    X5 = X[:N5].contiguous()
    XT5 = kernel_cuda.tile_operand(X5, ls)
    for k in (1, 32, RANK5):
        V = torch.randn((N5, k), generator=gen, device=dev)
        ms = cuda_ms(lambda: kernel_cuda.gram_matmat("rbf", X5, X5, V, ls, 1.0,
                                                     lambda: (XT5, XT5)))
        entry = timing_entry("gram_matmat", f"E1 n={N5} d={d} k={k}", ms, None, N5, N5, d, k)
        timings.setdefault("gram_matmat", []).append(entry)
        print(f"time gram_matmat E1 n={N5} d={d} k={k}: kernel {ms:.3f} ms, bound "
              f"{entry['bound_ms']:.3f} ms ({entry['bound_by']})")


# The float64 tile's forward form at the HIGGS shape past the k = 1 and 10
# the kernels' main timings take: 16 columns, one slice; 17, two.
COMP_KS = (16, 17)
# Its ragged checks: n, m not multiples of 128, one row tile of 100, d not a
# multiple of 16; 300 x 5,000 takes runs of X2's tiles.
COMP_RAGGED = ((1000, 777, 3), (100, 1300, 28), (300, 5000, 50))


def _as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


def _comp_value(r):
    """A float64-tile product as float64: hi + lo of K1c's and K3c's pair."""
    return r[0].double() + r[1].double() if isinstance(r, tuple) else r


def comp_forward(kname, kind, X1, X2, V, ls):
    """The call of a forward-form wrapper (``gram_matmat_comp``,
    ``laplace_matmat_comp``, ``gram_matmat_f64``) on float32 V, V cast to
    float64 outside it for K8."""
    from rlaopt_tpu_torch.ops import kernel_cuda

    if kname == "gram_matmat_f64":
        V64 = V.double()
        return lambda: kernel_cuda.gram_matmat_f64(kind, X1, X2, V64, ls)
    if kname == "laplace_matmat_comp":
        return lambda: kernel_cuda.laplace_matmat_comp(X1, X2, V, ls)
    return lambda: kernel_cuda.gram_matmat_comp(kind, X1, X2, V, ls)


def comp_forms(dev, X, compare, timings):
    """The float64 tile's forward form (the general K1c, K3c and K8) and its
    pair form (the certified pairs of the sharded half-ring). Each timed
    shape is run twice for the same bits (the forward form has no atomics)
    and checked on sampled rows against the float64 plain version within
    COMP_BOUND: K1c, K3c (ℓ = 32) and K8 at the HIGGS shape at COMP_KS,
    K1c and K8 at E2's shard (12,500 against 12,500 other points), K1c at
    E1's slab (50,000²), K3c at E3's shard (33,334 against 33,334). Every
    family at COMP_RAGGED, scalar and ARD lengthscales, k = 1, 3, 10, 17,
    forward and pair forms against float64. The pairs (float32 and float64
    V) at E2's and E3's shard pairs, both outputs on sampled rows, timed.
    And ``comp_operand``'s build at the HIGGS shape, which every call of
    these wrappers makes (config 6 times it at 10⁶ points)."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain

    t_phase = time.perf_counter()
    ls = D**0.5
    gen = torch.Generator(device=dev).manual_seed(40)

    def timed(kname, kind, l, X1, X2, k, what):
        n, m = X1.shape[0], X2.shape[0]
        V = torch.randn((m, k), generator=gen, device=dev)
        fn = comp_forward(kname, kind, X1, X2, V, l)
        got, again = fn(), fn()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(_as_tuple(got), _as_tuple(again))),
              f"{kname} {what}: the same bits twice")
        idx = torch.as_tensor(sampled_rows(n, min(2048, n), 42), device=dev)
        ref = kernel_plain.gram_matmat_f64(kind, X1[idx], X2, V, l, row_block=256)
        compare(kname, _comp_value(got)[idx], ref, f"{what} rows {idx.numel()}", COMP_BOUND)
        del got, again, ref
        ms = cuda_ms(fn)
        entry = timing_entry(kname, what, ms, None, n, m, D, k, kind)
        timings.setdefault(kname, []).append(entry)
        print(f"time {kname} {what}: kernel {ms:.3f} ms, bound {entry['bound_ms']:.3f} ms "
              f"({entry['bound_ms'] / ms:.1%})")

    n = X.shape[0]
    for kname, kind, l in (("gram_matmat_comp", "rbf", ls), ("laplace_matmat_comp", "laplace", LS_B),
                           ("gram_matmat_f64", "rbf", ls)):
        for k in COMP_KS:
            timed(kname, kind, l, X, X, k, f"n=m={n} d={D} k={k}")
    e2, e3 = N5 // P_RING, -(-n // P_LAPLACE)
    for kname in ("gram_matmat_comp", "gram_matmat_f64"):
        timed(kname, "rbf", ls, X[:e2], X[e2:2 * e2], 1, f"E2 shard n={e2} m={e2} d={D} k=1")
    timed("gram_matmat_comp", "rbf", ls, X[:N5], X[:N5].clone(), 1, f"E1 slab n=m={N5} d={D} k=1")
    timed("laplace_matmat_comp", "laplace", LS_B, X[:e3], X[e3:2 * e3], 1,
          f"E3 shard n={e3} m={e3} d={D} k=1")
    op_ms = cuda_ms(lambda: kernel_cuda.comp_operand(X, ls))
    print(f"time comp_operand n={n} d={D}: {op_ms:.3f} ms")

    # every family at the ragged shapes, forward and pair forms
    rng = np.random.default_rng(44)
    ks = (1, 3, 10, 17)
    for n1, n2, d in COMP_RAGGED:
        P1, P2 = (torch.from_numpy(rng.standard_normal((r, d)).astype(np.float32)).to(dev)
                  for r in (n1, n2))
        W, cw = concat_columns({k: torch.from_numpy(rng.standard_normal((n2, k)).astype(
            np.float32)).to(dev) for k in ks})
        S, cs = concat_columns({k: torch.from_numpy(rng.standard_normal((n1, k)).astype(
            np.float32)).to(dev) for k in ks})
        ard = torch.linspace(0.6, 1.8, d, dtype=torch.float64, device=dev) * d**0.5
        for kind in SQDIST_KINDS + ("laplace",):
            forward = "laplace_matmat_comp" if kind == "laplace" else "gram_matmat_comp"
            for l, tag in ((1.3 * d**0.5, "scalar"), (ard, "ARD")):
                ref1 = kernel_plain.gram_matmat_f64(kind, P1, P2, W, l, 0.9)
                ref2 = kernel_plain.gram_matmat_f64(kind, P2, P1, S, l, 0.9)
                for k in ks:
                    what = f"{kind} n={n1} m={n2} d={d} k={k} {tag} lengthscale"
                    V2, V1 = W[:, cw[k]], S[:, cs[k]]
                    if kind == "laplace":
                        hi, lo = kernel_cuda.laplace_matmat_comp(P1, P2, V2, l, 0.9)
                    else:
                        hi, lo = kernel_cuda.gram_matmat_comp(kind, P1, P2, V2, l, 0.9)
                    compare(forward, hi.double() + lo.double(), ref1[:, cw[k]], what, COMP_BOUND)
                    compare("gram_matmat_f64",
                            kernel_cuda.gram_matmat_f64(kind, P1, P2, V2.double(), l, 0.9),
                            ref1[:, cw[k]], what, COMP_BOUND)
                    for pname, a, b in (("gram_pair_comp", V2, V1),
                                        ("gram_pair_f64", V2.double(), V1.double())):
                        o1, o2 = getattr(kernel_cuda, pname)(kind, P1, P2, a, b, l, 0.9)
                        compare(pname, o1, ref1[:, cw[k]], what + " out1", COMP_BOUND)
                        compare(pname, o2, ref2[:, cs[k]], what + " out2", COMP_BOUND)
    print(f"phase: the float64 tile's ragged checks done at "
          f"{time.perf_counter() - t_phase:.1f} s into it")

    # the pairs at E2's and E3's shard pairs, both outputs, timed
    for pname, kind, l, loc, k in (("gram_pair_comp", "rbf", ls, e2, 1),
                                   ("gram_pair_f64", "rbf", ls, e2, 1),
                                   ("gram_pair_comp", "rbf", ls, e2, 10),
                                   ("gram_pair_comp", "laplace", LS_B, e3, 1)):
        X1, X2 = X[:loc], X[loc:2 * loc]
        V2 = torch.randn((X2.shape[0], k), generator=gen, device=dev)
        V1 = torch.randn((loc, k), generator=gen, device=dev)
        if pname == "gram_pair_f64":
            V2, V1 = V2.double(), V1.double()
        fn = (lambda X1=X1, X2=X2, V2=V2, V1=V1, kind=kind, l=l, pname=pname:
              getattr(kernel_cuda, pname)(kind, X1, X2, V2, V1, l))
        o1, o2 = fn()
        i1 = torch.as_tensor(sampled_rows(loc, min(1024, loc), 45), device=dev)
        i2 = torch.as_tensor(sampled_rows(X2.shape[0], min(1024, loc), 46), device=dev)
        shard = "E3" if kind == "laplace" else "E2"
        what = f"{shard} shard pair n1={loc} n2={X2.shape[0]} d={D} k={k}"
        compare(pname, o1[i1], kernel_plain.gram_matmat_f64(kind, X1[i1], X2, V2, l),
                f"{what} out1 rows {i1.numel()}", COMP_BOUND)
        compare(pname, o2[i2], kernel_plain.gram_matmat_f64(kind, X2[i2], X1, V1, l),
                f"{what} out2 rows {i2.numel()}", COMP_BOUND)
        del o1, o2
        ms = cuda_ms(fn, inner=5)
        p_ms = None
        if pname not in timings:  # each pair's first shape: its plain version too
            p_ms = cuda_ms(lambda X1=X1, X2=X2, V2=V2, V1=V1, pname=pname: getattr(
                kernel_plain, pname)(kind, X1, X2, V2, V1, l), reps=3)
        entry = timing_entry(pname, what, ms, p_ms, loc, X2.shape[0], D, k, kind)
        timings.setdefault(pname, []).append(entry)
        print(f"time {pname} {what}: kernel {ms:.3f} ms, plain "
              + ("not timed" if p_ms is None else f"{p_ms:.3f} ms")
              + f", bound {entry['bound_ms']:.3f} ms ({entry['bound_ms'] / ms:.1%})")
    print(f"phase: the float64 tile's forms done at {time.perf_counter() - t_phase:.1f} s into it")


# The ported utils on slice 1's operator (config 3, k = 1): checkpoint and
# resume (10 iterations, then a resume to 20, against one uninterrupted
# 20-iteration solve), the four sketch classes in both modes at s = 500,
# d = 100,000 on the card, trace and Profiler around one K2 matvec,
# debug_nans around a healthy and a NaN matvec.
RESUME_ITERS, RESUME_FREQ, RESUME_BOUND = 20, 5, 1e-6
SKETCH_S, SKETCH_D, SKETCH_BOUND = 500, 100_000, 1e-5
# Config 8 (benchmarks/run.py::config8_accelerated_sap_certified) as written:
# n = 100,000, d = 10, standard-normal X and y (numpy seed 0), reg = 1e-5·n,
# ℓ = √10, the bf16x3 RBF operator, blocks of n/8 (auto blk_dense off:
# 12,500² float32 values are 596 MiB, over SAP's 512 MiB budget), Nyström
# rank 256 at rho = reg, 10 power iterations, rtol 1e-7, callback_freq 25,
# true metrics, key 7; a 50-iteration plain pilot, 300 plain iterations, 300
# accelerated ones with two evaluate-mode float64 refinement rounds on the
# card, certified by the float64 plain version (not K7 or K8) at 1e-6.
N8, D8, PILOT8, ITERS8, FREQ8, RANK8, CERT8 = 100_000, 10, 50, 300, 25, 256, 1e-6


def ported_utils(dev, K, X, Y1, reg):
    """The ported utils on slice 1's operator ``K`` (RBF on the HIGGS-100k
    points ``X``), counted as one path. Returns its record."""
    import tempfile

    import torch

    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.ops import kernel_cuda
    from rlaopt_tpu_torch.preconditioners import NystromConfig
    from rlaopt_tpu_torch.sketches import get_sketch
    from rlaopt_tpu_torch.solvers import PCGConfig
    from rlaopt_tpu_torch.utils import Profiler, SolveCheckpointer, debug_nans, trace

    n = X.shape[0]
    record = {}
    kernel_cuda.reset_launch_counts()
    t_phase = time.perf_counter()

    # checkpoint and resume: 10 iterations saved, resumed to 20, against one
    # uninterrupted 20-iteration solve (rtol 1e-12: neither stops early)
    def cfg(iters):
        return PCGConfig(max_iters=iters, rtol=1e-12,
                         precond_config=NystromConfig(rank=RANK, rho=reg))

    W0 = torch.zeros((n, 1), device=dev)
    W_full, log_full = LinSys(K, Y1, reg=reg).solve(cfg(RESUME_ITERS), W0, key=0,
                                                    callback_freq=RESUME_FREQ)
    with tempfile.TemporaryDirectory() as ckdir:
        t0 = time.perf_counter()
        LinSys(K, Y1, reg=reg).solve(cfg(RESUME_ITERS // 2), W0, key=0,
                                     callback_freq=RESUME_FREQ, checkpoint_dir=ckdir)
        ck = SolveCheckpointer(ckdir)
        files = sorted(os.listdir(ckdir))
        check(ck.latest_step() == RESUME_ITERS // 2,
              f"resume: the checkpoint at iteration {RESUME_ITERS // 2}")
        sys_r = LinSys(K, Y1, reg=reg)
        W_res, log_res = sys_r.solve(cfg(RESUME_ITERS), W0, key=0, callback_freq=RESUME_FREQ,
                                     checkpoint_dir=ckdir, resume=True)
        torch.cuda.synchronize()
        ckpt_s = time.perf_counter() - t0
    check(W_res.is_cuda and W_res.dtype == torch.float32, "resume: W is float32 on the card")
    diff = (torch.linalg.norm(W_res.double() - W_full.double())
            / torch.linalg.norm(W_full.double())).item()
    keys = int_keys(log_res)
    # the restored entries come from the JSON sidecar: lists, not tensors
    rel_res = [float(torch.as_tensor(log_res[i]["metrics"]["internal_metrics"]["rel_res"]).max())
               for i in keys]
    print(f"utils resume: files {files}; resumed log keys {keys} rel_res {rel_res}; "
          f"relative difference of W from the uninterrupted solve {diff:.3e} "
          f"(bound {RESUME_BOUND:.0e}); both halves {ckpt_s:.3f} s")
    check(keys == list(range(0, RESUME_ITERS + 1, RESUME_FREQ)) and keys == int_keys(log_full),
          "resume: the log holds every boundary from 0 to 20")
    check(diff <= RESUME_BOUND, f"resume: W within {RESUME_BOUND:.0e} of the uninterrupted solve")
    record["resume"] = {"relative_difference": diff, "keys": keys, "rel_res": rel_res,
                        "files": files, "s": ckpt_s}

    # the sketch classes, each apply against the materialized Omega_mat
    gen = torch.Generator(device=dev).manual_seed(14)
    sketches = {}
    for name in ("gauss", "ortho", "sparse", "srht"):
        for mode in ("left", "right"):
            t0 = time.perf_counter()
            sk = get_sketch(name, mode, SKETCH_S, SKETCH_D, torch.float32, key=3)
            Om = sk.Omega_mat
            check(Om.is_cuda, f"sketch {name} {mode}: drawn on the card by default")
            r, c = Om.shape
            Om64 = Om.double()
            worst = 0.0
            for apply, x, ref in (
                ("_apply_left", (c, 3), lambda x: Om64 @ x),
                ("_apply_right", (3, r), lambda x: x @ Om64),
                ("_apply_left_trans", (r, 3), lambda x: Om64.T @ x),
                ("_apply_right_trans", (3, c), lambda x: x @ Om64.T),
            ):
                xt = torch.randn(x, generator=gen, device=dev)
                got = getattr(sk, apply)(xt)
                want = ref(xt.double())
                rel = ((got.double() - want).abs().max() / want.abs().max()).item()
                worst = max(worst, rel)
                check(got.is_cuda and tuple(got.shape) == tuple(want.shape) and rel <= SKETCH_BOUND,
                      f"sketch {name} {mode} {apply} within {SKETCH_BOUND:.0e} of Omega_mat")
            torch.cuda.synchronize()
            sketches[f"{name} {mode}"] = {"rel": worst, "s": time.perf_counter() - t0}
            print(f"utils sketch {name} {mode}: Omega_mat {tuple(Om.shape)} on {Om.device}, "
                  f"four applies against it: worst rel {worst:.3e} (bound {SKETCH_BOUND:.0e})")
            del sk, Om, Om64
    record["sketches"] = sketches

    # trace and Profiler around one K2 matvec (k = 1)
    v = torch.randn((n, 1), generator=gen, device=dev)
    kernel_ms = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        K @ v
        b.record()
        b.synchronize()
        kernel_ms.append(a.elapsed_time(b))
    with tempfile.TemporaryDirectory() as tdir:
        with trace(tdir):
            (K @ v).sum().item()
        traces = [f for f in os.listdir(tdir) if f.endswith(".json")]
        text = open(os.path.join(tdir, traces[0])).read() if traces else ""
    named = "tile_triangle" in text
    print(f"utils trace: files {traces}, {len(text)} bytes, names K2's kernel "
          f"(tile_triangle): {named}")
    check(len(traces) == 1 and named, "trace: one trace file that names K2's kernel")
    prof = Profiler()
    with prof.phase("k2") as out:
        out["sync"] = K @ v
    unblocked = Profiler(block=False)
    with unblocked.phase("k2", result=K @ v):
        pass
    torch.cuda.synchronize()
    phase_ms = prof.summary()["k2"]["total_s"] * 1e3
    print(f"utils Profiler: phase {phase_ms:.3f} ms, K2 matvec by CUDA events "
          f"{min(kernel_ms):.3f}-{max(kernel_ms):.3f} ms, without the sync "
          f"{unblocked.summary()['k2']['total_s'] * 1e3:.3f} ms")
    check(phase_ms >= min(kernel_ms), "Profiler.phase reads at least the K2 matvec's own time")
    record["profiler"] = {"phase_ms": phase_ms, "kernel_ms": kernel_ms,
                          "unblocked_ms": unblocked.summary()["k2"]["total_s"] * 1e3}

    # debug_nans: a healthy matvec raises nothing; a V with one NaN, made
    # outside the context, raises at the matvec or at the torch op after it
    V = torch.randn((n, 1), generator=gen, device=dev)
    with debug_nans():
        torch.linalg.norm(K @ V, dim=0).item()
    V[n // 2, 0] = float("nan")
    raised = None
    with debug_nans():
        try:
            torch.linalg.norm(K @ V, dim=0)
        except FloatingPointError as e:
            raised = str(e)
    print(f"utils debug_nans: healthy matvec passed; NaN matvec raised: {raised}")
    check(raised is not None, "debug_nans raises on the NaN matvec")
    record["debug_nans"] = raised
    torch.cuda.synchronize()
    record["launches"] = kernel_cuda.launch_counts()
    record["s"] = time.perf_counter() - t_phase
    used = record["launches"]
    check(used["gram_matvec_symmetric"] > 0 and used["gram_matmat"] > 0,
          "utils: the resume ran through K2 and its sketch through K1")
    print("utils " + json.dumps(record))
    return record


def config8(dev, profile_run):
    """Config 8 as written (``benchmarks/run.py::config8_accelerated_sap_
    certified``): a plain pilot, plain SAP and accelerated SAP with two
    float64 refinement rounds, through the entry points a user calls,
    counted as one path; the pilot profiled. Certified by the float64
    plain version. Returns the path's record."""
    import torch

    from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
    from rlaopt_tpu_torch.preconditioners import NystromConfig
    from rlaopt_tpu_torch.solvers import SAPConfig, sap_accel_from_pilot

    n, d = N8, D8
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(dev)
    reg = 1e-5 * n
    ls = float(d) ** 0.5
    blk = n // 8
    base = dict(rtol=1e-7, blk_sz=blk, precond_config=NystromConfig(rank=RANK8, rho=reg),
                power_iters=10)
    kernel_cuda.reset_launch_counts()
    K = RBFLinOp(X, X, KernelConfig(lengthscale=ls), compute_dtype="bf16x3")

    def run(cfg, refine=False, prof=None):
        before = kernel_cuda.launch_counts()
        sys_ = LinSys(K, y, reg=reg, A_row_oracle=K.row_oracle, A_blk_oracle=K.blk_oracle)
        kwargs = dict(f64_refine_rounds=2, f64_refine_device="accel") if refine else {}
        with (prof or contextlib.nullcontext()):
            t0 = time.perf_counter()
            W, log = sys_.solve(cfg, torch.zeros((n, 1), device=dev), callback_freq=FREQ8,
                                key=7, metrics="true", **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        after = kernel_cuda.launch_counts()
        traj = {i: float(torch.max(log[i]["metrics"]["internal_metrics"]["rel_res"]))
                for i in int_keys(log)}
        return {"W": W, "log": log, "traj": traj, "wall_s": wall, "sys": sys_,
                "launches": {k: after[k] - before[k] for k in after}}

    # the pilot profiled: its steps are the plain run's, and a profile of
    # 300 steps (~1,200 device events each) takes a minute to read
    t_all = time.perf_counter()
    prof = profile_run()
    pilot = run(SAPConfig(max_iters=PILOT8, accel=False, **base), prof=prof)
    acc = sap_accel_from_pilot(pilot["traj"][PILOT8], PILOT8, n, blk)
    plain = run(SAPConfig(max_iters=ITERS8, accel=False, **base))
    accel = run(SAPConfig(max_iters=ITERS8, accel=True, accel_config=acc, **base), refine=True)
    wall = time.perf_counter() - t_all
    used = kernel_cuda.launch_counts()

    # the certificate: the float64 plain version on the card (not K7, K8)
    W = accel["W"]
    check(W.dtype == torch.float64 and W.is_cuda, "config8: refined W is float64 on the card")
    t0 = time.perf_counter()
    y64 = y.double()[:, None]
    KW = kernel_plain.gram_matmat_f64("rbf", X, X, W, ls, row_block=BLOCK)
    rel_true = (torch.linalg.norm(y64 - (KW + reg * W)) / torch.linalg.norm(y64)).item()
    cert_s = time.perf_counter() - t0
    refine = accel["log"]["f64_refine"]
    claimed = [max(h) for h in refine["rel_res_f64"]]
    ratio = plain["traj"][ITERS8] / accel["traj"][ITERS8]
    for name, r in (("pilot", pilot), ("plain", plain), ("accelerated", accel)):
        iters = int_keys(r["log"])[-1]
        print(f"config8 {name}: {iters} iterations, wall {r['wall_s']:.3f} s, phase_walls "
              f"{r['sys'].phase_walls}, s/iter {r['sys'].phase_walls['train'] / iters:.5f}, "
              f"launches {r['launches']}")
    print(f"config8 pilot: rel_res {pilot['traj'][PILOT8]:.6e} at {PILOT8}; mu {acc.mu:.6e} "
          f"nu {acc.nu}")
    every50 = {name: {i: r["traj"][i] for i in r["traj"] if i % 50 == 0}
               for name, r in (("plain", plain), ("accelerated", accel))}
    print(f"config8 trajectories every 50: {json.dumps(every50)}")
    print(f"config8 plain/accelerated rel_res at {ITERS8}: {ratio:.4f}; refinement claimed "
          f"{claimed}, phase_walls {refine['phase_walls']}; independent float64 rel_res "
          f"{rel_true:.6e} in {cert_s:.3f} s (bound {CERT8:.0e})")
    check(accel["traj"][ITERS8] < plain["traj"][ITERS8],
          "config8: accelerated SAP below plain SAP at 300 iterations")
    check(rel_true <= CERT8, f"config8: independent float64 rel_res {rel_true:.3e} <= 1e-6")
    check(abs(claimed[-1] - rel_true) <= 0.01 * rel_true,
          "config8: the refinement's claimed rel_res within 1% of the independent one")
    check(used["gram_matmat_tier"] >= PILOT8 + 2 * ITERS8,
          "config8: every iteration's row oracle ran through K1b")
    check(used["gram_matvec_symmetric_comp"] >= (PILOT8 + 2 * ITERS8) // FREQ8
          and used["gram_matmat_comp"] == 0,
          "config8: every boundary's true residual ran through K1c's triangle form")
    check(accel["launches"]["gram_matvec_symmetric_f64"] >= 1, "config8: refinement ran through K7")
    profile = device_breakdown(prof)
    busy = profile.get("busy_ms")
    record = {
        "n": n, "d": d, "blk_sz": blk, "rank": RANK8, "wall_s": wall,
        "pilot": {"iters": PILOT8, "rel_res": pilot["traj"][PILOT8], "wall_s": pilot["wall_s"],
                  "phase_walls": pilot["sys"].phase_walls,
                  "busy_share": None if busy is None else busy / 1e3 / pilot["wall_s"],
                  "profile": profile},
        "accel_params": {"mu": acc.mu, "nu": acc.nu},
        "plain": {"wall_s": plain["wall_s"], "phase_walls": plain["sys"].phase_walls,
                  "s_per_iter": plain["sys"].phase_walls["train"] / ITERS8},
        "accelerated": {"wall_s": accel["wall_s"], "phase_walls": accel["sys"].phase_walls,
                        "s_per_iter": accel["sys"].phase_walls["train"] / ITERS8,
                        "refine_phase_walls": refine["phase_walls"]},
        "plain_rel_res_trajectory": every50["plain"],
        "accel_rel_res_trajectory": every50["accelerated"],
        "accel_vs_plain_at_equal_iters": ratio, "refine_claimed": claimed,
        "rel_res_true_f64": rel_true, "certificate_s": cert_s, "launches": used,
    }
    print("config8 " + json.dumps(record))
    return record


def slice3(dev, X, Xn, y):
    """Path B: Nyström-PCG on the Laplace operator at the HIGGS-100k shape,
    through the entry points a user calls: k = 1, k = 10, then k = 1 with
    two float64 refinement rounds (evaluate/full). Counted as one window,
    and so are the register tile's operands built in it: the operator's
    kept one once (K5 and the wide K3 of the sketch take it), none in a
    call; then every logged residual against a float64 one of the same
    iterate (one plain float64 sweep over all of them), and the refined
    claim against a full K7 sweep. Returns the launch counts."""
    import torch

    from rlaopt_tpu_torch.kernels import KernelConfig, LaplaceLinOp, linop
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
    from rlaopt_tpu_torch.preconditioners import NystromConfig
    from rlaopt_tpu_torch.solvers import PCGConfig

    n = X.shape[0]
    reg = 1e-4 * n
    Y10 = torch.cat([y[:, None], torch.from_numpy(extra_targets(Xn, 10)).to(dev)], 1)
    cfg = PCGConfig(max_iters=ITERS, rtol=1e-6,
                    precond_config=NystromConfig(rank=RANK, rho=reg))
    built = {"kept": 0, "in a call": 0}

    def counted(fn, key):
        def build(*args):
            built[key] += 1
            return fn(*args)
        return build

    kept_fn, call_fn = linop.tile_operand, kernel_cuda.tile_operand
    linop.tile_operand = counted(kept_fn, "kept")
    kernel_cuda.tile_operand = counted(call_fn, "in a call")
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
    linop.tile_operand, kernel_cuda.tile_operand = kept_fn, call_fn
    print(f"slice3 tile operands built: {built}")
    check(built == {"kept": 1, "in a call": 0},
          "slice3 the operator's tile operand built once, taken by K5 and the wide K3 sketch")

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
        check(used["laplace_matmat"] > 0 and used["laplace_matmat_narrow"] == 0,
              f"slice3 k={k} sketch ran through laplace_matmat past 16 columns")
        check(used["gram_matvec_symmetric_comp"] >= len(log) and used["laplace_matmat_comp"] == 0,
              f"slice3 k={k} every boundary ran through the triangle K3c")
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
        check(used["laplace_matmat_narrow"] >= iters,
              f"{name}: every iteration's row oracle ran through K3's tile")
        check(used["gram_matvec_symmetric_comp"] >= 1 and used["laplace_matmat_comp"] == 0,
              f"{name}: the final residual ran through the triangle K3c")
    else:
        check(used["gram_matmat_tier"] >= iters, f"{name}: every iteration ran through K1b")
        check(used["gram_matvec_symmetric_comp"] >= 1 and used["gram_matmat_comp"] == 0,
              f"{name}: the final residual ran through K1c's triangle form")

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
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = kernel_cuda.tile_splits(BLK4, N4, 1, sms)
        # the path's call: LaplaceLinOp's row oracle keeps the operand of
        # the N4 points on its parent and builds its block's
        XT = kernel_cuda.tile_operand(X, ls)
        kept = (lambda: (kernel_cuda.tile_operand(Xb, ls), XT))
        got, again = (kernel_cuda.laplace_matmat(Xb, X, Wf, ls) for _ in range(2))
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name} row oracle: the same bits twice")
        check(torch.equal(got, kernel_cuda.laplace_matmat(Xb, X, Wf, ls, operands=kept)),
              f"{name} row oracle: the same bits with the operator's kept operand")
        compare("laplace_matmat_narrow", got[:s], ref, f"{shape} runs {splits}", K_BOUND)
        del got, again
        hi, lo = kernel_cuda.laplace_matmat_comp(X[idx], X, Wf, ls)
        compare("laplace_matmat_comp", hi.double() + lo.double(), ref, f"{shape} (hi+lo)",
                COMP_BOUND)
        ms = cuda_ms(lambda: kernel_cuda.laplace_matmat(Xb, X, Wf, ls, operands=kept))
        built_ms = cuda_ms(lambda: kernel_cuda.laplace_matmat(Xb, X, Wf, ls))
        operand_ms = cuda_ms(lambda: kernel_cuda.tile_operand(X, ls))
        del XT
        p_ms = cuda_ms(lambda: kernel_plain.gram_matmat("laplace", Xb, X, Wf, ls, row_block=64),
                       reps=1, warm=False)
        what = f"row oracle n={BLK4} m={N4} d={D4} k=1"
        timings.setdefault("laplace_matmat_narrow", []).insert(0, timing_entry(
            "laplace_matmat_narrow", f"{what} runs {splits}", ms, p_ms, BLK4, N4, D4, 1,
            "laplace", splits=splits, operand_ms=operand_ms, built_ms=built_ms))
        print(f"time laplace_matmat_narrow {what}: runs {splits} {ms:.3f} ms with the operand "
              f"of the {N4} points kept (building it in the call {built_ms:.3f} ms; it alone "
              f"{operand_ms:.3f} ms, once an operator), plain {p_ms:.3f} ms, bound "
              f"{timings['laplace_matmat_narrow'][0]['bound_ms']:.3f} ms")
        record["row_oracle_ms"] = {"runs": splits, "ms": ms, "built_ms": built_ms,
                                   "operand_ms": operand_ms, "plain_ms": p_ms}
        # the final residual's product at path A's n: the triangle K3c on a
        # random column, checked on the s rows and timed beside the general
        out = {}
        tri_ms = cuda_ms(lambda: out.update(
            hl=kernel_cuda.gram_matvec_symmetric_comp("laplace", X, Wf, ls)), reps=1, warm=False)
        hi, lo = out.pop("hl")
        compare("gram_matvec_symmetric_comp", (hi.double() + lo.double())[idx], ref,
                f"laplace rows {s} of n=m={N4} d={D4} k=1 (hi+lo)", COMP_BOUND)
        del hi, lo
        gen_ms = cuda_ms(lambda: kernel_cuda.laplace_matmat_comp(X, X, Wf, ls), reps=1, warm=False)
        what = f"path A's final residual n=m={N4} d={D4} k=1"
        timings.setdefault("gram_matvec_symmetric_comp", []).append(timing_entry(
            "gram_matvec_symmetric_comp", f"laplace {what}", tri_ms, None, N4, N4, D4, 1,
            "laplace", general_ms=gen_ms))
        timings.setdefault("laplace_matmat_comp", []).append(timing_entry(
            "laplace_matmat_comp", what, gen_ms, None, N4, N4, D4, 1, "laplace"))
        print(f"time gram_matvec_symmetric_comp laplace {what}: triangle {tri_ms:.3f} ms, "
              f"general K3c {gen_ms:.3f} ms, bound "
              f"{timings['gram_matvec_symmetric_comp'][-1]['bound_ms']:.3f} ms")
        record["final_residual_ms"] = {"triangle_ms": tri_ms, "general_ms": gen_ms}
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
    profiled_entries(timings, profile.get("kernels", {}), used,
                     "path A final residual" if laplace else "path A' final residual",
                     N4, D4, [("gram_matvec_symmetric_comp", 1, None)], kind)
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
# The segment lengths of #9's segmented schedule timed beside the one the
# plan takes (kernel_cuda.CSR_SEGMENT).
CSR_SEGMENTS = (128, 256, 512, 1024, 2048)
# Calls of #9 and of cuSPARSE per timing (cuda_ms's inner): path S's SpMV
# takes ~0.1 ms, about what one call's host side takes.
CSR_INNER = 20


@contextlib.contextmanager
def csr_schedule(lanes=None, segmented=None):
    """#9 takes ``lanes`` threads a row (k <= 16; in the segmented schedule
    the short rows' lanes) and, where ``segmented`` is not None, cuts its
    long rows into segments or keeps every row whole."""
    from rlaopt_tpu_torch.ops import kernel_cuda

    real = kernel_cuda.spmm_lanes, kernel_cuda.csr_segmented
    if lanes is not None:
        kernel_cuda.spmm_lanes = lambda *a: lanes
    if segmented is not None:
        kernel_cuda.csr_segmented = lambda plan: segmented
    try:
        yield
    finally:
        kernel_cuda.spmm_lanes, kernel_cuda.csr_segmented = real


def sparse_kernels(dev, A, compare, timings):
    """#9 against the float64 plain version on path S's operand A (its CSR
    and the cached CSR of Aᵀ, with their kept plans), on random right-hand
    sides: the forward and adjoint SpMV, the SpMM at k = 10 both ways, the
    adjoint SpMM at the sketch's k = 4,096 (checked on 256 columns); the
    ragged CSR of the card tests and the ragged-rows CSR (rows of 0 to
    20,000 entries) at k = 1, 3, 10 and 300 in every schedule (every lanes
    value of k <= 16 with every row whole and with the long rows in
    segments, the wide schedule whole and in segments past 16), float32 and
    float64; two launches give the same bits in both types, and empty rows
    are 0. Each path shape and each ragged operand (at the schedule the
    wrapper picks, its plan built beforehand) timed (median of 5, each over
    CSR_INNER calls for the kernel and cuSPARSE): kernel, plain version
    (float32) and cuSPARSE; the forward SpMV also at every lanes value;
    the ragged operands and the sketch also with every row whole and with
    segments of each of CSR_SEGMENTS."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda
    from rlaopt_tpu_torch.sparse import ops as sops

    fwd = (*A._csr_buffers(), A._csr_plan())
    adj = (*A.T._csr_buffers(), A.T._csr_plan())
    gen = torch.Generator(device=dev).manual_seed(31)

    def same_bits(fn, args, what):
        got = fn(*args)
        again = fn(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{what}: two launches give the same bits")
        return got

    def by_segment(fn, values, indptr, indices, X, n_rows, inner, plan):
        """ms with every row whole and with segments of each length (each
        timing with its plan built beforehand)."""
        times = {}
        with csr_schedule(segmented=False):
            times["whole"] = cuda_ms(lambda: fn(values, indptr, indices, X, n_rows, plan),
                                     inner=inner)
        for seg in CSR_SEGMENTS:
            plan = kernel_cuda.csr_plan(indptr, seg)
            with csr_schedule(segmented=True):
                times[seg] = cuda_ms(lambda: fn(values, indptr, indices, X, n_rows, plan),
                                     inner=inner)
        return times

    def case(kernel, bufs, n_rows, n_cols, X, what, cols=None, lanes=(), segments=False):
        values, indices, indptr, plan = bufs
        fn = getattr(kernel_cuda, kernel)
        v64 = values.double()
        Xc = X if cols is None else X[:, :cols].contiguous()
        ref = sops._plain(v64, indptr, indices, Xc.double(), n_rows, False)
        got = same_bits(fn, (values, indptr, indices, X, n_rows, plan),
                        f"{kernel} {what} float32")
        compare(kernel, got if cols is None else got[:, :cols], ref, f"{what} float32",
                CSR_F32_BOUND)
        got = same_bits(fn, (v64, indptr, indices, Xc.double(), n_rows, plan),
                        f"{kernel} {what} float64")
        compare(kernel, got, ref, f"{what} float64", CSR_F64_BOUND)
        del ref, got
        lib = library_csr(values, indptr, indices, n_rows, n_cols)
        ms = cuda_ms(lambda: fn(values, indptr, indices, X, n_rows, plan), inner=CSR_INNER)
        p_ms = cuda_ms(lambda: sops._plain(values, indptr, indices, X, n_rows, False))
        l_ms = cuda_ms(lambda: lib @ X, inner=CSR_INNER)
        k = X.shape[1]
        entry = timing_entry(kernel, what, ms, p_ms, n_rows, n_cols, 0, k,
                             cd="float32", nnz=values.numel(), library_ms=l_ms,
                             lanes=kernel_cuda.spmm_lanes(n_rows, values.numel(), k),
                             segmented=kernel_cuda.csr_segmented(plan))
        for L in lanes:
            with csr_schedule(lanes=L):
                entry.setdefault("ms_by_lanes", {})[L] = cuda_ms(
                    lambda: fn(values, indptr, indices, X, n_rows, plan), inner=CSR_INNER)
        if segments:
            entry["ms_by_segment"] = by_segment(fn, values, indptr, indices, X, n_rows, 1, plan)
        timings.setdefault(kernel, []).append(entry)
        print(f"time {kernel} {what}: kernel {ms:.4f} ms (lanes {entry['lanes']}, segmented "
              f"{entry['segmented']}), plain {p_ms:.3f} ms, cuSPARSE {l_ms:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})"
              + (f", by lanes {entry['ms_by_lanes']}" if lanes else "")
              + (f", by segment {entry['ms_by_segment']}" if segments else ""))

    shape = f"n={S_ROWS} m={S_COLS} nnz={A.nnz}"
    t0 = time.perf_counter()
    # csr_spmm's first entry (its JSON line) is the sketch's
    X = torch.randn((S_ROWS, S_SKETCH), generator=gen, device=dev)
    case("csr_spmm", adj, S_COLS, S_ROWS, X, f"adjoint {shape} k={S_SKETCH} (the sketch)",
         cols=256, segments=True)
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

    # the ragged operands: every schedule checked, whole and in segments;
    # the wrapper's own (its plan built beforehand) timed, and beside it
    # every row whole and each segment length
    for name, operand in (("ragged", ragged_csr()), ("ragged rows", ragged_rows_csr())):
        values, indices, indptr, n_cols = operand
        n_rows = len(indptr) - 1
        v64 = torch.from_numpy(values).to(dev)
        p, c = torch.from_numpy(indptr).to(dev), torch.from_numpy(indices).to(dev)
        plan = kernel_cuda.csr_plan(p)
        empty = torch.from_numpy(np.diff(indptr) == 0).to(dev)
        for k in (1, 3, 10, 300):
            kernel = "csr_spmv" if k == 1 else "csr_spmm"
            fn = getattr(kernel_cuda, kernel)
            X = torch.randn((n_cols, k), generator=gen, device=dev, dtype=torch.float64)
            ref = sops._plain(v64, p, c, X, n_rows, False)
            what = f"{name} n={n_rows} m={n_cols} nnz={v64.numel()} k={k}"
            for lanes in (CSR_SCHEDULES if k <= 16 else (None,)):
                for segmented in (False, True):
                    sched = what + ("" if lanes is None else f" lanes={lanes}") + (
                        " segmented" if segmented else " whole")
                    with csr_schedule(lanes, segmented):
                        for dtype, bound in ((torch.float32, CSR_F32_BOUND),
                                             (torch.float64, CSR_F64_BOUND)):
                            tag = f"{sched} {str(dtype)[6:]}"
                            got = same_bits(fn, (v64.to(dtype), p, c, X.to(dtype), n_rows, plan),
                                            f"{kernel} {tag}")
                            compare(kernel, got, ref, tag, bound)
                            check(bool(torch.all(got[empty] == 0)),
                                  f"{kernel} {tag}: empty rows 0")
            v32, X32 = v64.float(), X.float()
            lib = library_csr(v32, p, c, n_rows, n_cols)
            entry = timing_entry(
                kernel, what, cuda_ms(lambda: fn(v32, p, c, X32, n_rows, plan), inner=CSR_INNER),
                cuda_ms(lambda: sops._plain(v32, p, c, X32, n_rows, False)), n_rows,
                n_cols, 0, k, cd="float32", nnz=v32.numel(),
                library_ms=cuda_ms(lambda: lib @ X32, inner=CSR_INNER),
                lanes=kernel_cuda.spmm_lanes(n_rows - plan.n_long, v32.numel() - plan.long_nnz, k),
                segmented=kernel_cuda.csr_segmented(plan),
                ms_by_segment=by_segment(fn, v32, p, c, X32, n_rows, CSR_INNER, plan))
            timings[kernel].append(entry)
            print(f"time {kernel} {what}: kernel {entry['ms']:.4f} ms (lanes "
                  f"{entry['lanes']}, segmented {entry['segmented']}), plain "
                  f"{entry['plain_ms']:.3f} ms, cuSPARSE {entry['library_ms']:.4f} ms, bound "
                  f"{entry['bound_ms']:.4f} ms, by segment {entry['ms_by_segment']}")
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


# The exact pair (K4, K6: the register tile's pair form) is checked in every
# family at these widths: each KC it is built for (1, 2, 4, 16), a ragged
# one (3) and E2's probes' (10).
PAIR_KS = (1, 2, 3, 10, 16)


def pair_name(kind: str) -> str:
    return "laplace_pair" if kind == "laplace" else "gram_pair"


def exact_pair(kind, X1, X2, V2, V1, ls, c=1.0, operands=None):
    """K4, or K6 for Laplace."""
    from rlaopt_tpu_torch.ops import kernel_cuda

    if kind == "laplace":
        return kernel_cuda.laplace_pair(X1, X2, V2, V1, ls, c, operands)
    return kernel_cuda.gram_pair(kind, X1, X2, V2, V1, ls, c, operands)


def pair_checks(dev, compare, X1, X2, ls, what, c=1.0, seed=22, rows=None):
    """K4 and K6 in every family at ``PAIR_KS`` against float64: out1
    against the plain K1/K3 on (X1, X2, V2), out2 against it on (X2, X1,
    V1), V1 and V2 random and drawn apart (a mix-up of the two would pass
    at V1 = V2); all rows, or ``rows`` sampled rows of each output."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_plain

    n1, n2 = X1.shape[0], X2.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    W2, cols = concat_columns({k: torch.randn((n2, k), generator=gen, device=dev)
                               for k in PAIR_KS})
    W1, _ = concat_columns({k: torch.randn((n1, k), generator=gen, device=dev)
                            for k in PAIR_KS})
    i1 = i2 = slice(None)
    if rows is not None:
        i1 = torch.as_tensor(sampled_rows(n1, min(rows, n1), seed + 1), device=dev)
        i2 = torch.as_tensor(sampled_rows(n2, min(rows, n2), seed + 2), device=dev)
        what += f" rows {rows}"
    for kind in SQDIST_KINDS + ("laplace",):
        r1 = kernel_plain.gram_matmat_f64(kind, X1[i1], X2, W2, ls, c, row_block=1024)
        r2 = kernel_plain.gram_matmat_f64(kind, X2[i2], X1, W1, ls, c, row_block=1024)
        for k in PAIR_KS:
            o1, o2 = exact_pair(kind, X1, X2, W2[:, cols[k]], W1[:, cols[k]], ls, c)
            shape = f"{kind} {what} n1={n1} n2={n2} d={X1.shape[1]} k={k}"
            compare(pair_name(kind), o1[i1], r1[:, cols[k]], f"{shape} out1", K_BOUND)
            compare(pair_name(kind), o2[i2], r2[:, cols[k]], f"{shape} out2", K_BOUND)


def pair_ragged(dev, compare):
    """K4 and K6 (every family, :func:`pair_checks`) at the ragged shapes
    X1 1000 x 3, X2 777 x 3 (lengthscale 1.3) and X1 530 x 28, X2 700 x 28
    (n1 < n2, lengthscale 5.3); K4b (both tiers) against float64 and
    against its tier's plain version at the first (k = 1, 2, 3, 16, V1 and
    V2 drawn apart), then against its tier's plain version at the HIGGS
    width (X1 700 x 28, X2 530 x 28, lengthscale 5.3), its one-pass mirror
    at k >= 3 held to ``reround_bound``."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
    from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand

    A1, A2, _, _ = (torch.from_numpy(a).to(dev) for a in ragged_data())
    pair_checks(dev, compare, A1, A2, 1.3, "ragged", c=0.9, seed=40)
    for k in (1, 2, 3, 16):
        V2, V1 = (torch.from_numpy(a).to(dev) for a in pair_ragged_rhs(k))
        what = f"n1=1000 n2=777 d=3 k={k}"
        for kind in SQDIST_KINDS:
            r1, r2 = kernel_plain.gram_pair(kind, A1.double(), A2.double(), V2.double(),
                                            V1.double(), 1.3, 0.9)
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
    rng = np.random.default_rng(5)
    B1, B2 = (torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32)).to(dev)
              for n in (700, 530))
    pair_checks(dev, compare, B2, B1, 5.3, "ragged", c=0.9, seed=41)
    for k in (1, 2, 3, 16):
        V2, V1 = (torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dev)
                  for n in (530, 700))
        what = f"n1=700 n2=530 d={D} k={k}"
        for kind in SQDIST_KINDS:
            for cd in TIERS:
                P1, P2 = tier_operand(B1 / 5.3, cd), tier_operand(B2 / 5.3, cd)
                o1, o2 = kernel_cuda.gram_pair_tier(kind, P1, P2, V2, V1, 0.9)
                t1, t2 = kernel_plain.gram_pair_tier(kind, P1, P2, V2, V1, 0.9)
                reround = cd == "bfloat16" and k >= 3
                compare("gram_pair_tier", o1, t1, f"{cd} {kind} {what} out1 vs its tier",
                        TIER_BOUND)
                compare("gram_pair_tier", o2, t2, f"{cd} {kind} {what} out2 vs its tier",
                        reround_bound(V1, t2, 0.9) if reround else TIER_BOUND)
                if reround:
                    e, steps, rest = reround_steps(kernel_plain._tier_values(kind, P1, P2),
                                                   V1, o2, t2, 0.9)
                    print(f"reround gram_pair_tier {cd} {kind} {what} out2: largest error "
                          f"{e:.3e}, nearest sum of <= 2 re-rounding steps {steps:.3e}, "
                          f"rest {rest:.1e} (of max|ref|)")
                    check(rest <= TIER_BOUND, f"gram_pair_tier {kind} {what}: the mirror's "
                          "largest error is re-rounding")


def pair_timed(dev, X1, X2, compare, timings, what, kind, ls, ks, rows=None):
    """The exact pair at a path's shard shape (X1, X2: two shards): every
    family checked (:func:`pair_checks`), all rows or ``rows`` sampled rows
    of each output; then the path's family timed at each of ``ks`` on the
    operands the half-ring keeps, and its plain version at the first."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain

    t0 = time.perf_counter()
    pair_checks(dev, compare, X1, X2, ls, what, rows=rows)
    kname = pair_name(kind)
    n1, n2 = X1.shape[0], X2.shape[0]
    XT1, XT2 = kernel_cuda.tile_operand(X1, ls), kernel_cuda.tile_operand(X2, ls)
    gen = torch.Generator(device=dev).manual_seed(29)
    for k in ks:
        V2 = torch.randn((n2, k), generator=gen, device=dev)
        V1 = torch.randn((n1, k), generator=gen, device=dev)
        # 20 calls a timing: a call of a fraction of a millisecond
        ms = cuda_ms(lambda: exact_pair(kind, X1, X2, V2, V1, ls, 1.0, lambda: (XT1, XT2)),
                     inner=20)
        p_ms = None
        if k == ks[0]:
            p_ms = cuda_ms(lambda: kernel_plain.gram_pair(kind, X1, X2, V2, V1, ls,
                                                          row_block=BLOCK), reps=1, warm=False)
        shape = f"{what} n1={n1} n2={n2} d={X1.shape[1]} k={k}"
        timings.setdefault(kname, []).append(
            timing_entry(kname, shape, ms, p_ms, n1, n2, X1.shape[1], k, kind))
        print(f"time {kname} {shape}: kernel {ms:.4f} ms, plain "
              + (f"{p_ms:.3f} ms" if p_ms is not None else "not timed")
              + f", bound {timings[kname][-1]['bound_ms']:.4f} ms "
              f"(checks and times {time.perf_counter() - t0:.3f} s)")


def pair_at(dev, X1, X2, compare, timings, what, ls, cd, rows):
    """K4b at a path's shard shape (X1, X2: two shards) at k = 1, 3, 16
    against float64 and its tier's plain version on ``rows`` sampled rows
    of each output; then the kernel and its plain version timed at k = 1."""
    import torch

    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain
    from rlaopt_tpu_torch.ops.kernel_tiers import tier_operand

    kname, kind = "gram_pair_tier", "rbf"
    n1, n2 = X1.shape[0], X2.shape[0]
    gen = torch.Generator(device=dev).manual_seed(22)
    P1, P2 = tier_operand(X1 / ls, cd), tier_operand(X2 / ls, cd)

    def kernel(V2, V1):
        return kernel_cuda.gram_pair_tier(kind, P1, P2, V2, V1)

    def plain(V2, V1):
        return kernel_plain.gram_pair_tier(kind, P1, P2, V2, V1, row_block=BLOCK // 4)

    t0 = time.perf_counter()
    for k in (1, 3, 16):
        V2 = torch.randn((n2, k), generator=gen, device=dev)
        V1 = torch.randn((n1, k), generator=gen, device=dev)
        o1, o2 = kernel(V2, V1)
        shape = f"{what} n1={n1} n2={n2} d={X1.shape[1]} k={k}"
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
    shape = f"{what} n1={n1} n2={n2} d={X1.shape[1]} k=1 {cd}"
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


def certified_route(name, used, P, f64=True):
    """A path's certified calls on the half-ring, from its launch counts:
    per compensated call P triangle launches and P(P − 1)/2 pair launches,
    per float64 call (``f64``) P K7 and P(P − 1)/2 float64 pairs, and no
    general launch."""
    pairs = P * (P - 1) // 2
    routes = [("gram_matvec_symmetric_comp", "gram_pair_comp", "gram_matmat_comp")]
    if f64:
        routes.append(("gram_matvec_symmetric_f64", "gram_pair_f64", "gram_matmat_f64"))
    for tri, pair, general in routes:
        calls = used[tri] // P
        check(calls > 0 and used[tri] == P * calls and used[pair] == pairs * calls
              and used[general] == 0 and used.get("laplace_matmat_comp", 0) == 0,
              f"{name}'s certified calls ran on the half-ring: {used[tri]} {tri} and "
              f"{used[pair]} {pair} launches ({calls} calls of {P} and {pairs}), "
              f"{used[general]} {general}")


def certified_launches(name, K, v, P):
    """One call of each certified route of a half-ring operator, its
    launches against the schedule's: P triangle and P(P − 1)/2 pair
    launches each."""
    from rlaopt_tpu_torch.ops import kernel_cuda

    pairs = P * (P - 1) // 2
    for route, tri, pair in (("matmat_compensated", "gram_matvec_symmetric_comp",
                              "gram_pair_comp"),
                             ("matmat_f64", "gram_matvec_symmetric_f64", "gram_pair_f64")):
        before = kernel_cuda.launch_counts()
        getattr(K, route)(v)
        used = used_since(before)
        print(f"{name} one {route}: launches {used}")
        check(used == {tri: P, pair: pairs}, f"{name}'s {route} launches equal the half-ring's")


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
            check(used["gram_matvec_symmetric_f64"] > 0 and used["gram_pair_f64"] > 0,
                  f"{name} refinement ran through K7 and K8's pair form")
            rec.update({"refine": ref, "refined_independent": indep})
        return rec

    # E1: config 5 as written, one position (make_mesh() on the one card):
    # the replicated row slab, K1 for every product, K1c at the boundaries
    K1 = ShardedRBFLinOp(X, X, KernelConfig(lengthscale=ls), mesh=make_mesh())
    rec = config5("E1", K1, refine=False)
    used = rec["launches"]
    check(used["gram_matmat"] >= rec["iters"] + LANCZOS5 + 2, "E1 ran through K1")
    check(used["gram_matmat_comp"] >= 1 and used["gram_matvec_symmetric_comp"] == 0,
          "E1 boundaries ran through the general K1c")
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
    certified_route("E2", used, P_RING)
    check(abs(rec2["lambda_max"] - rec["lambda_max"]) <= 1e-4 * rec["lambda_max"],
          "E2's lambda_max within 1e-4 of E1's (the same start vector)")
    records["E2"] = rec2
    # one matvec: its launches, against the unsharded operator (K2) and
    # float64; then both timed in turns (ring, flat, flat, ring)
    v = torch.randn((N5, 1), generator=torch.Generator(device=dev).manual_seed(25), device=dev)
    Kflat = RBFLinOp(X, X, KernelConfig(lengthscale=ls))
    ring_out = matvec_launches("E2", K2, v, {"gram_matvec_symmetric": P_RING,
                                             "gram_pair": pairs})
    certified_launches("E2", K2, v, P_RING)
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
    # K4 and K6 at E2's shard shape (two shards of 12,500 points), checked on
    # all rows; K4 timed at k = 1, 10, 16
    loc = N5 // P_RING
    pair_timed(dev, X[:loc], X[loc:2 * loc], compare, timings, "E2 shards", "rbf", ls,
               (1, 10, 16))
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
    with profile_run() as prof:
        t0 = time.perf_counter()
        sys3 = LinSys(K3, Y100, reg=reg3)
        _, log3 = sys3.solve(cfg3, torch.zeros((n, 1), device=dev), callback_freq=FREQ, key=0,
                             callback_fn=lambda w, _model: iterates.append(w.clone()))
        torch.cuda.synchronize()
        wall3 = time.perf_counter() - t0
    used3 = kernel_cuda.launch_counts()
    profile3 = device_breakdown(prof) if prof else {}
    lpairs = P_LAPLACE * (P_LAPLACE - 1) // 2
    # every logged iterate's float64 residual through K7 (one sweep)
    W64 = torch.cat([w.double() for w in iterates[1:]], 1)
    y64 = Y100.double()[:, None]
    R = y64 - (kernel_cuda.gram_matvec_symmetric_f64("laplace", X100, W64, LS_B) + reg3 * W64)
    rel64 = (torch.linalg.norm(R, dim=0) / torch.linalg.norm(y64)).cpu().numpy()
    gaps3 = residual_gaps("E3", log3, iterates, rel64)
    keys3 = int_keys(log3)
    check(used3["laplace_pair"] >= lpairs * keys3[-1], "E3's pairs ran through K6")
    check(used3["laplace_matmat"] >= P_LAPLACE + 2 * lpairs,
          "E3's sketch ran through the wide K3 (diagonal blocks and the pairs' general calls)")
    certified_route("E3", used3, P_LAPLACE, f64=False)
    rec3 = {"n": n, "positions": P_LAPLACE, "wall_s": wall3, "phase_walls": sys3.phase_walls,
            "iters": keys3[-1], "s_per_iter": sys3.phase_walls["train"] / keys3[-1],
            "rel_res": {i: log3[i]["metrics"]["internal_metrics"]["rel_res"].tolist()
                        for i in keys3}, "gaps": gaps3, "launches": used3, "profile": profile3,
            "busy_share": (None if profile3.get("busy_ms") is None
                           else profile3["busy_ms"] / 1e3 / wall3)}
    v = torch.randn((n, 1), generator=torch.Generator(device=dev).manual_seed(26), device=dev)
    ring_out = matvec_launches("E3", K3, v, {"laplace_matvec_symmetric": P_LAPLACE,
                                             "laplace_pair": lpairs})
    certified_launches("E3", K3, v, P_LAPLACE)
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
    pair_timed(dev, X100[:loc], X100[loc:2 * loc], compare, timings, "E3 shards", "laplace",
               LS_B, (1, 10), rows=4096)
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
    pair_at(dev, X6[:loc], X6[loc:2 * loc], compare, timings, "E4 shards", ls, "bf16x3", 4096)
    print(f"phase: slice 5 E4 done at {time.perf_counter() - t_phase:.1f} s into it")
    return records


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from rlaopt_tpu_torch.kernels import KernelConfig, RBFLinOp
    from rlaopt_tpu_torch.models import LinSys
    from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain, probes
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
    # the kernels redesigned for Hopper: K2b and #9's short-row schedule, K1b's
    # forward strip and wide kernel, K4b's pair strip, the float64 triangle
    # (K1c and K3c's triangle form, K7), K3's tile; and the probes
    registers = ptxas_report(lib.with_suffix(".log").read_text(), REDESIGNED)
    print("registers " + json.dumps(registers))
    check(all(registers_of(kname, registers) for kname in REGISTERS_OF)
          and all("registers" in r for r in registers.values()),
          "the build log reports the registers of every redesigned kernel")

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
    names = ("gram_matmat", "gram_matmat_comp", "gram_matvec_symmetric_comp",
             "gram_matvec_symmetric",
             "gram_matmat_tier", "gram_matvec_symmetric_tier", "gram_matmat_f64",
             "gram_matvec_symmetric_f64", "laplace_matmat", "laplace_matmat_narrow",
             "laplace_matmat_comp", "laplace_matvec_symmetric", "csr_spmv", "csr_spmm",
             "gram_pair", "gram_pair_tier", "laplace_pair", "gram_pair_comp", "gram_pair_f64",
             *PROBES)
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

    # 2b. the ceilings: the probes (TPU #10-#13), counted on their own
    timings = {}
    rec_ceil = ceilings(dev, compare, timings)
    print(f"phase: ceilings done at {time.perf_counter() - t_start:.1f} s")

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
    for k in (1, 10):
        hi, lo = kernel_cuda.gram_matvec_symmetric_comp("rbf", X, Vs[k], ls)
        compare("gram_matvec_symmetric_comp", hi.double() + lo.double(), refs[k],
                f"n={N} d={D} k={k} (hi+lo)", COMP_BOUND)
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
        hi, lo = kernel_cuda.gram_matvec_symmetric_comp(kind, A1, S7, 1.3, 0.9)
        compare("gram_matvec_symmetric_comp", hi.double() + lo.double(),
                kernel_plain.gram_matmat_f64(kind, A1, A1, S7, 1.3, 0.9),
                f"{kind} n=1000 d=3 k=7 (hi+lo)", COMP_BOUND)
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
    # K7, the reference of every certified residual below, at every width
    # of its slices (1, 2, 4 right-hand sides a slice; 5, 10 and 16 in 2,
    # 3 and 4 slices) and both kinds of lengthscale
    ard3 = torch.tensor([0.9, 1.3, 2.1], dtype=torch.float64, device=dev)
    rng7 = np.random.default_rng(70)
    for k in (1, 2, 4, 5, 10, 16):
        V7 = torch.from_numpy(rng7.standard_normal((A1.shape[0], k))).to(dev)
        for kind in SQDIST_KINDS + ("laplace",):
            for ls_name, ls7 in (("scalar", 1.3), ("ARD", ard3)):
                compare("gram_matvec_symmetric_f64",
                        kernel_cuda.gram_matvec_symmetric_f64(kind, A1, V7, ls7, 0.9),
                        kernel_plain.gram_matmat_f64(kind, A1, A1, V7, ls7, 0.9),
                        f"{kind} n=1000 d=3 k={k} {ls_name} lengthscale", COMP_BOUND)
    del refs

    # The first shape of each kernel is the one its JSON entry reports. K1
    # and K2 on the tile's operand that the operator of slice 1 keeps.
    XT = kernel_cuda.tile_operand(X, ls)

    def kernel_and_plain(kernel, k, cd=None):
        V = Vs[k]
        P = parts.get(cd)
        V64 = V.double()
        return {
            "gram_matmat": (lambda: kernel_cuda.gram_matmat("rbf", X, X, V, ls, 1.0,
                                                            lambda: (XT, XT)),
                            lambda: kernel_plain.gram_matmat("rbf", X, X, V, ls, row_block=BLOCK)),
            "gram_matvec_symmetric": (
                lambda: kernel_cuda.gram_matvec_symmetric("rbf", X, V, ls, 1.0, XT),
                lambda: kernel_plain.gram_matvec_symmetric("rbf", X, V, ls, row_block=BLOCK)),
            "gram_matmat_comp": (
                lambda: kernel_cuda.gram_matmat_comp("rbf", X, X, V, ls),
                lambda: kernel_plain.gram_matmat_comp("rbf", X, X, V, ls, col_block=BLOCK)),
            "gram_matvec_symmetric_comp": (
                lambda: kernel_cuda.gram_matvec_symmetric_comp("rbf", X, V, ls),
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

    # K7's plain version is K8's on (X, X), the same call: timed once per k
    # (13.5 s a run at this shape), for both rows.
    plain_f64_ms = {}
    for kernel, k, cd in (
        ("gram_matmat", 500, None), ("gram_matmat", 1, None), ("gram_matmat", 10, None),
        ("gram_matmat", 16, None),
        ("gram_matvec_symmetric", 1, None), ("gram_matvec_symmetric", 10, None),
        ("gram_matvec_symmetric", 16, None),
        ("gram_matmat_comp", 1, None), ("gram_matmat_comp", 10, None),
        ("gram_matvec_symmetric_comp", 1, None), ("gram_matvec_symmetric_comp", 10, None),
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
        if kernel == "gram_matvec_symmetric_comp":
            # the general K1c on the same call, timed just before
            entry["general_ms"] = next(t["ms"] for t in timings["gram_matmat_comp"]
                                       if t["k"] == k)
            line += f", general K1c {entry['general_ms']:.3f} ms"
        timings.setdefault(kernel, []).append(entry)
        print(line)
    # K1b at k = 500 once more, a minute after its first timing: the spread
    # within one run
    again = cuda_ms(kernel_and_plain("gram_matmat_tier", 500, "bf16x3")[0])
    timings["gram_matmat_tier"][0]["ms_again"] = again
    print(f"time gram_matmat_tier n={N} d={D} k=500 bf16x3 again: kernel {again:.3f} ms")
    # A yardstick of the tensor cores, measured here and never called by the
    # port: one bf16 torch.matmul of 8192^3. K1b's tensor-core work over
    # this rate is its ceiling as measured (matmul_ceiling_ms, step 10),
    # beside bound_ms from the data sheet.
    A8, B8 = (torch.randn((8192, 8192), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    mm_ms = cuda_ms(lambda: torch.matmul(A8, B8), reps=10)
    mm_rate = 2 * 8192**3 / (mm_ms * 1e-3)
    print(f"yardstick bf16 torch.matmul 8192^3: {mm_ms:.3f} ms, {mm_rate / 1e12:.1f} TFLOP/s "
          f"(data sheet {PEAK['bf16_tc'] / 1e12:.0f})")
    del A8, B8
    laplace_kernels(dev, X, compare, timings)
    print(f"phase: Laplace kernels done at {time.perf_counter() - t_start:.1f} s")
    sqdist_kernels(dev, X, compare, timings)
    comp_forms(dev, X, compare, timings)
    print(f"phase: the float64 tile's forms done at {time.perf_counter() - t_start:.1f} s")
    del XT
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
        check(used["gram_matvec_symmetric_comp"] > 0 and used["gram_matmat_comp"] == 0,
              f"k={k} residuals ran through K1c's triangle form")
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

    # the ported utils (checkpoint and resume, sketches, trace, Profiler,
    # debug_nans) on slice 1's operator
    rec_utils = ported_utils(dev, K, X, Y1, reg)
    print(f"phase: utils done at {time.perf_counter() - t_start:.1f} s")

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

    # 9b. config 8: accelerated SAP, certified
    torch.cuda.empty_cache()
    rec8 = config8(dev, profiled)
    print(f"phase: config 8 done at {time.perf_counter() - t_start:.1f} s")

    # 10. result lines
    kernels = []
    for e in timings["gram_matmat_tier"]:
        tc = tier_tc_ops(float(e["n"]) * e["m"], 2.0 * e["k"] * e["n"] * e["m"], e["d"], e["k"],
                         e["cd"])
        e["matmul_ceiling_ms"] = tc / mm_rate * 1e3
        print(f"share gram_matmat_tier {e['shape']}: {e['bound_ms'] / e['ms']:.1%} of bound_ms "
              f"({e['bound_by']}), tensor cores {e['matmul_ceiling_ms'] / e['ms']:.1%} of the "
              f"measured bf16 matmul rate")
    comp = timings["gram_matmat_comp"][0]
    comp["plain_f32_twosum_rel_err"] = twosum_f32_rel
    ceiling_shares(timings, rec_ceil["rates"], rec_ceil["pipes"])
    paths = {"ceilings": rec_ceil["launches"], "slice1": counts_slice1, "config6": ns["launches"],
             "slice3": counts_slice3,
             "config4_laplace": rec_a["launches"], "config4": rec_a2["launches"],
             "slice4_sparse": rec_s["launches"], "config2": rec_c2["launches"],
             **{path: rec["launches"] for path, rec in rec5.items()},
             "utils": rec_utils["launches"], "config8": rec8["launches"]}
    for kname, source, replaces in (
        ("gram_matmat", SOURCES["gram"], f"{PALLAS}:733"),
        ("gram_matmat_comp", SOURCES["comp"], f"{PALLAS}:733"),
        ("gram_matvec_symmetric_comp", SOURCES["comp"], f"{PALLAS}:733"),
        ("gram_matvec_symmetric", SOURCES["gram"], f"{PALLAS}:1366"),
        ("gram_matmat_tier", SOURCES["tier"], f"{PALLAS}:733"),
        ("gram_matvec_symmetric_tier", SOURCES["tier"], f"{PALLAS}:1366"),
        ("gram_matvec_symmetric_f64", SOURCES["comp"], f"{VALUE64}:467"),
        ("gram_matmat_f64", SOURCES["comp"], f"{VALUE64}:684"),
        ("laplace_matmat_narrow", SOURCES["laplace"], f"{PALLAS}:592"),
        ("laplace_matmat", SOURCES["wide"], f"{PALLAS}:592"),
        ("laplace_matmat_comp", SOURCES["comp"], f"{PALLAS}:592"),
        ("laplace_matvec_symmetric", SOURCES["laplace"], f"{PALLAS}:1930"),
        ("csr_spmv", SOURCES["spmv"], f"{LANED}:136"),
        ("csr_spmm", SOURCES["spmv"], f"{LANED}:136"),
        ("gram_pair", SOURCES["pair"], f"{PALLAS}:1563"),
        ("gram_pair_tier", SOURCES["tier"], f"{PALLAS}:1563"),
        ("laplace_pair", SOURCES["pair"], f"{PALLAS}:2063"),
        ("gram_pair_comp", SOURCES["comp"], f"{PALLAS}:733"),
        ("gram_pair_f64", SOURCES["comp"], f"{VALUE64}:684"),
        *((kname, SOURCES["probes"], tpu) for kname, (tpu, _) in PROBES.items()),
    ):
        main_t = timings[kname][0]
        vs_f64 = errors[(kname, "float64")]
        by_path = {path: counts.get(kname, 0) for path, counts in paths.items()}
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
        if kname == "gram_matmat_tier":
            kernels[-1]["matmul_tflops"] = mm_rate / 1e12
        if kname == "gram_matmat":
            kernels[-1]["sources"] = [SOURCES["gram"], SOURCES["wide"], SOURCES["tile"]]
        if kname in ("gram_matvec_symmetric", "laplace_matmat_narrow", "laplace_matmat",
                     "laplace_matvec_symmetric", "gram_pair", "laplace_pair"):
            kernels[-1]["sources"] = [source, SOURCES["tile"]]
        mine = registers_of(kname, registers)
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
