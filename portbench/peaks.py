"""The least time of a Gram product on an H100: a frozen copy of
``chip_smoke.py``'s ``bound_ms`` and ``tier_tc_ops``, with the peaks and
the kernel lists they read.

It is copied here so that a later change to the program cannot move the
yardstick. The benchmark names an operation by the wrapper that carries it
(``gram_matvec_symmetric`` for the exact symmetric matvec,
``gram_matvec_symmetric_tier`` for a bf16 tier's, ``gram_matmat`` for the
general product); the count is of the operation's work at its shapes, so a
kernel that later replaces the wrapper's is held to the same bound.
"""

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
COMP_KERNELS = ("gram_matmat_comp", "gram_matvec_symmetric_comp", "laplace_matmat_comp",
                "gram_pair_comp")
F64_KERNELS = ("gram_matmat_f64", "gram_matvec_symmetric_f64", "gram_pair_f64")
TIER_KERNELS = ("gram_matmat_tier", "gram_matvec_symmetric_tier", "gram_pair_tier")
PAIR_KERNELS = ("gram_pair", "gram_pair_tier", "laplace_pair", "gram_pair_comp",
                "gram_pair_f64")
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
