"""Hand-written CUDA kernels: build, ctypes binding, checked wrappers.

Counterpart of ``rlaopt_tpu/ops/kernel_pallas.py`` (exact f32 tier,
compensated tier, bf16 tiers, the Laplace kernels),
``rlaopt_tpu/ops/kernel_value64.py`` (float64 route) and
``rlaopt_tpu/sparse/laned.py`` (the sparse CSR product). The kernels live in
``csrc/gram.cu`` (K1, K1c, K2), ``csrc/gram_laplace.cu`` (K3, K3c, K5),
``csrc/gram_tier.cu`` (K1b, K2b), ``csrc/gram_f64.cu`` (K8, K7),
``csrc/gram_pair.cu`` (the pair kernels K4, K4b, K6), with their shared
pieces in ``csrc/gram_common.cuh``, and ``csrc/spmv.cu`` (the
CSR SpMV/SpMM; see the note at the top of each). :func:`build` compiles
each source with ``nvcc`` for ``sm_90a`` in parallel and links them into
one shared library with a plain C interface, cached under ``build/`` at the
repository root by a hash of the sources and the flags. Nothing is compiled
or loaded on import.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream, raises if
the launch reports an error, and adds one to its ``launches`` counter. It
takes CUDA tensors only: everything else raises (the dispatchers in
:mod:`rlaopt_tpu_torch.ops.kernel_dispatch` and
:mod:`rlaopt_tpu_torch.sparse.ops` send CPU tensors to the plain versions).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..kernels.functions import scale_inputs
from .kernel_tiers import TierOperand, norms_and_operands


__all__ = [
    "build",
    "gram_matmat",
    "gram_matmat_comp",
    "gram_matvec_symmetric",
    "gram_matmat_tier",
    "gram_matvec_symmetric_tier",
    "gram_matmat_f64",
    "gram_matvec_symmetric_f64",
    "laplace_matmat",
    "laplace_matmat_comp",
    "laplace_matvec_symmetric",
    "gram_pair",
    "gram_pair_tier",
    "laplace_pair",
    "csr_spmv",
    "csr_spmm",
    "column_splits",
    "spmm_lanes",
    "launch_counts",
    "reset_launch_counts",
    "KIND_CODES",
]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("gram.cu", "gram_laplace.cu", "gram_tier.cu", "gram_f64.cu", "gram_pair.cu",
           "spmv.cu")
_HEADERS = ("gram_common.cuh",)
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c",
)
# Kernel family codes of csrc/gram_common.cuh. The float32 Laplace kernels
# have wrappers of their own (laplace_*); the float64 ones take the code.
KIND_CODES = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3, "laplace": 4}
SYMMETRIC_MAX_K = 16
# csrc/spmv.cu keeps up to 16 right-hand sides of a row in registers.
CSR_NARROW_MAX_K = 16
# Its short-row schedule: L lanes a row, L a power of two in [2, 32], about
# this many entries a lane; from this mean row length on a block of
# CSR_BLOCK_ROW threads takes a row (the C interface's lanes value 256).
CSR_ENTRIES_PER_LANE = 4
CSR_BLOCK_ROW = 256

_lock = threading.Lock()
_lib = {"handle": None, "path": None}

_vp, _ci, _cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "rl_gram_matmat": [
        _ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_matmat_comp": [
        _ci, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_matvec_symmetric": [_ci, _vp, _vp, _vp, _ci, _ci, _ci, _cd, _vp],
    "rl_gram_matmat_tier": [
        _ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
        _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_matvec_symmetric_tier": [
        _ci, _ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_matmat_f64": [
        _ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_matvec_symmetric_f64": [
        _ci, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_laplace_matmat": [_vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _cd, _vp],
    "rl_laplace_matmat_comp": [
        _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_laplace_matvec_symmetric": [_vp, _vp, _vp, _ci, _ci, _ci, _cd, _vp],
    "rl_gram_pair": [_ci, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _cd, _vp],
    "rl_gram_pair_tier": [
        _ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
        _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_laplace_pair": [_vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _cd, _vp],
    "rl_csr_spmm": [
        _ci, _vp, _vp, _vp, _vp, _vp, ctypes.c_longlong, ctypes.c_longlong, _ci, _ci, _vp,
    ],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _run_all(commands):
    """Start every command at once, wait for all; ``(returncode, output)``
    of each, in order."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in commands
    ]
    outputs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outputs)]


def build() -> Path:
    """Compile the CUDA sources (once per hash) and load the library.

    Each source is compiled by its own ``nvcc``, all started together, and
    the objects are linked into ``build/gram-<hash>.so``. Returns the path
    of the library. The compiler's output (``-Xptxas -v``: registers and
    shared memory per kernel) is kept beside it as ``<library>.log``.
    """
    with _lock:
        if _lib["handle"] is not None:
            return _lib["path"]
        digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
        for name in SOURCES + _HEADERS:
            digest.update(name.encode() + (_CSRC / name).read_bytes())
        path = _BUILD_DIR / f"gram-{digest.hexdigest()[:16]}.so"
        if not path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tag = f"{path.stem}.{os.getpid()}"
            objs = [_BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
            nvcc = _nvcc()
            results = _run_all(
                [nvcc, *COMPILE_FLAGS, "-o", str(o), str(_CSRC / s)]
                for s, o in zip(SOURCES, objs)
            )
            log = "".join(f"== {s}\n{out}" for s, (_, out) in zip(SOURCES, results))
            failed = [s for s, (rc, _) in zip(SOURCES, results) if rc != 0]
            if not failed:
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                (rc, out), = _run_all(
                    [[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]]
                )
                log += f"== link\n{out}"
                if rc != 0:
                    failed = ["link"]
            path.with_suffix(".log").write_text(log)
            for o in objs:
                o.unlink(missing_ok=True)
            if failed:
                raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _ci
        _lib["handle"], _lib["path"] = lib, path
        return path


def _code(kind: str, laplace: bool = False) -> int:
    """The family code; the squared-distance kernels (K1, K1c, K2 and the
    tiers) refuse Laplace, whose float32 kernels are the laplace_* wrappers."""
    if kind not in KIND_CODES:
        raise ValueError(f"Unknown kernel kind {kind!r}")
    if kind == "laplace" and not laplace:
        raise NotImplementedError(
            "this kernel sums squared distances: the Laplace family takes "
            "laplace_matmat, laplace_matmat_comp, laplace_matvec_symmetric or "
            "laplace_pair (the port of kernel_pallas.py::_laplace_matmat and "
            "its kin), or the float64 kernels"
        )
    return KIND_CODES[kind]


def _check_tensors(dtypes, *tensors: torch.Tensor):
    """Every tensor on one CUDA device, each of the dtype at its place."""
    dev = tensors[0].device
    for t, dtype in zip(tensors, dtypes):
        if not t.is_cuda:
            raise ValueError("the CUDA Gram kernels take CUDA tensors only")
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise NotImplementedError(
                f"this CUDA Gram kernel takes {dtype} here, got {t.dtype}"
            )


def _check_shapes(X1, X2, V):
    """V as a contiguous 2-D tensor, and whether it was 1-D."""
    squeeze = V.ndim == 1
    V2 = (V[:, None] if squeeze else V).contiguous()
    if X1.ndim != 2 or X2.ndim != 2 or X1.shape[1] != X2.shape[1]:
        raise ValueError(f"X1 {tuple(X1.shape)} and X2 {tuple(X2.shape)}")
    if V2.ndim != 2 or V2.shape[0] != X2.shape[0]:
        raise ValueError(f"V {tuple(V.shape)} does not match X2 {tuple(X2.shape)}")
    if min(X1.shape[0], X2.shape[0], X1.shape[1], V2.shape[1]) < 1:
        raise ValueError("empty operand")
    if X1.numel() >= 2**31 or X2.numel() >= 2**31 or V2.numel() >= 2**31:
        raise ValueError("operands past 2^31 elements")
    return V2, squeeze


def _scaled(X1, X2, lengthscale):
    """The contiguous operands of K1 and K2: X / lengthscale in float32."""
    Xs = scale_inputs(X1, lengthscale).contiguous()
    return Xs, Xs if X2 is X1 else scale_inputs(X2, lengthscale).contiguous()


def _inv_lengthscale(lengthscale, d: int, device) -> torch.Tensor:
    """(d,) float64 inverse lengthscale for K1c, K7 and K8."""
    ls = torch.as_tensor(lengthscale, dtype=torch.float64, device=device)
    if ls.ndim > 1 or ls.numel() not in (1, d):
        raise ValueError(f"lengthscale of shape {tuple(ls.shape)} for d = {d}")
    return (1.0 / ls).expand(d).contiguous()


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def column_splits(n: int, m: int, k: int, device) -> int:
    """Runs of the m axis for the narrow kernel of K1 and K3 (k ≤ 16): when
    the 64-row tiles of n give fewer than four blocks per SM, enough runs
    for four, each of at least 16 column tiles; 1 otherwise."""
    if k > SYMMETRIC_MAX_K:
        return 1
    rows, tiles = -(-n // 64), -(-m // 64)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-4 * sms // rows), tiles // 16))


def _matmat_launch(entry, lead, X1, X2, V, lengthscale, const_scaling):
    """K1 or K3: check, scale, launch with its column splits; the output.
    ``lead``: the entry point's arguments before the pointers (K1's family
    code)."""
    _check_tensors((torch.float32,) * 3, X1, X2, V)
    V2, squeeze = _check_shapes(X1, X2, V)
    Xs, Ys = _scaled(X1, X2, lengthscale)
    build()
    (n, d), (m, k) = Xs.shape, V2.shape
    splits = column_splits(n, m, k, Xs.device)
    out = torch.empty((n, k), dtype=torch.float32, device=Xs.device)
    part = torch.empty((splits, n, k), dtype=torch.float32, device=Xs.device) if splits > 1 else None
    with torch.cuda.device(Xs.device):
        err = getattr(_lib["handle"], entry)(
            *lead, Xs.data_ptr(), Ys.data_ptr(), V2.data_ptr(), out.data_ptr(),
            _ptr(part), n, m, d, k, int(splits), float(const_scaling), _stream(Xs),
        )
    _raise_on(err, entry)
    return out[:, 0] if squeeze else out


def gram_matmat(kind, X1, X2, V, lengthscale, const_scaling=1.0):
    """K1: ``c·k(X1, X2) @ V`` (n, k) on the card, exact f32 tier; the m
    axis in :func:`column_splits` runs."""
    out = _matmat_launch("rl_gram_matmat", (_code(kind),), X1, X2, V, lengthscale,
                         const_scaling)
    gram_matmat.launches += 1
    return out


def gram_matmat_comp(kind, X1, X2, V, lengthscale, const_scaling=1.0):
    """K1c: ``c·k(X1, X2) @ V`` as ``(hi, lo)``; consumers add ``lo`` last.

    The kernel divides by the lengthscale itself, in float64: pass the
    unscaled points and the lengthscale at full precision.
    """
    code = _code(kind)
    _check_tensors((torch.float32,) * 3, X1, X2, V)
    V2, squeeze = _check_shapes(X1, X2, V)
    A1 = X1.contiguous()
    A2 = A1 if X2 is X1 else X2.contiguous()
    (n, d), (m, k) = A1.shape, V2.shape
    inv_ls = _inv_lengthscale(lengthscale, d, A1.device)
    build()
    out = torch.empty((n, k), dtype=torch.float32, device=A1.device)
    lo = torch.empty_like(out)
    with torch.cuda.device(A1.device):
        err = _lib["handle"].rl_gram_matmat_comp(
            code, A1.data_ptr(), A2.data_ptr(), V2.data_ptr(), inv_ls.data_ptr(),
            out.data_ptr(), lo.data_ptr(), n, m, d, k, float(const_scaling),
            _stream(A1),
        )
    _raise_on(err, "gram_matmat_comp")
    gram_matmat_comp.launches += 1
    return (out[:, 0], lo[:, 0]) if squeeze else (out, lo)


def gram_matvec_symmetric(kind, X, V, lengthscale, const_scaling=1.0):
    """K2: ``c·k(X, X) @ V`` for at most 16 columns, each tile pair once."""
    code = _code(kind)
    _check_tensors((torch.float32,) * 2, X, V)
    V2, squeeze = _check_shapes(X, X, V)
    Xs, _ = _scaled(X, X, lengthscale)
    n, d = Xs.shape
    k = V2.shape[1]
    if k > SYMMETRIC_MAX_K:
        raise ValueError(f"the triangle kernel takes k <= 16 columns (got {k})")
    build()
    out = torch.empty((n, k), dtype=torch.float32, device=Xs.device)
    with torch.cuda.device(Xs.device):
        err = _lib["handle"].rl_gram_matvec_symmetric(
            code, Xs.data_ptr(), V2.data_ptr(), out.data_ptr(), n, d, k,
            float(const_scaling), _stream(Xs),
        )
    _raise_on(err, "gram_matvec_symmetric")
    gram_matvec_symmetric.launches += 1
    return out[:, 0] if squeeze else out


def _check_tier(kind, *operands: TierOperand):
    code = _code(kind)
    tensors, dtypes = [], []
    for A in operands:
        parts = (A.hi,) if A.lo is None else (A.hi, A.lo)
        tensors += [*parts, A.sq]
        dtypes += [torch.bfloat16] * len(parts) + [torch.float32]
        if any(not p.is_contiguous() or p.shape != A.hi.shape for p in parts):
            raise ValueError("tier parts must be contiguous and of one shape")
        if A.hi.shape[1] % 16:
            raise ValueError(f"tier parts of depth {A.hi.shape[1]}, not a multiple of 16")
    if len({A.passes for A in operands}) != 1:
        raise ValueError("operands of two different tiers")
    _check_tensors(dtypes, *tensors)
    return code


def gram_matmat_tier(kind, A: TierOperand, B: TierOperand, V, const_scaling=1.0):
    """K1b: ``c·k(X1, X2) @ V`` on a bf16 tier from the parts of X1 (A) and
    X2 (B) (:func:`rlaopt_tpu_torch.ops.kernel_tiers.tier_operand`): float32
    contraction for k ≤ 16, the tier-matched tensor-core one past that."""
    code = _check_tier(kind, A, B)
    _check_tensors((torch.float32,), V)
    V2, squeeze = _check_shapes(A.hi, B.hi, V)
    if V2.device != A.hi.device:
        raise ValueError(f"tensors on {V2.device} and {A.hi.device}")
    _, hx, hy = norms_and_operands(kind, A, B)
    build()
    (n, dp), (m, k) = A.hi.shape, V2.shape
    out = torch.empty((n, k), dtype=torch.float32, device=V2.device)
    with torch.cuda.device(V2.device):
        err = _lib["handle"].rl_gram_matmat_tier(
            code, A.passes, A.hi.data_ptr(), _ptr(A.lo), hx.data_ptr(),
            B.hi.data_ptr(), _ptr(B.lo), hy.data_ptr(), V2.data_ptr(),
            out.data_ptr(), n, m, dp, k, float(const_scaling), _stream(V2),
        )
    _raise_on(err, "gram_matmat_tier")
    gram_matmat_tier.launches += 1
    return out[:, 0] if squeeze else out


def gram_matvec_symmetric_tier(kind, A: TierOperand, V, const_scaling=1.0):
    """K2b: ``c·k(X, X) @ V`` on a bf16 tier for at most 16 columns."""
    code = _check_tier(kind, A)
    _check_tensors((torch.float32,), V)
    V2, squeeze = _check_shapes(A.hi, A.hi, V)
    if V2.device != A.hi.device:
        raise ValueError(f"tensors on {V2.device} and {A.hi.device}")
    (n, dp), k = A.hi.shape, V2.shape[1]
    if k > SYMMETRIC_MAX_K:
        raise ValueError(f"the triangle kernel takes k <= 16 columns (got {k})")
    _, hx, _ = norms_and_operands(kind, A, A)
    build()
    out = torch.empty((n, k), dtype=torch.float32, device=V2.device)
    with torch.cuda.device(V2.device):
        err = _lib["handle"].rl_gram_matvec_symmetric_tier(
            code, A.passes, A.hi.data_ptr(), _ptr(A.lo), hx.data_ptr(),
            V2.data_ptr(), out.data_ptr(), n, dp, k, float(const_scaling),
            _stream(V2),
        )
    _raise_on(err, "gram_matvec_symmetric_tier")
    gram_matvec_symmetric_tier.launches += 1
    return out[:, 0] if squeeze else out


def gram_matmat_f64(kind, X1, X2, V, lengthscale, const_scaling=1.0):
    """K8: ``c·k(X1, X2) @ V`` in float64 from unscaled float32 points, a
    float64 lengthscale (scalar or ARD) and float64 V; float64 out. All
    five families."""
    code = _code(kind, laplace=True)
    _check_tensors((torch.float32, torch.float32, torch.float64), X1, X2, V)
    V2, squeeze = _check_shapes(X1, X2, V)
    A1 = X1.contiguous()
    A2 = A1 if X2 is X1 else X2.contiguous()
    (n, d), (m, k) = A1.shape, V2.shape
    inv_ls = _inv_lengthscale(lengthscale, d, A1.device)
    build()
    out = torch.empty((n, k), dtype=torch.float64, device=A1.device)
    with torch.cuda.device(A1.device):
        err = _lib["handle"].rl_gram_matmat_f64(
            code, A1.data_ptr(), A2.data_ptr(), inv_ls.data_ptr(), V2.data_ptr(),
            out.data_ptr(), n, m, d, k, float(const_scaling), _stream(A1),
        )
    _raise_on(err, "gram_matmat_f64")
    gram_matmat_f64.launches += 1
    return out[:, 0] if squeeze else out


def gram_matvec_symmetric_f64(kind, X, V, lengthscale, const_scaling=1.0):
    """K7: ``c·k(X, X) @ V`` in float64, each tile pair once; any k."""
    code = _code(kind, laplace=True)
    _check_tensors((torch.float32, torch.float64), X, V)
    V2, squeeze = _check_shapes(X, X, V)
    A = X.contiguous()
    (n, d), k = A.shape, V2.shape[1]
    inv_ls = _inv_lengthscale(lengthscale, d, A.device)
    build()
    out = torch.empty((n, k), dtype=torch.float64, device=A.device)
    with torch.cuda.device(A.device):
        err = _lib["handle"].rl_gram_matvec_symmetric_f64(
            code, A.data_ptr(), inv_ls.data_ptr(), V2.data_ptr(), out.data_ptr(),
            n, d, k, float(const_scaling), _stream(A),
        )
    _raise_on(err, "gram_matvec_symmetric_f64")
    gram_matvec_symmetric_f64.launches += 1
    return out[:, 0] if squeeze else out


def laplace_matmat(X1, X2, V, lengthscale, const_scaling=1.0):
    """K3: ``c·exp(−‖x − y‖₁/ℓ) @ V`` (n, k) on the card, float32; K1's
    schedule and column splits (:func:`gram_matmat`)."""
    out = _matmat_launch("rl_laplace_matmat", (), X1, X2, V, lengthscale,
                         const_scaling)
    laplace_matmat.launches += 1
    return out


def laplace_matmat_comp(X1, X2, V, lengthscale, const_scaling=1.0):
    """K3c: the Laplace product as ``(hi, lo)`` (add ``lo`` last), K1c's
    contract: unscaled points, the lengthscale taken in float64."""
    _check_tensors((torch.float32,) * 3, X1, X2, V)
    V2, squeeze = _check_shapes(X1, X2, V)
    A1 = X1.contiguous()
    A2 = A1 if X2 is X1 else X2.contiguous()
    (n, d), (m, k) = A1.shape, V2.shape
    inv_ls = _inv_lengthscale(lengthscale, d, A1.device)
    build()
    out = torch.empty((n, k), dtype=torch.float32, device=A1.device)
    lo = torch.empty_like(out)
    with torch.cuda.device(A1.device):
        err = _lib["handle"].rl_laplace_matmat_comp(
            A1.data_ptr(), A2.data_ptr(), V2.data_ptr(), inv_ls.data_ptr(),
            out.data_ptr(), lo.data_ptr(), n, m, d, k, float(const_scaling),
            _stream(A1),
        )
    _raise_on(err, "laplace_matmat_comp")
    laplace_matmat_comp.launches += 1
    return (out[:, 0], lo[:, 0]) if squeeze else (out, lo)


def laplace_matvec_symmetric(X, V, lengthscale, const_scaling=1.0):
    """K5: the Laplace ``c·k(X, X) @ V`` for at most 16 columns, each tile
    pair once (K2's schedule)."""
    _check_tensors((torch.float32,) * 2, X, V)
    V2, squeeze = _check_shapes(X, X, V)
    Xs, _ = _scaled(X, X, lengthscale)
    n, d = Xs.shape
    k = V2.shape[1]
    if k > SYMMETRIC_MAX_K:
        raise ValueError(f"the triangle kernel takes k <= 16 columns (got {k})")
    build()
    out = torch.empty((n, k), dtype=torch.float32, device=Xs.device)
    with torch.cuda.device(Xs.device):
        err = _lib["handle"].rl_laplace_matvec_symmetric(
            Xs.data_ptr(), V2.data_ptr(), out.data_ptr(), n, d, k,
            float(const_scaling), _stream(Xs),
        )
    _raise_on(err, "laplace_matvec_symmetric")
    laplace_matvec_symmetric.launches += 1
    return out[:, 0] if squeeze else out


def _check_pair(X1, X2, V2, V1):
    """V2 (n2, k) and V1 (n1, k) as contiguous 2-D tensors with k <= 16, and
    whether they were 1-D."""
    V2c, squeeze = _check_shapes(X1, X2, V2)
    V1c, squeeze1 = _check_shapes(X2, X1, V1)
    if squeeze1 != squeeze or V1c.shape[1] != V2c.shape[1]:
        raise ValueError(f"V2 {tuple(V2.shape)} and V1 {tuple(V1.shape)} differ in k")
    if V2c.shape[1] > SYMMETRIC_MAX_K:
        raise ValueError(f"the pair kernel takes k <= 16 columns (got {V2c.shape[1]})")
    return V2c, V1c, squeeze


def _pair_launch(entry, lead, X1, X2, V2, V1, lengthscale, const_scaling):
    """K4 or K6: check, scale, launch; ``(out1, out2)``."""
    _check_tensors((torch.float32,) * 4, X1, X2, V2, V1)
    V2c, V1c, squeeze = _check_pair(X1, X2, V2, V1)
    Xs, Ys = _scaled(X1, X2, lengthscale)
    build()
    (n1, d), (n2, k) = Xs.shape, V2c.shape
    out1 = torch.empty((n1, k), dtype=torch.float32, device=Xs.device)
    out2 = torch.empty((n2, k), dtype=torch.float32, device=Xs.device)
    with torch.cuda.device(Xs.device):
        err = getattr(_lib["handle"], entry)(
            *lead, Xs.data_ptr(), Ys.data_ptr(), V2c.data_ptr(), V1c.data_ptr(),
            out1.data_ptr(), out2.data_ptr(), n1, n2, d, k, float(const_scaling),
            _stream(Xs),
        )
    _raise_on(err, entry)
    return (out1[:, 0], out2[:, 0]) if squeeze else (out1, out2)


def gram_pair(kind, X1, X2, V2, V1, lengthscale, const_scaling=1.0):
    """K4: ``(c·K @ V2, c·Kᵀ @ V1)`` with K = k(X1, X2) evaluated once, exact
    f32 tier, k ≤ 16; the squared-distance families."""
    out = _pair_launch("rl_gram_pair", (_code(kind),), X1, X2, V2, V1, lengthscale,
                       const_scaling)
    gram_pair.launches += 1
    return out


def gram_pair_tier(kind, A: TierOperand, B: TierOperand, V2, V1, const_scaling=1.0):
    """K4b: ``(c·K @ V2, c·Kᵀ @ V1)`` on a bf16 tier from the parts of X1 (A)
    and X2 (B), k ≤ 16; the mirror contraction is tier-matched at k ≥ 3."""
    code = _check_tier(kind, A, B)
    _check_tensors((torch.float32,) * 2, V2, V1)
    V2c, V1c, squeeze = _check_pair(A.hi, B.hi, V2, V1)
    if V2c.device != A.hi.device:
        raise ValueError(f"tensors on {V2c.device} and {A.hi.device}")
    _, hx, hy = norms_and_operands(kind, A, B)
    build()
    (n1, dp), (n2, k) = A.hi.shape, V2c.shape
    out1 = torch.empty((n1, k), dtype=torch.float32, device=V2c.device)
    out2 = torch.empty((n2, k), dtype=torch.float32, device=V2c.device)
    with torch.cuda.device(V2c.device):
        err = _lib["handle"].rl_gram_pair_tier(
            code, A.passes, A.hi.data_ptr(), _ptr(A.lo), hx.data_ptr(),
            B.hi.data_ptr(), _ptr(B.lo), hy.data_ptr(), V2c.data_ptr(),
            V1c.data_ptr(), out1.data_ptr(), out2.data_ptr(), n1, n2, dp, k,
            float(const_scaling), _stream(V2c),
        )
    _raise_on(err, "gram_pair_tier")
    gram_pair_tier.launches += 1
    return (out1[:, 0], out2[:, 0]) if squeeze else (out1, out2)


def laplace_pair(X1, X2, V2, V1, lengthscale, const_scaling=1.0):
    """K6: the Laplace ``(c·K @ V2, c·Kᵀ @ V1)``, one L1/exp tile for both
    products, k ≤ 16."""
    out = _pair_launch("rl_laplace_pair", (), X1, X2, V2, V1, lengthscale, const_scaling)
    laplace_pair.launches += 1
    return out


def spmm_lanes(n_rows: int, nnz: int, k: int) -> int:
    """Threads of the CSR kernel on one row at k ≤ 16, from the mean row
    length: ``CSR_BLOCK_ROW`` (a block of 256) for rows of 256 entries or
    more on average, else L lanes of a warp, the power of two in [2, 32]
    nearest above ``mean / CSR_ENTRIES_PER_LANE`` (16-entry rows take 4
    lanes, 8 rows a warp). Past k = 16 the kernel gives a warp to each
    (row, column tile), and the value is not read (32 is returned)."""
    if k > CSR_NARROW_MAX_K:
        return 32
    if nnz >= CSR_BLOCK_ROW * max(n_rows, 1):
        return CSR_BLOCK_ROW
    want = -(-nnz // (CSR_ENTRIES_PER_LANE * max(n_rows, 1)))
    lanes = 2
    while lanes < 32 and lanes < want:
        lanes *= 2
    return lanes


def _csr_launch(values, indptr, indices, X, n_rows: int) -> torch.Tensor:
    """#9: ``Y = A @ X`` (n_rows, k) for CSR A on the card; X 2-D."""
    if not (values.is_cuda and X.is_cuda):
        raise ValueError("the CUDA CSR kernel takes CUDA tensors only")
    dev = values.device
    for t in (indptr, indices, X):
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if values.dtype not in (torch.float32, torch.float64) or X.dtype != values.dtype:
        raise NotImplementedError(
            f"the CUDA CSR kernel takes float32 or float64 values and an operand "
            f"of the same type, got {values.dtype} and {X.dtype}"
        )
    if indices.dtype != torch.int32 or indptr.dtype != torch.int64:
        raise NotImplementedError(
            f"the CUDA CSR kernel takes int32 indices and an int64 indptr, got "
            f"{indices.dtype} and {indptr.dtype}"
        )
    if values.ndim != 1 or indices.shape != values.shape or indptr.shape != (n_rows + 1,):
        raise ValueError(
            f"CSR buffers of shapes {tuple(values.shape)}, {tuple(indices.shape)}, "
            f"{tuple(indptr.shape)} for {n_rows} rows"
        )
    if not (values.is_contiguous() and indices.is_contiguous() and indptr.is_contiguous()):
        raise ValueError("the CSR buffers must be contiguous")
    X2 = X.contiguous()
    k = X2.shape[1]
    if k < 1:
        raise ValueError("empty operand")
    build()
    out = torch.empty((n_rows, k), dtype=values.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _lib["handle"].rl_csr_spmm(
            0 if values.dtype == torch.float32 else 1, indptr.data_ptr(),
            indices.data_ptr(), values.data_ptr(), X2.data_ptr(), out.data_ptr(),
            int(n_rows), int(values.numel()), int(k),
            int(spmm_lanes(n_rows, values.numel(), k)), _stream(X2),
        )
    _raise_on(err, "csr_spmm")
    return out


def csr_spmv(values, indptr, indices, x, n_rows: int):
    """#9 at one right-hand side: ``y = A @ x`` for CSR A, x of shape
    (n_cols,) or (n_cols, 1); y of the same rank."""
    squeeze = x.ndim == 1
    if not squeeze and (x.ndim != 2 or x.shape[1] != 1):
        raise ValueError(f"csr_spmv takes one right-hand side, got {tuple(x.shape)}")
    out = _csr_launch(values, indptr, indices, x[:, None] if squeeze else x, n_rows)
    csr_spmv.launches += 1
    return out[:, 0] if squeeze else out


def csr_spmm(values, indptr, indices, X, n_rows: int):
    """#9 at k ≥ 1 right-hand sides: ``Y = A @ X`` for CSR A, X (n_cols, k)."""
    if X.ndim != 2:
        raise ValueError(f"csr_spmm takes a 2-D operand, got {tuple(X.shape)}")
    out = _csr_launch(values, indptr, indices, X, n_rows)
    csr_spmm.launches += 1
    return out


_WRAPPERS = (
    gram_matmat,
    gram_matmat_comp,
    gram_matvec_symmetric,
    gram_matmat_tier,
    gram_matvec_symmetric_tier,
    gram_matmat_f64,
    gram_matvec_symmetric_f64,
    laplace_matmat,
    laplace_matmat_comp,
    laplace_matvec_symmetric,
    gram_pair,
    gram_pair_tier,
    laplace_pair,
    csr_spmv,
    csr_spmm,
)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
