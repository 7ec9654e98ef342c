"""Hand-written CUDA Gram kernels: build, ctypes binding, checked wrappers.

Counterpart of ``rlaopt_tpu/ops/kernel_pallas.py`` (exact f32 tier,
compensated tier, bf16 tiers) and ``rlaopt_tpu/ops/kernel_value64.py``
(float64 route). The kernels live in ``csrc/gram.cu`` (K1, K1c, K2),
``csrc/gram_tier.cu`` (K1b, K2b) and ``csrc/gram_f64.cu`` (K8, K7), with
their shared pieces in ``csrc/gram_common.cuh`` (see the note at the top of
each). :func:`build` compiles each source with ``nvcc`` for ``sm_90a`` in
parallel and links them into one shared library with a plain C interface,
cached under ``build/`` at the repository root by a hash of the sources and
the flags. Nothing is compiled or loaded on import.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream, raises if
the launch reports an error, and adds one to its ``launches`` counter. It
takes CUDA tensors only: everything else raises (the dispatcher in
:mod:`rlaopt_tpu_torch.ops.kernel_dispatch` sends CPU tensors to the plain
versions).
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
    "launch_counts",
    "reset_launch_counts",
    "KIND_CODES",
]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("gram.cu", "gram_tier.cu", "gram_f64.cu")
_HEADERS = ("gram_common.cuh",)
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c",
)
# Kernel family codes of csrc/gram_common.cuh. Laplace has float64 kernels
# only (K7, K8); its f32 kernels are still to port.
KIND_CODES = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3, "laplace": 4}
SYMMETRIC_MAX_K = 16

_lock = threading.Lock()
_lib = {"handle": None, "path": None}

_vp, _ci, _cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "rl_gram_matmat": [_ci, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _cd, _vp],
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
    if kind not in KIND_CODES:
        raise ValueError(f"Unknown kernel kind {kind!r}")
    if kind == "laplace" and not laplace:
        raise NotImplementedError(
            "the Laplace family has float64 CUDA kernels only "
            "(port of kernel_pallas.py::_laplace_matmat)"
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


def gram_matmat(kind, X1, X2, V, lengthscale, const_scaling=1.0):
    """K1: ``c·k(X1, X2) @ V`` (n, k) on the card, exact f32 tier."""
    code = _code(kind)
    _check_tensors((torch.float32,) * 3, X1, X2, V)
    V2, squeeze = _check_shapes(X1, X2, V)
    Xs, Ys = _scaled(X1, X2, lengthscale)
    build()
    (n, d), (m, k) = Xs.shape, V2.shape
    out = torch.empty((n, k), dtype=torch.float32, device=Xs.device)
    with torch.cuda.device(Xs.device):
        err = _lib["handle"].rl_gram_matmat(
            code, Xs.data_ptr(), Ys.data_ptr(), V2.data_ptr(), out.data_ptr(),
            n, m, d, k, float(const_scaling), _stream(Xs),
        )
    _raise_on(err, "gram_matmat")
    gram_matmat.launches += 1
    return out[:, 0] if squeeze else out


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


_WRAPPERS = (
    gram_matmat,
    gram_matmat_comp,
    gram_matvec_symmetric,
    gram_matmat_tier,
    gram_matvec_symmetric_tier,
    gram_matmat_f64,
    gram_matvec_symmetric_f64,
)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
