"""Hand-written CUDA Gram kernels: build, ctypes binding, checked wrappers.

Counterpart of ``rlaopt_tpu/ops/kernel_pallas.py`` for the exact f32 tier.
The kernels live in ``csrc/gram.cu`` (see the note at its top) and are
compiled at first use by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, cached under ``build/`` at the repository root by a
hash of the source and the flags. Nothing is compiled or loaded on import.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream, raises if
the launch reports an error, and adds one to its ``launches`` counter. It
takes CUDA float32 tensors only: everything else raises (the dispatcher in
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


__all__ = [
    "build",
    "gram_matmat",
    "gram_matmat_comp",
    "gram_matvec_symmetric",
    "launch_counts",
    "reset_launch_counts",
    "KIND_CODES",
]

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gram.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Kernel family codes of csrc/gram.cu. Laplace has no CUDA kernel yet.
KIND_CODES = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3}
SYMMETRIC_MAX_K = 16

_lock = threading.Lock()
_lib = {"handle": None, "path": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile ``csrc/gram.cu`` (once per source hash) and load it.

    Returns the path of the shared library. The compiler's output
    (``-Xptxas -v``: registers and shared memory per kernel) is kept beside
    it as ``<library>.log``.
    """
    with _lock:
        if _lib["handle"] is not None:
            return _lib["path"]
        src = _SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        path = _BUILD_DIR / f"gram-{digest[:16]}.so"
        if not path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                capture_output=True, text=True,
            )
            log = proc.stdout + proc.stderr
            path.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {_SOURCE}:\n{log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.rl_gram_matmat.argtypes = [
            ci, vp, vp, vp, vp, ci, ci, ci, ci, cd, vp,
        ]
        lib.rl_gram_matmat.restype = ci
        lib.rl_gram_matmat_comp.argtypes = [
            ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cd, vp,
        ]
        lib.rl_gram_matmat_comp.restype = ci
        lib.rl_gram_matvec_symmetric.argtypes = [
            ci, vp, vp, vp, ci, ci, ci, cd, vp,
        ]
        lib.rl_gram_matvec_symmetric.restype = ci
        _lib["handle"], _lib["path"] = lib, path
        return path


def _check(kind: str, *tensors: torch.Tensor) -> int:
    if kind not in KIND_CODES:
        if kind == "laplace":
            raise NotImplementedError(
                "the Laplace family has no CUDA kernel yet "
                "(port of kernel_pallas.py::_laplace_matmat)"
            )
        raise ValueError(f"Unknown kernel kind {kind!r}")
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("the CUDA Gram kernels take CUDA tensors only")
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"the CUDA Gram kernels are float32 only (got {t.dtype}); "
                "float64 waits for the value64 port"
            )
    return KIND_CODES[kind]


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


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def gram_matmat(kind, X1, X2, V, lengthscale, const_scaling=1.0):
    """K1: ``c·k(X1, X2) @ V`` (n, k) on the card, exact f32 tier."""
    code = _check(kind, X1, X2, V)
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
    code = _check(kind, X1, X2, V)
    V2, squeeze = _check_shapes(X1, X2, V)
    A1 = X1.contiguous()
    A2 = A1 if X2 is X1 else X2.contiguous()
    (n, d), (m, k) = A1.shape, V2.shape
    ls = torch.as_tensor(lengthscale, dtype=torch.float64, device=A1.device)
    if ls.ndim > 1 or ls.numel() not in (1, d):
        raise ValueError(f"lengthscale of shape {tuple(ls.shape)} for d = {d}")
    inv_ls = (1.0 / ls).expand(d).contiguous()
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
    code = _check(kind, X, V)
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


_WRAPPERS = (gram_matmat, gram_matmat_comp, gram_matvec_symmetric)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
