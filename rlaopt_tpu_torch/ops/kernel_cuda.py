"""Hand-written CUDA kernels: build, ctypes binding, checked wrappers.

Counterpart of ``rlaopt_tpu/ops/kernel_pallas.py`` (exact f32 tier,
compensated tier, bf16 tiers, the Laplace kernels),
``rlaopt_tpu/ops/kernel_value64.py`` (float64 route) and
``rlaopt_tpu/sparse/laned.py`` (the sparse CSR product). The kernels live in
``csrc/gram.cu`` (K1 up to 16 columns, K2), ``csrc/gram_wide.cu`` (K1
and K3 past 16 columns, the 3xTF32 contraction), ``csrc/gram_comp.cu`` (the
float64 tile in its triangle, forward and pair forms: K1c, K3c, K7, K8 and
the certified pairs), ``csrc/gram_laplace.cu`` (K3 up to 16 columns, K5),
``csrc/gram_pair.cu`` (the exact pair kernels K4, K6), the register tile of
K1–K6 in its forward, triangle and pair forms in ``csrc/gram_tile.cuh``,
``csrc/gram_tier.cu`` (K1b, K2b, K4b), with their shared
pieces in ``csrc/gram_common.cuh``, ``csrc/spmv.cu`` (the
CSR SpMV/SpMM) and ``csrc/probes.cu`` (the ceiling probes, wrapped in
:mod:`rlaopt_tpu_torch.ops.probes`); see the note at the top of each.
:func:`build` compiles
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
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from ..kernels.functions import scale_inputs
from .kernel_tiers import TierOperand, norms_and_operands, split_rhs


__all__ = [
    "build",
    "gram_matmat",
    "gram_matmat_comp",
    "gram_matvec_symmetric_comp",
    "comp_operand",
    "comp_run",
    "gram_pair_comp",
    "gram_pair_f64",
    "gram_matvec_symmetric",
    "tile_operand",
    "wide_rhs",
    "gram_matmat_tier",
    "gram_matvec_symmetric_tier",
    "gram_matmat_f64",
    "gram_matvec_symmetric_f64",
    "laplace_matmat",
    "laplace_matmat_narrow",
    "laplace_matmat_comp",
    "laplace_matvec_symmetric",
    "gram_pair",
    "gram_pair_tier",
    "laplace_pair",
    "csr_spmv",
    "csr_spmm",
    "CSRPlan",
    "csr_plan",
    "csr_segmented",
    "csr_chunk",
    "tier_splits",
    "tile_splits",
    "spmm_lanes",
    "sm_count",
    "launch_counts",
    "reset_launch_counts",
    "KIND_CODES",
]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("gram.cu", "gram_wide.cu", "gram_comp.cu", "gram_laplace.cu", "gram_tier.cu",
           "gram_pair.cu", "spmv.cu", "probes.cu")
_HEADERS = ("gram_common.cuh", "gram_tile.cuh")
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c",
)
# Kernel family codes of csrc/gram_common.cuh. The float32 Laplace kernels
# have wrappers of their own (laplace_*), which hand the shared entries
# (the wide kernel, the pair) this code; the float64 ones take the code.
KIND_CODES = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3, "laplace": 4}
SYMMETRIC_MAX_K = 16
# csrc/gram_tier.cu: K1b's forward strip takes 128 rows a block, two blocks
# an SM. csrc/gram_comp.cu's float64 tile: tiles of 128 points and chunks of
# 16 features, one block an SM; the forward form takes 16 right-hand sides
# a slice, the triangle and the pair 1, 2 or 4 (COMP_SLICE past 2).
TIER_ROWS, TIER_BLOCKS_PER_SM = 128, 2
COMP_TILE, COMP_FEAT, COMP_FORWARD_K, COMP_SLICE = 128, 16, 16, 4
# csrc/gram_tile.cuh: the register tile of K1–K6 at k <= 16 takes 128
# points a side, chunks of 32 features, two blocks an SM.
TILE_POINTS, TILE_FEAT, TILE_BLOCKS_PER_SM = 128, 32, 2
# csrc/gram_wide.cu: K1 and K3 past 16 columns take this many output
# columns a block, 64 where V's TF32 parts (padded to a multiple of 8
# columns) have 64 or fewer: each width measured the faster on its side
# (gram_wide.cu).
WIDE_COLS = 128
# csrc/spmv.cu keeps up to 16 right-hand sides of a row in registers.
CSR_NARROW_MAX_K = 16
# Its short-row schedule: L lanes a row, L a power of two in [2, 32], about
# this many entries a lane; from this mean row length on a block of
# CSR_BLOCK_ROW threads takes a row (the C interface's lanes value 256).
CSR_ENTRIES_PER_LANE = 4
CSR_BLOCK_ROW = 256
# Its segmented schedule (csr_plan, csr_segmented): rows of more than
# CSR_SEGMENT entries are cut into segments of that many, whose partial sums
# a second launch adds; the partial buffer is held within CSR_PART_BYTES by
# taking the columns in chunks (csr_chunk). Segments of 128 to 2,048 entries
# timed at chip_smoke.py's ragged operands (PERF.md, PR 10): 128 and 256
# the fastest, 256 the fewer partials.
CSR_SEGMENT = 256
CSR_PART_BYTES = 1 << 28

_lock = threading.Lock()
_lib = {"handle": None, "path": None}

_vp, _ci, _cd, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
_SIGNATURES = {
    "rl_gram_matmat_narrow": [
        _ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_matmat_wide": [
        _ci, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_matmat_comp": [
        _ci, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_pair_comp": [
        _ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_pair_f64": [
        _ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_matvec_symmetric_comp": [
        _ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_matvec_symmetric": [_ci, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _cd, _vp],
    "rl_gram_matmat_tier": [
        _ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
        _ci, _ci, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_matvec_symmetric_tier": [
        _ci, _ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_matmat_f64": [
        _ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_matvec_symmetric_f64": [_ci, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _cd, _vp],
    "rl_laplace_matmat_narrow": [
        _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_laplace_matvec_symmetric": [_vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _cd, _vp],
    "rl_tile_pair": [
        _ci, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_gram_pair_tier": [
        _ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
        _ci, _ci, _ci, _ci, _cd, _vp,
    ],
    "rl_csr_spmm": [_ci, _vp, _vp, _vp, _vp, _vp, _ll, _ll, _ci, _ci, _vp],
    "rl_csr_spmm_segmented": [
        _ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
        _ll, _ll, _ll, _ll, _ll, _ci, _ci, _ci, _vp,
    ],
    "rl_probe_l1": [_ci, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _vp],
    "rl_probe_chain": [_ci, _vp, _vp, _vp, _ll, _vp],
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
    """The family code; the squared-distance wrappers (K1, K1c, K2, K4 and
    the tiers) refuse Laplace, whose float32 kernels are the laplace_*
    wrappers (which pass it on to the entries they share: the wide kernel,
    the pair), as the float64 kernels, the triangle K1c/K3c and the
    certified pairs take it."""
    if kind not in KIND_CODES:
        raise ValueError(f"Unknown kernel kind {kind!r}")
    if kind == "laplace" and not laplace:
        raise NotImplementedError(
            "this kernel sums squared distances: the Laplace family takes "
            "laplace_matmat, laplace_matmat_comp, laplace_matvec_symmetric or "
            "laplace_pair (the port of kernel_pallas.py::_laplace_matmat and "
            "its kin), or the float64 kernels, gram_matvec_symmetric_comp and the "
            "certified pairs"
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


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def sm_count(device) -> int:
    """The SM count of a CUDA device, read once per device."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _runs(rows: int, tiles: int, k: int, slots: int, min_tiles: int) -> int:
    """Runs of the m axis for a narrow kernel of ``rows`` row blocks over
    ``tiles`` column tiles on a card of ``slots`` block slots: 1 when the
    row blocks fill two rounds of the slots (the last round's idle share is
    then at most a third); otherwise as many runs as keep the blocks within
    four rounds, each run at least ``min_tiles`` column tiles. Uniform
    blocks run in rounds, so the count aims below a whole number of them.
    Past 16 columns (the wide kernels) 1."""
    if k > SYMMETRIC_MAX_K or rows >= 2 * slots:
        return 1
    return max(1, min(4 * slots // rows, tiles // min_tiles))


def tier_splits(n: int, m: int, k: int, sms: int) -> int:
    """Runs of the m axis for K1b's forward strip (k ≤ 16) on a card of
    ``sms`` SMs (:func:`_runs`): 128-row blocks, two an SM, runs of at least
    16 column tiles of 64. SAP's row oracle (10⁴ rows, 79 blocks) takes 13
    runs, 1,027 blocks on 1,056 slot-rounds, where the one-run schedule left
    53 of 132 SMs idle."""
    return _runs(-(-n // TIER_ROWS), -(-m // 64), k, TIER_BLOCKS_PER_SM * sms, 16)


def tile_splits(n: int, m: int, k: int, sms: int) -> int:
    """Runs of the m axis for the register tile's forward form at k ≤ 16
    (K1, K3) on a card of ``sms`` SMs (:func:`_runs`): 128-point tiles both
    ways, two blocks an SM, runs of at least 8 column tiles (1,024 points).
    SAP's row oracle (10⁴ rows, 79 row tiles) takes 13 runs; 100,000 rows
    one."""
    return _runs(-(-n // TILE_POINTS), -(-m // TILE_POINTS), k,
                 TILE_BLOCKS_PER_SM * sms, 8)


def tile_operand(X: torch.Tensor, lengthscale) -> torch.Tensor:
    """The points of the register tile (K1–K6, and K1 and K3 past 16
    columns): ``X / ℓ`` in
    float32 (the plain version's and the other float32 kernels' scaling,
    ``scale_inputs``), transposed to (dpad, npad) and zero past d and n,
    dpad a multiple of ``TILE_FEAT`` and npad of ``TILE_POINTS``. Zero
    padding adds nothing to a squared or an L1 distance, so one layout
    serves every family."""
    n, d = X.shape
    XT = torch.zeros((-(-d // TILE_FEAT) * TILE_FEAT, -(-n // TILE_POINTS) * TILE_POINTS),
                     dtype=torch.float32, device=X.device)
    XT[:d, :n] = scale_inputs(X, lengthscale).T
    return XT


def _check_tile_operand(XT, X, device):
    """``XT`` has the layout :func:`tile_operand` gives the points X on
    ``device``; ``ValueError`` otherwise."""
    n, d = X.shape
    want = (-(-d // TILE_FEAT) * TILE_FEAT, -(-n // TILE_POINTS) * TILE_POINTS)
    if XT.dtype != torch.float32 or tuple(XT.shape) != want or not XT.is_contiguous() \
            or XT.device != device:
        raise ValueError(f"the tile's operand is {XT.dtype} {tuple(XT.shape)} on {XT.device}; "
                         f"tile_operand gives float32 {want} on {device}")


def _tile_operands(X1, X2, lengthscale, device, operands):
    """The tile's operands of (X1, X2): ``operands()`` checked, or built
    here when ``operands`` is None."""
    if operands is None:
        XT1 = tile_operand(X1, lengthscale)
        return XT1, XT1 if X2 is X1 else tile_operand(X2, lengthscale)
    XT1, XT2 = operands()
    _check_tile_operand(XT1, X1, device)
    _check_tile_operand(XT2, X2, device)
    return XT1, XT2


def _tile_forward(entry, lead, X1, X2, V2, XT1, XT2, const_scaling):
    """The register tile's forward form (K1, K3 at k ≤ 16) through ``entry``
    (``lead``: the arguments before the pointers), the m axis in
    :func:`tile_splits` runs; the (n, k) output."""
    (n, d), (m, k) = X1.shape, V2.shape
    dev = V2.device
    splits = tile_splits(n, m, k, sm_count(dev))
    part = torch.empty((splits, n, k), dtype=torch.float32, device=dev) if splits > 1 else None
    build()
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(_lib["handle"], entry)(
            *lead, XT1.data_ptr(), XT2.data_ptr(), V2.data_ptr(), out.data_ptr(), _ptr(part),
            n, m, XT1.shape[1], XT2.shape[1], d, XT1.shape[0], k, int(splits),
            float(const_scaling), _stream(V2),
        )
    _raise_on(err, entry)
    return out


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of each float32: the nearest float with 10
    mantissa bits (ties away from zero), by adding half the dropped ulp to
    the bit pattern and clearing the 13 low bits."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def wide_rhs(V: torch.Tensor, mpad: int, kp: int) -> torch.Tensor:
    """K1's right-hand side past 16 columns (``csrc/gram_wide.cu``): V (m,
    k) float32, zero-padded to (mpad, kp), split into TF32 parts hi =
    tf32(v), lo = tf32(v − hi) (:func:`kernel_plain.tf32_split` in bit
    operations), laid out as (mpad / 2, kp, 4) float32: for the rows 2p,
    2p + 1 and each column, (hi₀, hi₁, lo₀, lo₁), one 16-byte piece that is
    a lane's B fragments of both parts. Made once per call."""
    m, k = V.shape
    Vp = torch.zeros((mpad, kp), dtype=torch.float32, device=V.device)
    Vp[:m, :k] = V
    hi = _tf32(Vp)
    lo = _tf32(Vp - hi)
    return torch.stack((hi[0::2], hi[1::2], lo[0::2], lo[1::2]), dim=-1)


def _wide(code, X1, X2, V2, XT1, XT2, const_scaling):
    """K1 and K3 past 16 columns: the 3xTF32 kernel (``csrc/gram_wide.cu``)
    for the family ``code`` on the tile's operands and V's TF32 parts
    (:func:`wide_rhs`), 128 output columns a block past kp = 64, else 64;
    the (n, k) output."""
    (n, d), (m, k) = X1.shape, V2.shape
    kp = -(-k // 8) * 8
    VP = wide_rhs(V2, XT2.shape[1], kp)
    nf = WIDE_COLS // 8 if kp > 64 else 8
    build()
    out = torch.empty((n, k), dtype=torch.float32, device=V2.device)
    with torch.cuda.device(V2.device):
        err = _lib["handle"].rl_gram_matmat_wide(
            code, XT1.data_ptr(), XT2.data_ptr(), VP.data_ptr(), out.data_ptr(), n, m,
            XT1.shape[1], XT2.shape[1], d, XT1.shape[0], k, kp, nf, float(const_scaling),
            _stream(V2),
        )
    _raise_on(err, "rl_gram_matmat_wide")
    return out


def gram_matmat(kind, X1, X2, V, lengthscale, const_scaling=1.0, operands=None):
    """K1: ``c·k(X1, X2) @ V`` (n, k) on the card, exact f32 tier, the
    squared-distance families. Up to 16 columns the register tile's forward
    form (``csrc/gram_tile.cuh``), the m axis in :func:`tile_splits` runs
    summed in a fixed order (the same bits on every call); past 16 the
    3xTF32 tensor-core kernel (``csrc/gram_wide.cu``) on V's TF32 parts
    (:func:`wide_rhs`). The points go in as :func:`tile_operand`:
    ``operands()``, the pair for (X1, X2) built beforehand (an operator
    keeps them), or None to build them here."""
    code = _code(kind)
    _check_tensors((torch.float32,) * 3, X1, X2, V)
    V2, squeeze = _check_shapes(X1, X2, V)
    XT1, XT2 = _tile_operands(X1, X2, lengthscale, V2.device, operands)
    if V2.shape[1] <= SYMMETRIC_MAX_K:
        out = _tile_forward("rl_gram_matmat_narrow", (code,), X1, X2, V2, XT1, XT2,
                            const_scaling)
    else:
        out = _wide(code, X1, X2, V2, XT1, XT2, const_scaling)
    gram_matmat.launches += 1
    return out[:, 0] if squeeze else out


def comp_operand(X: torch.Tensor, lengthscale) -> torch.Tensor:
    """The points of the float64 tile (K1c, K3c, K7, K8 and the certified
    pairs, every form): ``X / ℓ`` in float64, transposed to (dpad, npad)
    and zero past d and n, dpad a multiple of ``COMP_FEAT`` and npad of
    ``COMP_TILE`` (the kernel's feature chunks and tiles). The scaling is
    the plain versions' (:func:`kernel_plain.gram_matmat_comp`,
    :func:`kernel_plain.gram_matmat_f64`: the float64 points over the
    float64 lengthscale). Built in each call, one for each point set."""
    n, d = X.shape
    ls = torch.as_tensor(lengthscale, dtype=torch.float64, device=X.device)
    if ls.ndim > 1 or ls.numel() not in (1, d):
        raise ValueError(f"lengthscale of shape {tuple(ls.shape)} for d = {d}")
    XT = torch.zeros((-(-d // COMP_FEAT) * COMP_FEAT, -(-n // COMP_TILE) * COMP_TILE),
                     dtype=torch.float64, device=X.device)
    XT[:d, :n] = scale_inputs(X.double(), ls).T
    return XT


def _comp_operands(X1, X2, lengthscale):
    XT1 = comp_operand(X1, lengthscale)
    return XT1, XT1 if X2 is X1 else comp_operand(X2, lengthscale)


def comp_run(blocks: int, tiles: int, sms: int) -> int:
    """Column tiles a block of the float64 tile's forward or pair form
    walks, of ``tiles`` in all, when one run of them takes ``blocks`` blocks
    (row tiles times right-hand-side slices), one block an SM: all of them
    once the blocks fill two rounds of the card (:func:`_runs`), else the
    tiles cut into as many runs as keep the blocks within four rounds, each
    of at least 8 tiles. E2's 12,500-point shard at k = 1 (98 row tiles): 5
    runs of 20 tiles, 490 blocks on the H100's 132 SMs; config 6's
    certificate (64 row tiles of 8,192 against 7,813 of 10⁶): 8 runs."""
    return -(-tiles // _runs(blocks, tiles, 1, sms, 8))


def _comp_forward(entry, code, X1, X2, V, lengthscale, const_scaling, vtype):
    """The float64 tile's forward form through ``entry`` (K1c and K3c with
    float32 V: ``(hi, lo)``; K8 with float64 V: float64), X2's tiles in
    :func:`comp_run` runs whose float64 partials the finishing pass adds
    in order (the same bits on every call)."""
    _check_tensors((torch.float32, torch.float32, vtype), X1, X2, V)
    V2, squeeze = _check_shapes(X1, X2, V)
    XT1, XT2 = _comp_operands(X1, X2, lengthscale)
    (n, _), (m, k) = X1.shape, V2.shape
    dev = V2.device
    tiles = XT2.shape[1] // COMP_TILE
    run = comp_run(XT1.shape[1] // COMP_TILE * -(-k // COMP_FORWARD_K), tiles, sm_count(dev))
    part = torch.empty((-(-tiles // run), n, k), dtype=torch.float64, device=dev)
    build()
    out = torch.empty((n, k), dtype=vtype, device=dev)
    lo = torch.empty_like(out) if vtype == torch.float32 else None
    with torch.cuda.device(dev):
        err = getattr(_lib["handle"], entry)(
            code, XT1.data_ptr(), XT2.data_ptr(), V2.data_ptr(), part.data_ptr(), out.data_ptr(),
            *(() if lo is None else (lo.data_ptr(),)), n, m, XT1.shape[1], XT2.shape[1],
            XT1.shape[0], k, int(run), float(const_scaling), _stream(V2),
        )
    _raise_on(err, entry)
    if lo is None:
        return out[:, 0] if squeeze else out
    return (out[:, 0], lo[:, 0]) if squeeze else (out, lo)


def gram_matmat_comp(kind, X1, X2, V, lengthscale, const_scaling=1.0):
    """K1c: ``c·k(X1, X2) @ V`` as ``(hi, lo)``; consumers add ``lo`` last.
    The float64 tile's forward form (``csrc/gram_comp.cu``) on
    :func:`comp_operand` of each point set: values and sums in float64 from
    the float32 points and the lengthscale at full precision, split into
    the float32 pair once; the same bits on every call. The
    squared-distance families (Laplace: :func:`laplace_matmat_comp`)."""
    out = _comp_forward("rl_gram_matmat_comp", _code(kind), X1, X2, V, lengthscale,
                        const_scaling, torch.float32)
    gram_matmat_comp.launches += 1
    return out


def gram_matvec_symmetric_comp(kind, X, V, lengthscale, const_scaling=1.0):
    """The triangle form of K1c and K3c: ``c·k(X, X) @ V`` as ``(hi, lo)``
    (add ``lo`` last), each tile pair evaluated once in float64 and
    contracted both ways, any k, every family (Laplace included). The
    function and contract of :func:`gram_matmat_comp` and
    :func:`laplace_matmat_comp` on ``(X, X)``; the float64 sums go through
    atomics, so their last bits (about 1e-16 relative) change from run to
    run."""
    code = _code(kind, laplace=True)
    _check_tensors((torch.float32,) * 2, X, V)
    V2, squeeze = _check_shapes(X, X, V)
    XT = comp_operand(X, lengthscale)
    (n, _), k = X.shape, V2.shape[1]
    build()
    acc = torch.empty((n, k), dtype=torch.float64, device=X.device)
    out = torch.empty((n, k), dtype=torch.float32, device=X.device)
    lo = torch.empty_like(out)
    with torch.cuda.device(X.device):
        err = _lib["handle"].rl_gram_matvec_symmetric_comp(
            code, XT.data_ptr(), V2.data_ptr(), acc.data_ptr(), out.data_ptr(),
            lo.data_ptr(), n, XT.shape[1], XT.shape[0], k, float(const_scaling),
            _stream(X),
        )
    _raise_on(err, "gram_matvec_symmetric_comp")
    gram_matvec_symmetric_comp.launches += 1
    return (out[:, 0], lo[:, 0]) if squeeze else (out, lo)


def gram_matvec_symmetric(kind, X, V, lengthscale, const_scaling=1.0, operand=None):
    """K2: ``c·k(X, X) @ V`` for at most 16 columns, the register tile's
    triangle form (``csrc/gram_tile.cuh``): each pair of 128-point tiles
    evaluated once and contracted both ways, the mirror added by float
    atomics, so the last bits change from run to run. The points go in as
    :func:`tile_operand`: ``operand``, built beforehand (an operator keeps
    it), or None to build it here."""
    code = _code(kind)
    return _triangle("rl_gram_matvec_symmetric", (code,), X, V, lengthscale, const_scaling,
                     operand, gram_matvec_symmetric)


def _triangle(entry, lead, X, V, lengthscale, const_scaling, operand, wrapper):
    """The register tile's triangle form (K2, K5) through ``entry``; counted
    on ``wrapper``."""
    _check_tensors((torch.float32,) * 2, X, V)
    V2, squeeze = _check_shapes(X, X, V)
    n, d = X.shape
    k = V2.shape[1]
    if k > SYMMETRIC_MAX_K:
        raise ValueError(f"the triangle kernel takes k <= 16 columns (got {k})")
    if operand is None:
        XT = tile_operand(X, lengthscale)
    else:
        XT = operand
        _check_tile_operand(XT, X, V2.device)
    build()
    out = torch.empty((n, k), dtype=torch.float32, device=V2.device)
    with torch.cuda.device(V2.device):
        err = getattr(_lib["handle"], entry)(
            *lead, XT.data_ptr(), V2.data_ptr(), out.data_ptr(), n, XT.shape[1], d, XT.shape[0],
            k, float(const_scaling), _stream(V2),
        )
    _raise_on(err, entry)
    wrapper.launches += 1
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
    X2 (B) (:func:`rlaopt_tpu_torch.ops.kernel_tiers.tier_operand`): the
    forward strip with a float32 contraction for k ≤ 16, the m axis in
    :func:`tier_splits` runs; past that the wide kernel, the tier-matched
    contraction on the tensor cores, with V's bf16 parts split here once
    (:func:`rlaopt_tpu_torch.ops.kernel_tiers.split_rhs`)."""
    code = _check_tier(kind, A, B)
    _check_tensors((torch.float32,), V)
    V2, squeeze = _check_shapes(A.hi, B.hi, V)
    if V2.device != A.hi.device:
        raise ValueError(f"tensors on {V2.device} and {A.hi.device}")
    _, hx, hy = norms_and_operands(kind, A, B)
    (n, dp), (m, k) = A.hi.shape, V2.shape
    dev = V2.device
    Vh = Vl = part = None
    splits, kp = 1, k
    if k > SYMMETRIC_MAX_K:
        Vh, Vl = split_rhs(V2, A.passes)
        kp = Vh.shape[1]
    else:
        splits = tier_splits(n, m, k, sm_count(dev))
        if splits > 1:
            part = torch.empty((splits, n, k), dtype=torch.float32, device=dev)
    build()
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib["handle"].rl_gram_matmat_tier(
            code, A.passes, A.hi.data_ptr(), _ptr(A.lo), hx.data_ptr(),
            B.hi.data_ptr(), _ptr(B.lo), hy.data_ptr(), V2.data_ptr(), _ptr(Vh),
            _ptr(Vl), _ptr(part), out.data_ptr(), n, m, dp, k, kp, int(splits),
            float(const_scaling), _stream(V2),
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
    """K8: ``c·k(X1, X2) @ V`` in float64 from float32 points, a float64
    lengthscale (scalar or ARD) and float64 V; float64 out. All five
    families. The float64 tile's forward form, as :func:`gram_matmat_comp`
    with float64 V: the same bits on every call."""
    out = _comp_forward("rl_gram_matmat_f64", _code(kind, laplace=True), X1, X2, V, lengthscale,
                        const_scaling, torch.float64)
    gram_matmat_f64.launches += 1
    return out


def gram_matvec_symmetric_f64(kind, X, V, lengthscale, const_scaling=1.0):
    """K7: ``c·k(X, X) @ V`` in float64 from float32 points, a float64
    lengthscale (scalar or ARD) and float64 V, float64 out; any k, every
    family. The float64 triangle of the triangle K1c
    (``csrc/gram_comp.cu``) on :func:`comp_operand`, each tile
    pair evaluated once and contracted both ways; its float64 sums go
    through atomics, so their last bits (about 1e-16 relative) change from
    run to run."""
    code = _code(kind, laplace=True)
    _check_tensors((torch.float32, torch.float64), X, V)
    V2, squeeze = _check_shapes(X, X, V)
    XT = comp_operand(X, lengthscale)
    (n, _), k = X.shape, V2.shape[1]
    build()
    out = torch.empty((n, k), dtype=torch.float64, device=X.device)
    with torch.cuda.device(X.device):
        err = _lib["handle"].rl_gram_matvec_symmetric_f64(
            code, XT.data_ptr(), V2.data_ptr(), out.data_ptr(), n, XT.shape[1], XT.shape[0],
            k, float(const_scaling), _stream(X),
        )
    _raise_on(err, "gram_matvec_symmetric_f64")
    gram_matvec_symmetric_f64.launches += 1
    return out[:, 0] if squeeze else out


def laplace_matmat(X1, X2, V, lengthscale, const_scaling=1.0, operands=None):
    """K3: ``c·exp(−‖x − y‖₁/ℓ) @ V`` (n, k) on the card, float32. Up to 16
    columns :func:`laplace_matmat_narrow` (the Hopper tile, counted there);
    past 16 K1's 3xTF32 kernel (``csrc/gram_wide.cu``) with the L1 step,
    counted here: the contraction float32-accurate, as the JAX kernel's
    "highest". The points go in as :func:`tile_operand`: ``operands()``,
    the pair for (X1, X2) built beforehand (a callable: an operator keeps
    its points' operand and builds it on first use), or None to build them
    here."""
    if (1 if V.ndim == 1 else V.shape[1]) <= SYMMETRIC_MAX_K:
        return laplace_matmat_narrow(X1, X2, V, lengthscale, const_scaling,
                                     None if operands is None else operands())
    _check_tensors((torch.float32,) * 3, X1, X2, V)
    V2, _ = _check_shapes(X1, X2, V)
    XT1, XT2 = _tile_operands(X1, X2, lengthscale, V2.device, operands)
    out = _wide(_code("laplace", laplace=True), X1, X2, V2, XT1, XT2, const_scaling)
    laplace_matmat.launches += 1
    return out


def laplace_matmat_narrow(X1, X2, V, lengthscale, const_scaling=1.0, operands=None):
    """K3 at k ≤ 16: the register tile's forward form
    (``csrc/gram_tile.cuh``), tiles of 128 x 128 points, an 8 x 8 register
    tile a thread, the m axis in :func:`tile_splits` runs summed in a fixed
    order (the same bits on every call). The points go in as
    :func:`tile_operand`: ``operands``, the pair for (X1, X2) built
    beforehand, or None to build them here."""
    _check_tensors((torch.float32,) * 3, X1, X2, V)
    V2, squeeze = _check_shapes(X1, X2, V)
    k = V2.shape[1]
    if k > SYMMETRIC_MAX_K:
        raise ValueError(f"laplace_matmat_narrow takes k <= 16 columns (got {k})")
    XT1, XT2 = _tile_operands(X1, X2, lengthscale, V2.device,
                              None if operands is None else (lambda: operands))
    out = _tile_forward("rl_laplace_matmat_narrow", (), X1, X2, V2, XT1, XT2, const_scaling)
    laplace_matmat_narrow.launches += 1
    return out[:, 0] if squeeze else out


def laplace_matmat_comp(X1, X2, V, lengthscale, const_scaling=1.0):
    """K3c: the Laplace product as ``(hi, lo)`` (add ``lo`` last), K1c's
    contract and kernel (:func:`gram_matmat_comp`) with Laplace's code."""
    out = _comp_forward("rl_gram_matmat_comp", _code("laplace", laplace=True), X1, X2, V,
                        lengthscale, const_scaling, torch.float32)
    laplace_matmat_comp.launches += 1
    return out


def laplace_matvec_symmetric(X, V, lengthscale, const_scaling=1.0, operand=None):
    """K5: the Laplace ``c·k(X, X) @ V`` for at most 16 columns, the
    register tile's triangle form (``csrc/gram_tile.cuh``), as K2: each pair
    of 128-point tiles evaluated once and contracted both ways, the mirror
    added by float atomics, so the last bits change from run to run. The
    points go in as :func:`tile_operand`: ``operand``, built beforehand (an
    operator keeps it), or None to build it here."""
    return _triangle("rl_laplace_matvec_symmetric", (), X, V, lengthscale, const_scaling,
                     operand, laplace_matvec_symmetric)


def _check_pair(X1, X2, V2, V1, max_k=SYMMETRIC_MAX_K):
    """V2 (n2, k) and V1 (n1, k) as contiguous 2-D tensors with k <=
    ``max_k`` (None: any k), and whether they were 1-D."""
    V2c, squeeze = _check_shapes(X1, X2, V2)
    V1c, squeeze1 = _check_shapes(X2, X1, V1)
    if squeeze1 != squeeze or V1c.shape[1] != V2c.shape[1]:
        raise ValueError(f"V2 {tuple(V2.shape)} and V1 {tuple(V1.shape)} differ in k")
    if max_k is not None and V2c.shape[1] > max_k:
        raise ValueError(f"the pair kernel takes k <= 16 columns (got {V2c.shape[1]})")
    return V2c, V1c, squeeze


def _tile_pair(code, X1, X2, V2, V1, lengthscale, const_scaling, operands):
    """K4 or K6: the register tile's pair form (``csrc/gram_pair.cu``,
    ``rl_tile_pair``) for the family ``code`` on the tile's operands of (X1,
    X2) (``operands()``, or built here when None), the column tiles of X2 in
    :func:`tile_splits` runs: the forward form's rule suits the pair, whose
    blocks are the forward form's with the mirror added (E2's 12,500-point
    shards: 98 x 98 tiles in 10 runs, 980 blocks on the H100's 264 slots);
    ``(out1, out2)``."""
    _check_tensors((torch.float32,) * 4, X1, X2, V2, V1)
    V2c, V1c, squeeze = _check_pair(X1, X2, V2, V1)
    dev = V2c.device
    XT1, XT2 = _tile_operands(X1, X2, lengthscale, dev, operands)
    (n1, d), (n2, k) = X1.shape, V2c.shape
    tiles = -(-n2 // TILE_POINTS)
    run = -(-tiles // tile_splits(n1, n2, k, sm_count(dev)))  # column tiles a block
    build()
    out1 = torch.empty((n1, k), dtype=torch.float32, device=dev)
    out2 = torch.empty((n2, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib["handle"].rl_tile_pair(
            code, XT1.data_ptr(), XT2.data_ptr(), V2c.data_ptr(), V1c.data_ptr(),
            out1.data_ptr(), out2.data_ptr(), n1, n2, XT1.shape[1], XT2.shape[1], d,
            XT1.shape[0], k, int(run), float(const_scaling), _stream(V2c),
        )
    _raise_on(err, "rl_tile_pair")
    return (out1[:, 0], out2[:, 0]) if squeeze else (out1, out2)


def gram_pair(kind, X1, X2, V2, V1, lengthscale, const_scaling=1.0, operands=None):
    """K4: ``(c·K @ V2, c·Kᵀ @ V1)`` with K = k(X1, X2) evaluated once, exact
    f32 tier, k ≤ 16; the squared-distance families. The register tile's
    pair form: float atomics, so the last bits change from run to run. The
    points go in as :func:`tile_operand`: ``operands()``, the pair for (X1,
    X2) built beforehand (the half-ring keeps each shard's), or None to
    build them here."""
    out = _tile_pair(_code(kind), X1, X2, V2, V1, lengthscale, const_scaling, operands)
    gram_pair.launches += 1
    return out


def gram_pair_tier(kind, A: TierOperand, B: TierOperand, V2, V1, const_scaling=1.0):
    """K4b: ``(c·K @ V2, c·Kᵀ @ V1)`` on a bf16 tier from the parts of X1 (A)
    and X2 (B), k ≤ 16; the mirror contraction is tier-matched at k ≥ 3.
    The pair form of K2b's strip (``csrc/gram_tier.cu``), each value
    evaluated once and contracted both ways; float atomics, so the last
    bits change from run to run."""
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


def laplace_pair(X1, X2, V2, V1, lengthscale, const_scaling=1.0, operands=None):
    """K6: the Laplace ``(c·K @ V2, c·Kᵀ @ V1)``, one L1/exp tile for both
    products, k ≤ 16: :func:`gram_pair`'s kernel and operands with
    Laplace's code."""
    out = _tile_pair(_code("laplace", laplace=True), X1, X2, V2, V1, lengthscale,
                     const_scaling, operands)
    laplace_pair.launches += 1
    return out


def _comp_pair(entry, kind, X1, X2, V2, V1, lengthscale, const_scaling, vtype):
    """The float64 tile's pair form through ``entry``: ``(c·K @ V2, c·Kᵀ @
    V1)`` with K = k(X1, X2), each value evaluated once in float64, any k
    (1, 2 or 4 right-hand sides a slice), X2's tiles in :func:`comp_run`
    runs; both outputs float64, views of one (n1 + n2, k) array. Float64
    atomics: the last bits change from run to run."""
    code = _code(kind, laplace=True)
    _check_tensors((torch.float32, torch.float32, vtype, vtype), X1, X2, V2, V1)
    V2c, V1c, squeeze = _check_pair(X1, X2, V2, V1, max_k=None)
    XT1, XT2 = _comp_operands(X1, X2, lengthscale)
    (n1, _), (n2, k) = X1.shape, V2c.shape
    dev = V2c.device
    slices = 1 if k <= 2 else -(-k // COMP_SLICE)
    run = comp_run(XT1.shape[1] // COMP_TILE * slices, XT2.shape[1] // COMP_TILE,
                   sm_count(dev))
    build()
    out = torch.empty((n1 + n2, k), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = getattr(_lib["handle"], entry)(
            code, XT1.data_ptr(), XT2.data_ptr(), V2c.data_ptr(), V1c.data_ptr(), out.data_ptr(),
            n1, n2, XT1.shape[1], XT2.shape[1], XT1.shape[0], k, int(run),
            float(const_scaling), _stream(V2c),
        )
    _raise_on(err, entry)
    out1, out2 = out[:n1], out[n1:]
    return (out1[:, 0], out2[:, 0]) if squeeze else (out1, out2)


def gram_pair_comp(kind, X1, X2, V2, V1, lengthscale, const_scaling=1.0):
    """The compensated pair (K1c's and K3c's pair form): ``(c·K @ V2, c·Kᵀ
    @ V1)`` in float64 from float32 points and float32 V, K = k(X1, X2)
    evaluated once (``csrc/gram_comp.cu``, ``gram_comp_pair``), every
    family. The sharded half-ring's certified route adds its float64 sums
    and splits them into ``(hi, lo)`` once, at home."""
    out = _comp_pair("rl_gram_pair_comp", kind, X1, X2, V2, V1, lengthscale, const_scaling,
                     torch.float32)
    gram_pair_comp.launches += 1
    return out


def gram_pair_f64(kind, X1, X2, V2, V1, lengthscale, const_scaling=1.0):
    """K8's pair form: :func:`gram_pair_comp` with float64 V."""
    out = _comp_pair("rl_gram_pair_f64", kind, X1, X2, V2, V1, lengthscale, const_scaling,
                     torch.float64)
    gram_pair_f64.launches += 1
    return out


def spmm_lanes(n_rows: int, nnz: int, k: int) -> int:
    """Threads of the CSR kernel on one row at k ≤ 16, from the mean row
    length: ``CSR_BLOCK_ROW`` (a block of 256) for rows of 256 entries or
    more on average, else L lanes of a warp, the power of two in [2, 32]
    nearest above ``mean / CSR_ENTRIES_PER_LANE`` (16-entry rows take 4
    lanes, 8 rows a warp). Past k = 16 the kernel gives a warp to each
    (row, column tile), and the value is not read (32 is returned). In the
    segmented schedule it is asked about the short rows alone."""
    if k > CSR_NARROW_MAX_K:
        return 32
    if nnz >= CSR_BLOCK_ROW * max(n_rows, 1):
        return CSR_BLOCK_ROW
    want = -(-nnz // (CSR_ENTRIES_PER_LANE * max(n_rows, 1)))
    lanes = 2
    while lanes < 32 and lanes < want:
        lanes *= 2
    return lanes


@dataclasses.dataclass(frozen=True)
class CSRPlan:
    """#9's plan of one CSR (:func:`csr_plan`): its sizes and its longest
    row, read from ``indptr`` once, and, where some row has more than
    ``segment`` entries, the segments of those long rows on the buffers'
    device. ``rows`` (n_long,) int32: the long rows, in order; ``first``
    (n_long + 1,) int64: long row i's segments are ``first[i]`` ..
    ``first[i + 1] - 1``, in order; ``lo``, ``hi`` (n_segs,) int64: each
    segment's entries ``[lo, hi)``; ``order`` (n_segs,) int32: the segments
    by (index in their row, row), the order they launch in past 16
    columns. ``indptr_ptr``: the address of the ``indptr`` it was built
    from, which the wrapper holds its buffers to."""

    indptr_ptr: int
    n_rows: int
    nnz: int
    max_row: int
    segment: int
    n_long: int = 0
    long_nnz: int = 0
    n_segs: int = 0
    rows: Optional[torch.Tensor] = None
    first: Optional[torch.Tensor] = None
    lo: Optional[torch.Tensor] = None
    hi: Optional[torch.Tensor] = None
    order: Optional[torch.Tensor] = None


def csr_plan(indptr: torch.Tensor, segment: Optional[int] = None) -> CSRPlan:
    """#9's plan of the CSR with this ``indptr``, built on its device: one
    read of nnz and the longest row (a synchronisation, once per CSR), and
    where a row has more than ``segment`` entries (``CSR_SEGMENT`` by
    default) the segments of every such row, ``segment`` entries each but
    the last, in order (a second read, of their count)."""
    segment = CSR_SEGMENT if segment is None else int(segment)
    if segment < 1:
        raise ValueError(f"segments of {segment} entries")
    n_rows = indptr.numel() - 1
    if n_rows < 1:
        return CSRPlan(indptr.data_ptr(), 0, 0, 0, segment)
    lengths = indptr[1:] - indptr[:-1]
    nnz, max_row = torch.stack((indptr[-1], lengths.max())).tolist()
    plan = CSRPlan(indptr.data_ptr(), n_rows, nnz, max_row, segment)
    if max_row <= segment:
        return plan
    dev = indptr.device
    rows = torch.nonzero(lengths > segment).flatten()
    n_long = rows.numel()
    long_len = lengths[rows]
    counts = (long_len + segment - 1) // segment
    first = torch.zeros(n_long + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=first[1:])
    n_segs, long_nnz = torch.stack((first[-1], long_len.sum())).tolist()
    if n_segs >= 2**31:
        raise ValueError(f"{n_segs} segments: past the int32 launch order")
    owner = torch.repeat_interleave(torch.arange(n_long, device=dev), counts,
                                    output_size=n_segs)
    j = torch.arange(n_segs, device=dev) - first[owner]
    lo = indptr[rows][owner] + j * segment
    hi = torch.minimum(lo + segment, indptr[rows + 1][owner])
    order = torch.argsort(j * n_long + owner).to(torch.int32)
    return dataclasses.replace(plan, n_long=n_long, long_nnz=long_nnz, n_segs=n_segs,
                               rows=rows.to(torch.int32), first=first, lo=lo, hi=hi,
                               order=order)


def csr_segmented(plan: CSRPlan) -> bool:
    """Whether the rows of more than ``plan.segment`` entries take the
    segmented schedule: yes, unless the rows are long and of about one
    length (the mean 256 entries or more, the longest within twice the
    mean). Such rows fill the card whole with no tail: a block of 256
    threads a row up to 16 columns (path S's adjoint CSR, 1,024 rows of
    ~16,384), a warp per (row, column tile) past 16, where the sketch's
    32,768 warps are bound by the bytes their gathers bring from L2 and
    took 42.5 ms whole against 63–68 ms in segments (``chip_smoke.py``,
    NVIDIA H100 80GB HBM3, 700 W)."""
    if plan.n_long == 0:
        return False
    mean = plan.nnz / plan.n_rows
    return not (mean >= CSR_BLOCK_ROW and plan.max_row <= 2 * mean)


def csr_chunk(n_segs: int, k: int, itemsize: int) -> int:
    """Columns a segment launch takes at once: all k up to 16 columns or
    while the partial buffer (n_segs x columns) stays within
    ``CSR_PART_BYTES``; else the most whole column tiles of 128 that do
    (at least one)."""
    if k <= CSR_NARROW_MAX_K or n_segs * k * itemsize <= CSR_PART_BYTES:
        return k
    return max(128, CSR_PART_BYTES // (n_segs * itemsize) // 128 * 128)


def _csr_launch(values, indptr, indices, X, n_rows: int, plan: Optional[CSRPlan]):
    """#9: ``Y = A @ X`` (n_rows, k) for CSR A on the card; X 2-D. ``plan``:
    the CSR's :func:`csr_plan`, or None to build it here."""
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
    nnz = values.numel()
    if plan is None:
        plan = csr_plan(indptr)
    elif (plan.indptr_ptr, plan.n_rows, plan.nnz) != (indptr.data_ptr(), n_rows, nnz):
        raise ValueError("the CSR plan was built for other buffers")
    segmented = plan.n_long > 0 and csr_segmented(plan)
    if segmented and plan.lo.device != dev:
        raise ValueError(f"the CSR plan lies on {plan.lo.device}, the buffers on {dev}")
    build()
    out = torch.empty((n_rows, k), dtype=values.dtype, device=dev)
    dtype = 0 if values.dtype == torch.float32 else 1
    with torch.cuda.device(dev):
        if not segmented:
            err = _lib["handle"].rl_csr_spmm(
                dtype, indptr.data_ptr(), indices.data_ptr(), values.data_ptr(), X2.data_ptr(),
                out.data_ptr(), int(n_rows), int(nnz), int(k),
                int(spmm_lanes(n_rows, nnz, k)), _stream(X2),
            )
        else:
            chunk = csr_chunk(plan.n_segs, k, values.element_size())
            part = torch.empty((plan.n_segs, chunk), dtype=values.dtype, device=dev)
            err = _lib["handle"].rl_csr_spmm_segmented(
                dtype, indptr.data_ptr(), indices.data_ptr(), values.data_ptr(), X2.data_ptr(),
                out.data_ptr(), part.data_ptr(), plan.lo.data_ptr(), plan.hi.data_ptr(),
                plan.order.data_ptr(), plan.first.data_ptr(), plan.rows.data_ptr(),
                int(n_rows), int(nnz), plan.n_long, plan.n_segs, plan.segment, int(k),
                int(spmm_lanes(n_rows - plan.n_long, nnz - plan.long_nnz, k)), int(chunk),
                _stream(X2),
            )
    _raise_on(err, "csr_spmm")
    return out


def csr_spmv(values, indptr, indices, x, n_rows: int, plan: Optional[CSRPlan] = None):
    """#9 at one right-hand side: ``y = A @ x`` for CSR A, x of shape
    (n_cols,) or (n_cols, 1); y of the same rank. ``plan``: the CSR's
    :func:`csr_plan` (an operator keeps it), or None to build it here."""
    squeeze = x.ndim == 1
    if not squeeze and (x.ndim != 2 or x.shape[1] != 1):
        raise ValueError(f"csr_spmv takes one right-hand side, got {tuple(x.shape)}")
    out = _csr_launch(values, indptr, indices, x[:, None] if squeeze else x, n_rows, plan)
    csr_spmv.launches += 1
    return out[:, 0] if squeeze else out


def csr_spmm(values, indptr, indices, X, n_rows: int, plan: Optional[CSRPlan] = None):
    """#9 at k ≥ 1 right-hand sides: ``Y = A @ X`` for CSR A, X (n_cols,
    k). ``plan`` as for :func:`csr_spmv`."""
    if X.ndim != 2:
        raise ValueError(f"csr_spmm takes a 2-D operand, got {tuple(X.shape)}")
    out = _csr_launch(values, indptr, indices, X, n_rows, plan)
    csr_spmm.launches += 1
    return out


_WRAPPERS = (
    gram_matmat,
    gram_matmat_comp,
    gram_matvec_symmetric_comp,
    gram_matvec_symmetric,
    gram_matmat_tier,
    gram_matvec_symmetric_tier,
    gram_matmat_f64,
    gram_matvec_symmetric_f64,
    laplace_matmat,
    laplace_matmat_narrow,
    laplace_matmat_comp,
    laplace_matvec_symmetric,
    gram_pair,
    gram_pair_tier,
    laplace_pair,
    gram_pair_comp,
    gram_pair_f64,
    csr_spmv,
    csr_spmm,
)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
