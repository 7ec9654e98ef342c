"""The ceiling probes: the TPU's on-chip throughput probes as H100 kernels.

Counterpart of the Pallas probes of ``bench.py`` and ``benchmarks/``
(TPU kernels #10–#13), which measured the rates that the Gram kernels are
read against: the L1 pair rate (``acc += |x − y|``, the inner step of the
Laplace kernels), the ``exp`` rate and the Gram epilogue's rate. Each
function here computes what its TPU body computes, on a CUDA tensor with
the hand-written kernel of ``csrc/probes.cu`` (operands held in registers
and shared memory in the hot loop, as the TPU body holds them in VMEM: the
L1 probe stages a whole feature block at a time) and
on a CPU tensor with its plain PyTorch version:

* :func:`probe_l1` (#10 ``bench.py::make_vpu_peak``, #12
  ``benchmarks/vpu_probe_study.py::probe_pallas_bcast``): the L1 matrix of
  X (nb, tm, fb) against Y (nb, fb, tn), summed over the nb feature blocks;
  a leading batch axis holds independent instances (the card needs many
  blocks where the TPU's one core ran a grid step after another);
* :func:`probe_elem` (#12 ``vpu_probe_study.py::probe_pallas_elem``):
  ``acc = y``, then ``acc = |acc − x| + y`` 64 times;
* :func:`probe_exp_chain` (#13 ``benchmarks/exp_probe_study.py::probe``):
  ``acc = y``, then ``acc = exp(−|acc − x|)`` 64 times;
* :func:`probe_vmem_chain` (#11 ``bench.py::_make_vmem_chain_probe``):
  ``Σ_r step(x, y, 0.25 + 0.01 r)`` over 64 reps, with the step of
  ``make_exp_peak`` (``"exp"``: ``exp(−c x)``) or of
  ``make_epilogue_bound`` (``"epilogue"``: ``exp(x − y − c) · y``).

:data:`SPECS` holds the TPU probes' shapes and :func:`events` their own
count of events (pairs, elements times reps), so that a rate reads as the
TPU probe's did. The kernels' exp is ``__expf`` (an FMUL and the SFU's
``ex2``), a few float32 ulps from ``torch.exp``.
"""

import ctypes

import torch

from . import kernel_cuda


__all__ = [
    "probe_l1",
    "probe_elem",
    "probe_exp_chain",
    "probe_vmem_chain",
    "probe_l1_plain",
    "probe_elem_plain",
    "probe_exp_chain_plain",
    "probe_vmem_chain_plain",
    "SPECS",
    "events",
    "launch_counts",
    "reset_launch_counts",
]

REPS = 64  # every TPU probe's reps (csrc/probes.cu kReps)
TILE = 128  # probe_l1's block of output rows and columns
# probe_l1's features a stage (csrc/probes.cu L1Shape)
FEAT = {torch.float32: 64, torch.float64: 32}
_CHAIN_MODES = {"elem": 0, "exp_chain": 1, "exp": 2, "epilogue": 3}

# The TPU probes, by name: what each ran per call (its pallas_call's shapes)
# and the line of its def. "l1": X (nb, tm, fb), Y (nb, fb, tn); the chains:
# (grid * tm, tn) tiles. data: the TPU probe's operands, standard normal or
# uniform in [0, 1).
SPECS = {
    "vpu_peak": dict(tpu="bench.py:146", number=10, kind="l1", nb=16, tm=512, tn=1024, fb=64,
                     data="normal"),
    "bcast_256x256": dict(tpu="benchmarks/vpu_probe_study.py:86", number=12, kind="l1", nb=64,
                          tm=256, tn=256, fb=64, data="normal"),
    "bcast_512x1024": dict(tpu="benchmarks/vpu_probe_study.py:86", number=12, kind="l1", nb=16,
                           tm=512, tn=1024, fb=64, data="normal"),
    "bcast_256x1024": dict(tpu="benchmarks/vpu_probe_study.py:86", number=12, kind="l1", nb=32,
                           tm=256, tn=1024, fb=64, data="normal"),
    "elem_256x256": dict(tpu="benchmarks/vpu_probe_study.py:125", number=12, kind="elem",
                         grid=64, tm=256, tn=256, data="normal"),
    "elem_512x1024": dict(tpu="benchmarks/vpu_probe_study.py:125", number=12, kind="elem",
                          grid=8, tm=512, tn=1024, data="normal"),
    "exp_peak": dict(tpu="bench.py:215", number=11, kind="exp", grid=8, tm=512, tn=1024,
                     data="uniform"),
    "epilogue_bound": dict(tpu="bench.py:215", number=11, kind="epilogue", grid=8, tm=512,
                           tn=1024, data="uniform"),
    "exp_chain_512x1024": dict(tpu="benchmarks/exp_probe_study.py:116", number=13,
                               kind="exp_chain", grid=8, tm=512, tn=1024, data="normal"),
    "exp_chain_256x256": dict(tpu="benchmarks/exp_probe_study.py:116", number=13,
                              kind="exp_chain", grid=64, tm=256, tn=256, data="normal"),
}


def events(spec: dict, instances: int = 1) -> float:
    """The TPU probe's count of events in one call of ``instances``
    instances: pairs (one broadcast subtraction, abs and add per output
    element and feature) for "l1", elements times reps for the chains."""
    if spec["kind"] == "l1":
        return float(spec["tm"]) * spec["tn"] * spec["fb"] * spec["nb"] * instances
    return float(spec["grid"]) * spec["tm"] * spec["tn"] * REPS * instances


def probe_l1_plain(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The TPU body's order: for each block b, for each feature f, ``l1 =
    l1 + |x[:, f] − y[f, :]|`` on (tm, tn) tiles, in the dtype of X."""
    out = X.new_zeros((*X.shape[:-3], X.shape[-2], Y.shape[-1]))
    for b in range(X.shape[-3]):
        xb, yb = X[..., b, :, :], Y[..., b, :, :]
        for f in range(X.shape[-1]):
            out = out + (xb[..., :, f, None] - yb[..., None, f, :]).abs()
    return out


def probe_elem_plain(X: torch.Tensor, Y: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    acc = Y
    for _ in range(reps):
        acc = (acc - X).abs() + Y
    return acc


def probe_exp_chain_plain(X: torch.Tensor, Y: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    acc = Y
    for _ in range(reps):
        acc = torch.exp(-(acc - X).abs())
    return acc


def _step(step: str, x, y, c: float):
    if step == "exp":
        return torch.exp(x * (-c))
    if step == "epilogue":
        return torch.exp((x - y) - c) * y
    raise ValueError(f"Unknown probe step {step!r}")


def probe_vmem_chain_plain(X: torch.Tensor, Y: torch.Tensor, step: str,
                           reps: int = REPS) -> torch.Tensor:
    """``Σ_r step(x, y, c_r)`` with ``c_r = 0.25 + 0.01 r`` rounded to the
    dtype of X, summed in rep order, as the TPU body."""
    acc = torch.zeros_like(X)
    for r in range(reps):
        acc = acc + _step(step, X, Y, float(torch.tensor(0.25 + 0.01 * r, dtype=X.dtype)))
    return acc


def _check(X: torch.Tensor, Y: torch.Tensor, dtypes):
    if X.device != Y.device:
        raise ValueError(f"tensors on {X.device} and {Y.device}")
    if X.dtype not in dtypes or Y.dtype != X.dtype:
        raise NotImplementedError(f"this probe takes {dtypes}, got {X.dtype} and {Y.dtype}")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def probe_l1(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """#10 / #12: ``out[..., r, c] = Σ_b Σ_f |X[..., b, r, f] − Y[..., b, f,
    c]|`` for X (..., nb, tm, fb) and Y (..., nb, fb, tn), at most one
    leading (instance) axis, float32 (the TPU probes' type) or float64 (the
    FP64 ceiling). On a card tm and tn are multiples of 128 and fb of 64
    (float32; 32 in float64), a feature block staged whole (every TPU
    probe's fb is 64)."""
    _check(X, Y, (torch.float32, torch.float64))
    if X.ndim not in (3, 4) or Y.ndim != X.ndim or X.shape[:-2] != Y.shape[:-2] \
            or X.shape[-1] != Y.shape[-2]:
        raise ValueError(f"X {tuple(X.shape)} and Y {tuple(Y.shape)}")
    if not X.is_cuda:
        return probe_l1_plain(X, Y)
    B = X.shape[0] if X.ndim == 4 else 1
    nb, tm, fb = X.shape[-3:]
    tn = Y.shape[-1]
    Xc, Yc = X.contiguous(), Y.contiguous()
    if Yc.data_ptr() % 16:
        raise ValueError("probe_l1 reads Y in 16-byte pieces: pass an aligned Y")
    out = torch.empty((*X.shape[:-3], tm, tn), dtype=X.dtype, device=X.device)
    kernel_cuda.build()
    with torch.cuda.device(X.device):
        err = kernel_cuda._lib["handle"].rl_probe_l1(
            0 if X.dtype == torch.float32 else 1, Xc.data_ptr(), Yc.data_ptr(),
            out.data_ptr(), B, nb, tm, tn, fb, _stream(X))
    if err != 0:
        raise RuntimeError(f"probe_l1 launch failed: CUDA error {err} (tm and tn must be "
                           f"multiples of {TILE}, fb of {FEAT[X.dtype]})")
    probe_l1.launches += 1
    return out


def _check_chain(X, Y):
    _check(X, Y, (torch.float32,))
    if X.shape != Y.shape:
        raise ValueError(f"X {tuple(X.shape)} and Y {tuple(Y.shape)}")


def _chain(name, mode, X, Y):
    Xc, Yc = X.contiguous(), Y.contiguous()
    out = torch.empty_like(Xc)
    kernel_cuda.build()
    with torch.cuda.device(X.device):
        err = kernel_cuda._lib["handle"].rl_probe_chain(
            _CHAIN_MODES[mode], Xc.data_ptr(), Yc.data_ptr(), out.data_ptr(), Xc.numel(),
            _stream(X))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def probe_elem(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """#12: ``acc = Y``, then ``acc = |acc − X| + Y`` 64 times, float32."""
    _check_chain(X, Y)
    if not X.is_cuda:
        return probe_elem_plain(X, Y)
    out = _chain("probe_elem", "elem", X, Y)
    probe_elem.launches += 1
    return out


def probe_exp_chain(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """#13: ``acc = Y``, then ``acc = exp(−|acc − X|)`` 64 times, float32."""
    _check_chain(X, Y)
    if not X.is_cuda:
        return probe_exp_chain_plain(X, Y)
    out = _chain("probe_exp_chain", "exp_chain", X, Y)
    probe_exp_chain.launches += 1
    return out


def probe_vmem_chain(X: torch.Tensor, Y: torch.Tensor, step: str) -> torch.Tensor:
    """#11: ``Σ_r step(X, Y, 0.25 + 0.01 r)`` over 64 independent reps,
    float32; ``step`` "exp" (``exp(−c x)``) or "epilogue" (``exp(x − y −
    c) · y``)."""
    if step not in ("exp", "epilogue"):
        raise ValueError(f"Unknown probe step {step!r}")
    _check_chain(X, Y)
    if not X.is_cuda:
        return probe_vmem_chain_plain(X, Y, step)
    out = _chain("probe_vmem_chain", step, X, Y)
    probe_vmem_chain.launches += 1
    return out


_WRAPPERS = (probe_l1, probe_elem, probe_exp_chain, probe_vmem_chain)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
