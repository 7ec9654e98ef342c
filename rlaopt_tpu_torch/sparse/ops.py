"""Sparse matvec/matmat and row gathers on raw CSR/CSC buffers.

Port of ``rlaopt_tpu/sparse/ops.py`` with its signatures. CPU tensors go to
the plain versions: the JAX package's XLA formulation, a segment sum of
``values * x[indices]`` by row (``index_add_``) for CSR and a scatter-add by
row index for CSC. CUDA tensors go to the hand-written CSR kernel
(:func:`rlaopt_tpu_torch.ops.kernel_cuda.csr_spmv` / ``csr_spmm``, the port
of TPU kernel #9); a CSC product there is the CSR product of the transposed
buffers (:func:`csr_transpose`), never a scatter. What the kernel cannot
take raises; nothing falls back.

``impl`` takes the JAX package's values: ``"auto"`` is the rule above,
``"xla"`` the plain version on any device; ``"native"`` names the JAX
package's OpenMP CPU kernels (``csrc/sparse_ops.cc`` through XLA FFI),
which the port does not carry, and raises what the JAX package raises when
they are not built. Any other value raises ``ValueError``. ``plan``, the
port's own, comes after it.

The buffers must form a valid CSR (indptr rising from 0 to nnz, indices
within range), as :class:`~rlaopt_tpu_torch.sparse.SparseCSRTensor` checks
once when it is built: the kernel reads them unchecked.

The plain versions stream the nonzeros in blocks, so that the gathered
``values[:, None] * X[indices]`` temporary stays under ``PLAIN_BLOCK_BYTES``
(1 GiB): unblocked, at the sketch of a 2^20 x 1,024 operand with 16
nonzeros a row (k = 4,096), it would take 275 GB.

:func:`gather_rows` is host-driven and eager, as in the JAX package: the
output's size depends on the data.
"""

import numpy as np
import torch

from ..ops import kernel_cuda


__all__ = [
    "csr_matvec",
    "csr_matmat",
    "csc_matvec",
    "csc_matmat",
    "csr_transpose",
    "gather_rows",
    "PLAIN_BLOCK_BYTES",
]

PLAIN_BLOCK_BYTES = 1 << 30


def _segments(indptr: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Segment (row of a CSR, column of a CSC) of entries start..stop-1."""
    pos = torch.arange(start, stop, device=indptr.device, dtype=indptr.dtype)
    return torch.searchsorted(indptr, pos, right=True) - 1


def _plain(values, indptr, indices, X, n_out: int, gather_segments: bool):
    """Blocked segment product. ``gather_segments=False`` (CSR): out[seg] +=
    v · X[indices]; True (CSC): out[indices] += v · X[seg]."""
    k = X.shape[1]
    dtype = torch.promote_types(values.dtype, X.dtype)
    out = torch.zeros((n_out, k), dtype=dtype, device=X.device)
    nnz = values.shape[0]
    block = max(1, PLAIN_BLOCK_BYTES // (k * torch.finfo(dtype).bits // 8))
    for s in range(0, nnz, block):
        e = min(nnz, s + block)
        seg = _segments(indptr, s, e)
        idx = indices[s:e].long()
        src, dst = (seg, idx) if gather_segments else (idx, seg)
        out.index_add_(0, dst, values[s:e, None].to(dtype) * X[src].to(dtype))
    return out


IMPLS = ("auto", "xla", "native")


def _on_card(impl: str, *tensors) -> bool:
    """Whether ``impl`` sends these operands to the CUDA kernel."""
    if impl not in IMPLS:
        raise ValueError(f"Unknown sparse impl {impl!r}; expected one of {IMPLS}")
    if impl == "native":
        raise RuntimeError("native sparse kernels unavailable")
    return impl == "auto" and any(t.is_cuda for t in tensors)


# -- CSR ---------------------------------------------------------------------
def csr_matvec(values, indptr, indices, x, n_rows: int, impl: str = "auto", plan=None):
    """y = A @ x for CSR A. ``plan``: the kernel's plan of the CSR
    (:func:`kernel_cuda.csr_plan`, kept by the sparse tensor), read on a
    card only; None builds it there."""
    if _on_card(impl, values, x):
        return kernel_cuda.csr_spmv(values, indptr, indices, x, n_rows, plan)
    return _plain(values, indptr, indices, x[:, None], n_rows, False)[:, 0]


def csr_matmat(values, indptr, indices, X, n_rows: int, impl: str = "auto", plan=None):
    """Y = A @ X for CSR A, X (m, k); ``plan`` as for :func:`csr_matvec`."""
    if _on_card(impl, values, X):
        if X.ndim == 2 and X.shape[1] == 1:
            return kernel_cuda.csr_spmv(values, indptr, indices, X, n_rows, plan)
        return kernel_cuda.csr_spmm(values, indptr, indices, X, n_rows, plan)
    return _plain(values, indptr, indices, X, n_rows, False)


# -- CSC ---------------------------------------------------------------------
def csc_matvec(values, indptr, row_idx, x, n_rows: int, impl: str = "auto"):
    """y = A @ x for CSC A (indptr over columns, row_idx per entry)."""
    if _on_card(impl, values, x):
        t_values, t_indices, t_indptr = csr_transpose(values, indptr, row_idx, n_rows)
        return csr_matvec(t_values, t_indptr, t_indices, x, n_rows)
    return _plain(values, indptr, row_idx, x[:, None], n_rows, True)[:, 0]


def csc_matmat(values, indptr, row_idx, X, n_rows: int, impl: str = "auto"):
    """Y = A @ X for CSC A, X (m, k)."""
    if _on_card(impl, values, X):
        t_values, t_indices, t_indptr = csr_transpose(values, indptr, row_idx, n_rows)
        return csr_matmat(t_values, t_indptr, t_indices, X, n_rows)
    return _plain(values, indptr, row_idx, X, n_rows, True)


# -- layout ------------------------------------------------------------------
def csr_transpose(values, indptr, indices, n_cols: int):
    """The CSR buffers of Bᵀ from those of B (n_rows × n_cols): ``(values,
    indices, indptr)`` on the buffers' device, int32 indices and int64
    indptr. Each row of Bᵀ keeps B's row order (a stable sort), so the
    order of every sum over it is fixed."""
    n_rows = indptr.shape[0] - 1
    counts = indptr[1:] - indptr[:-1]
    rows = torch.repeat_interleave(
        torch.arange(n_rows, dtype=torch.int32, device=indptr.device), counts
    )
    order = torch.sort(indices, stable=True).indices
    t_indptr = torch.zeros(n_cols + 1, dtype=torch.int64, device=indptr.device)
    torch.cumsum(torch.bincount(indices.long(), minlength=n_cols), 0, out=t_indptr[1:])
    return values[order], rows[order], t_indptr


# -- row slicing -------------------------------------------------------------
def gather_rows(values, indptr, indices, sel, impl: str = "auto"):
    """CSR row gather: returns (new_values, new_indices, new_indptr).

    Output nnz is data-dependent, so this op is host-driven (eager), like
    the reference's ``get_row_slice``, whatever ``impl`` (``"native"``
    raises, as without the JAX package's native kernels).
    """
    _on_card(impl)
    indptr_np = indptr.cpu().numpy()
    sel_np = np.asarray(sel.cpu() if isinstance(sel, torch.Tensor) else sel)
    counts = indptr_np[sel_np + 1] - indptr_np[sel_np]
    new_indptr = np.zeros(len(sel_np) + 1, dtype=indptr_np.dtype)
    np.cumsum(counts, out=new_indptr[1:])
    nnz2 = int(new_indptr[-1])
    starts = indptr_np[sel_np]
    flat = np.repeat(starts - new_indptr[:-1], counts) + np.arange(
        nnz2, dtype=indptr_np.dtype
    )
    flat_t = torch.as_tensor(flat, device=values.device)
    return (
        values[flat_t],
        indices[flat_t],
        torch.as_tensor(new_indptr, device=indptr.device),
    )
