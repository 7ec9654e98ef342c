"""Sparse CSR/CSC tensor over plain torch tensors.

Port of ``rlaopt_tpu/sparse/sparse_tensor.py``: scipy round trip,
``todense``, ``astype``, ``nnz``, the zero-copy ``.T`` that relabels
CSR↔CSC, CSR row slicing, and ``@``/``__rmatmul__`` for 1-D and 2-D
operands with the JAX package's error messages. The buffers are three
tensors on one device: ``values``, ``indices`` (int32) and ``indptr``
(int64, widened once here from scipy's int32).

Every product is a CSR product (:mod:`rlaopt_tpu_torch.sparse.ops`): a CSR
view multiplies with its own buffers; a CSC view (``A.T`` of a CSR tensor)
with the CSR of the buffers' transpose, built at first use and kept in a
cache that ``.T`` views share, so ``A @ x`` and then ``A.T @ y`` build it
at most once. (The JAX package keeps a hybrid-ELL cache there, a TPU
layout.) The same cache keeps the CSR kernel's plan of each of the two CSRs
(:func:`rlaopt_tpu_torch.ops.kernel_cuda.csr_plan`: the long rows and their
segments), built at a card product's first use.
"""

from enum import Enum, auto

import numpy as np
import torch

from . import ops
from ..ops import kernel_cuda
from ..utils.checkers import _as_device


__all__ = ["SparseCSRTensor", "_SparseTensor", "_Layout"]


class _Layout(Enum):
    CSR = auto()
    CSC = auto()


def _as_buffer(a, device, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


class _SparseTensor:
    """Sparse matrix in CSR or CSC layout over torch tensors.

    Attributes:
        values: (nnz,) nonzero values.
        indices: (nnz,) int32 column indices (CSR) or row indices (CSC).
        indptr: (n_rows+1,) or (n_cols+1,) int64 compressed pointers.
        shape: logical (n_rows, n_cols).
        layout: _Layout.CSR or _Layout.CSC.
    """

    def __init__(self, values, indices, indptr, shape, layout: _Layout, device=None):
        if device is None:
            device = values.device if isinstance(values, torch.Tensor) else "cpu"
        self.values = _as_buffer(values, device)
        self.indices = _as_buffer(indices, device, torch.int32)
        self.indptr = _as_buffer(indptr, device, torch.int64)
        self.shape = (int(shape[0]), int(shape[1]))
        self.layout = layout
        # The CSR of the buffers' transpose and the kernel's plans of both
        # CSRs, shared with .T views.
        self._transpose_cache: dict = {}
        major = self.shape[0] if layout == _Layout.CSR else self.shape[1]
        if self.indptr.shape[0] != major + 1:
            raise ValueError(
                f"indptr has length {self.indptr.shape[0]}, expected {major + 1}"
            )
        if self.values.shape != self.indices.shape:
            raise ValueError("values and indices must have the same length")

    # -- properties ----------------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    def astype(self, dtype) -> "_SparseTensor":
        return _SparseTensor(
            self.values.to(dtype), self.indices, self.indptr, self.shape, self.layout
        )

    # -- scipy interop -------------------------------------------------------
    @classmethod
    def from_scipy(cls, mat, device=None) -> "_SparseTensor":
        """The tensor of a scipy sparse matrix (CSR or CSC kept, any other
        format as CSR), on the CUDA card unless ``device`` says otherwise
        (``"cpu"`` for the host), as :class:`SparseCSRTensor`; without a
        card the default raises."""
        import scipy.sparse as sp

        if sp.issparse(mat):
            device = _as_device(device)
            if mat.format == "csr":
                layout = _Layout.CSR
            elif mat.format == "csc":
                layout = _Layout.CSC
            else:
                mat = mat.tocsr()
                layout = _Layout.CSR
            return _SparseTensor(
                mat.data, mat.indices, mat.indptr, mat.shape, layout, device
            )
        raise TypeError(f"expected a scipy sparse matrix, got {type(mat)}")

    def to_scipy(self):
        import scipy.sparse as sp

        cls = sp.csr_matrix if self.layout == _Layout.CSR else sp.csc_matrix
        return cls(
            (
                self.values.cpu().numpy(),
                self.indices.cpu().numpy(),
                self.indptr.cpu().numpy(),
            ),
            shape=self.shape,
        )

    def todense(self) -> torch.Tensor:
        """The dense matrix on the buffers' device; repeated entries add."""
        major = self.shape[0] if self.layout == _Layout.CSR else self.shape[1]
        seg = torch.repeat_interleave(
            torch.arange(major, device=self.device), self.indptr[1:] - self.indptr[:-1]
        )
        idx = self.indices.long()
        where = (seg, idx) if self.layout == _Layout.CSR else (idx, seg)
        dense = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return dense.index_put_(where, self.values, accumulate=True)

    # -- transpose: zero-copy relabel ----------------------------------------
    @property
    def T(self) -> "_SparseTensor":
        new_layout = _Layout.CSC if self.layout == _Layout.CSR else _Layout.CSR
        t = _SparseTensor(
            self.values, self.indices, self.indptr, (self.shape[1], self.shape[0]),
            new_layout,
        )
        t._transpose_cache = self._transpose_cache  # same buffers, one cache
        return t

    def _csr_buffers(self):
        """``(values, indices, indptr)`` of THIS view's CSR: its own buffers
        (CSR) or the cached CSR of their transpose (CSC)."""
        if self.layout == _Layout.CSR:
            return self.values, self.indices, self.indptr
        if "BT" not in self._transpose_cache:
            self._transpose_cache["BT"] = ops.csr_transpose(
                self.values, self.indptr, self.indices, self.shape[0]
            )
        return self._transpose_cache["BT"]

    def _csr_plan(self) -> kernel_cuda.CSRPlan:
        """The CSR kernel's plan of THIS view's CSR (:meth:`_csr_buffers`),
        built once and shared by ``.T`` views."""
        key = "plan" if self.layout == _Layout.CSR else "BT_plan"
        if key not in self._transpose_cache:
            self._transpose_cache[key] = kernel_cuda.csr_plan(self._csr_buffers()[2])
        return self._transpose_cache[key]

    # -- row slicing ---------------------------------------------------------
    def __getitem__(self, idx) -> "_SparseTensor":
        """Row gather (CSR only, like the reference's get_row_slice op)."""
        if self.layout != _Layout.CSR:
            raise NotImplementedError(
                "row slicing is only supported for CSR layout; transpose or "
                "convert first"
            )
        idx = self._normalize_indices(idx)
        v, c, p = ops.gather_rows(self.values, self.indptr, self.indices, idx)
        return _SparseTensor(v, c, p, (len(idx), self.shape[1]), _Layout.CSR)

    def _normalize_indices(self, idx) -> np.ndarray:
        n = self.shape[0]
        if isinstance(idx, slice):
            out = np.arange(*idx.indices(n))
        elif isinstance(idx, int):
            out = np.asarray([idx])
        elif isinstance(idx, torch.Tensor):
            out = idx.cpu().numpy().reshape(-1)
        elif isinstance(idx, (list, tuple, np.ndarray)):
            out = np.asarray(idx).reshape(-1)
        else:
            raise TypeError(f"unsupported index type {type(idx)}")
        if out.size and (out.min() < -n or out.max() >= n):
            raise IndexError(
                f"row indices out of bounds for {n} rows: "
                f"[{out.min()}, {out.max()}]"
            )
        return np.where(out < 0, out + n, out)

    # -- matmul --------------------------------------------------------------
    def __matmul__(self, x) -> torch.Tensor:
        x = _as_operand(x, self.device)
        if x.ndim not in (1, 2):
            raise ValueError(f"operand must be 1D or 2D, received {x.ndim}D")
        if x.shape[0] != self.shape[1]:
            raise ValueError(
                f"dimension mismatch: {self.shape} @ {tuple(x.shape)}"
            )
        values, indices, indptr = self._csr_buffers()
        fn = ops.csr_matvec if x.ndim == 1 else ops.csr_matmat
        plan = self._csr_plan() if values.is_cuda else None
        return fn(values, indptr, indices, x, self.shape[0], plan=plan)

    def __rmatmul__(self, x) -> torch.Tensor:
        x = _as_operand(x, self.device)
        if x.ndim == 1:
            if x.shape[0] != self.shape[0]:
                raise ValueError(
                    f"dimension mismatch: {tuple(x.shape)} @ {self.shape}"
                )
            return self.T @ x
        if x.ndim == 2:
            if x.shape[1] != self.shape[0]:
                raise ValueError(
                    f"dimension mismatch: {tuple(x.shape)} @ {self.shape}"
                )
            return (self.T @ x.T).T
        raise ValueError(f"operand must be 1D or 2D, received {x.ndim}D")

    def __repr__(self):
        return (
            f"{type(self).__name__}(shape={self.shape}, nnz={self.nnz}, "
            f"layout={self.layout.name}, dtype={self.dtype}, device={self.device})"
        )


def _as_operand(x, device) -> torch.Tensor:
    """A tensor as it is (its device is checked where it is used); anything
    else as a tensor on the sparse tensor's device."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=device)


class SparseCSRTensor(_SparseTensor):
    """User-facing CSR tensor: from a scipy csr_matrix/csr_array or raw
    buffers ``(values, indices, indptr, shape)``.

    ``device`` defaults to the CUDA card and raises when there is none; pass
    ``device="cpu"`` to hold the tensor on the host (its products then take
    the plain versions).
    """

    def __init__(self, arg, indices=None, indptr=None, shape=None, device=None):
        device = _as_device(device)
        try:
            import scipy.sparse as sp

            is_scipy = sp.issparse(arg)
        except ImportError:
            is_scipy = False
        if is_scipy:
            m = arg.tocsr()
            super().__init__(m.data, m.indices, m.indptr, m.shape, _Layout.CSR, device)
        else:
            if not isinstance(arg, (torch.Tensor, np.ndarray)):
                raise TypeError(
                    f"expected values to be a tensor or array; got {type(arg).__name__}"
                )
            if indices is None or indptr is None or shape is None:
                raise TypeError(
                    "SparseCSRTensor requires either a scipy CSR matrix or "
                    "(values, indices, indptr, shape)"
                )
            super().__init__(arg, indices, indptr, shape, _Layout.CSR, device)
        # The kernels read these buffers unchecked: a CSR from outside is
        # validated once, here.
        p = self.indptr
        if int(p[0]) != 0 or int(p[-1]) != self.nnz or bool(torch.any(p[1:] < p[:-1])):
            raise ValueError(f"indptr must rise from 0 to nnz = {self.nnz}")
        if self.nnz and (
            int(self.indices.min()) < 0 or int(self.indices.max()) >= self.shape[1]
        ):
            raise ValueError(f"column indices out of range for {self.shape[1]} columns")
