"""Sparse tensor → matrix-free operator adapter.

Port of ``rlaopt_tpu/sparse/linop.py::sparse_aslinop``: a sparse matrix
drops into every consumer of the operator API (``LstSq``/``LSQR``/``SkPre``,
the sketches, ``LinSys``) as a :class:`~rlaopt_tpu_torch.linops.TwoSidedLinOp`.

Its payload is two CSR copies, as in the JAX package's ``impl="laned"``:
the CSR of A for ``A @ x`` and the CSR of Aᵀ, built once at construction
(and shared with the tensor's ``.T`` views), for ``Aᵀ @ y``. Both applies
are gathers through the hand-written CSR kernel on a card, and the plain
versions on the CPU; neither scatters.

Not carried over: the TPU layouts ``impl="ell"`` and ``impl="laned"``
(they exist because the TPU has no hardware gather), the densify-when-it-
fits rule of ``impl="auto"`` (measured on a chip with no gather), and
``sparse_shard_rows`` (with the sharded operators).
"""

from . import ops
from .sparse_tensor import _SparseTensor
from ..linops.base import TwoSidedLinOp, aslinop


__all__ = ["sparse_aslinop"]


def sparse_aslinop(sp: _SparseTensor, impl: str = "auto") -> TwoSidedLinOp:
    """Wrap a sparse CSR/CSC tensor as a two-sided matrix-free operator.

    Args:
        sp: the sparse tensor.
        impl: ``"auto"`` or ``"triplet"`` (the two CSR copies; the CSR
            kernel on a card, the plain versions on the CPU) or ``"dense"``
            (materialize the matrix). ``"ell"`` and ``"laned"`` are the JAX
            package's TPU layouts and raise.
    """
    if not isinstance(sp, _SparseTensor):
        raise TypeError(f"expected a sparse tensor, got {type(sp).__name__}")
    if impl in ("ell", "laned"):
        raise ValueError(
            f"impl={impl!r} is a TPU layout (the TPU has no hardware gather); "
            "on this device the CSR route serves: use impl='auto' or 'triplet'"
        )
    if impl not in ("auto", "dense", "triplet"):
        raise ValueError(f"impl must be auto|dense|triplet, got {impl!r}")
    if impl == "dense":
        return aslinop(sp.todense())

    m, n = sp.shape
    fv, fi, fp = sp._csr_buffers()
    av, ai, ap = sp.T._csr_buffers()

    def mv(x):
        return ops.csr_matvec(fv, fp, fi, x, m)

    def mm(X):
        return ops.csr_matmat(fv, fp, fi, X, m)

    def rmv(x):
        return ops.csr_matvec(av, ap, ai, x, n)

    def rmm(X):
        return ops.csr_matmat(av, ap, ai, X, n)

    return TwoSidedLinOp(
        (m, n), mv, rmv, matmat=mm, rmatmat=rmm, dtype=sp.dtype, device=sp.device
    )
