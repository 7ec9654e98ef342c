"""Sparse tensor → matrix-free operator adapter.

Port of ``rlaopt_tpu/sparse/linop.py::sparse_aslinop``: a sparse matrix
drops into every consumer of the operator API (``LstSq``/``LSQR``/``SkPre``,
the sketches, ``LinSys``) as a :class:`~rlaopt_tpu_torch.linops.TwoSidedLinOp`.

Its payload is two CSR copies, as in the JAX package's ``impl="laned"``:
the CSR of A for ``A @ x`` and the CSR of Aᵀ, built once at construction
(and shared with the tensor's ``.T`` views), for ``Aᵀ @ y``. Both applies
are gathers through the hand-written CSR kernel on a card, and the plain
versions on the CPU; neither scatters. On a card the kernel's plan of each
CSR (its long rows' segments, :func:`kernel_cuda.csr_plan`) is built at
construction too, so no apply reads the row lengths.

:func:`sparse_shard_rows` cuts a CSR tensor's rows over the positions of a
mesh, each chunk such an operator on its position's device.

Not carried over: the TPU layouts ``impl="ell"`` and ``impl="laned"``
(they exist because the TPU has no hardware gather) and the densify-when-it-
fits rule of ``impl="auto"`` (measured on a chip with no gather).
"""

from . import ops
from .sparse_tensor import _Layout, _SparseTensor
from ..linops.base import TwoSidedLinOp, aslinop
from ..parallel.mesh import move


__all__ = ["sparse_aslinop", "sparse_shard_rows"]


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
    card = sp.values.is_cuda
    fplan = sp._csr_plan() if card else None
    aplan = sp.T._csr_plan() if card else None

    def mv(x):
        return ops.csr_matvec(fv, fp, fi, x, m, plan=fplan)

    def mm(X):
        return ops.csr_matmat(fv, fp, fi, X, m, plan=fplan)

    def rmv(x):
        return ops.csr_matvec(av, ap, ai, x, n, plan=aplan)

    def rmm(X):
        return ops.csr_matmat(av, ap, ai, X, n, plan=aplan)

    return TwoSidedLinOp(
        (m, n), mv, rmv, matmat=mm, rmatmat=rmm, dtype=sp.dtype, device=sp.device
    )


def sparse_shard_rows(sp: _SparseTensor, mesh, axis="i", impl: str = "auto"):
    """Row-partition a sparse CSR tensor over a mesh as a ShardedLinOp.

    Rows are split into contiguous chunks of ceil(m / P) (the reference's
    ``torch.chunk`` semantics; the last may be shorter), each chunk becomes
    an operator of :func:`sparse_aslinop` on its position's device (its CSR
    and the CSR of its transpose, kernel #9 on a card), and the chunks
    compose through :meth:`ShardedLinOp.from_local_ops`: the forward product
    gathers the chunks' outputs, the adjoint psums their partials. ``impl``
    as in :func:`sparse_aslinop`, the same for every chunk.
    """
    from ..linops.sharded import ShardedLinOp
    from ..parallel.distributed import axis_size

    if not isinstance(sp, _SparseTensor):
        raise TypeError(f"expected a sparse tensor, got {type(sp).__name__}")
    if sp.layout != _Layout.CSR:
        raise ValueError(
            "sparse_shard_rows needs CSR layout (row slicing); "
            "transpose a CSC tensor first (.T is zero-copy)"
        )
    m, n = sp.shape
    ndev = axis_size(mesh, axis)
    chunk = -(-m // ndev)
    bounds = [(i * chunk, min((i + 1) * chunk, m)) for i in range(ndev)]
    if any(s >= e for s, e in bounds):
        raise ValueError(
            f"{m} rows over {ndev} devices leaves empty shards; "
            "use a smaller mesh axis"
        )
    indptr = sp.indptr.cpu()
    local_ops = []
    for (s, e), dev in zip(bounds, mesh.devices):
        lo, hi = int(indptr[s]), int(indptr[e])
        part = _SparseTensor(
            move(sp.values[lo:hi], dev), move(sp.indices[lo:hi], dev),
            move(sp.indptr[s : e + 1] - lo, dev), (e - s, n), _Layout.CSR, dev,
        )
        local_ops.append(sparse_aslinop(part, impl=impl))
    return ShardedLinOp.from_local_ops(local_ops, mesh, mode="row", axis=axis)
