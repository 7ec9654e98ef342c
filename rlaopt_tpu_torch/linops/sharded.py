"""Mesh-sharded matrix-free operators.

Port of ``rlaopt_tpu/linops/sharded.py``. An operator is a payload cut over
the positions of a :class:`~rlaopt_tpu_torch.parallel.Mesh` (one entry per
position, on its device) plus a local function ``f(payload, x)``; the
collectives are those of :mod:`rlaopt_tpu_torch.parallel.mesh`:

=====================  ==========================================  =============
reference semantics     this class                                  collective
=====================  ==========================================  =============
ROW matvec              local matvec on the row shard               none (output
 (broadcast x, concat)                                              stays sharded)
ROW rmatvec             local rmatvec on the row shard of y         psum
 (chunk rows, sum)
COLUMN matvec           local matvec on the column shard of x       psum
COLUMN rmatvec          local rmatvec, output column-sharded        none
transpose               flips mode — metadata only                  —
=====================  ==========================================  =============

As in the JAX package, the sharded dim is zero-padded to a multiple of the
mesh size and cut into equal chunks (padded rows multiply zeros, padded
output rows are sliced off); ``gather_idx`` maps logical to physical
indices when ragged per-position chunks leave padding inside the layout.
Operands and results are whole tensors on the mesh's home device; a
sharded output is gathered there (:func:`~rlaopt_tpu_torch.parallel.gather`
and ``torch.cat``), a psum adds in position order. On a mesh that spans
processes each process computes its own positions only (the payload holds
None at the others') and the gathers and psums cross processes: every
process ends with the same bits.

``axis`` may be a tuple naming every axis of a 2-D mesh
(:func:`rlaopt_tpu_torch.parallel.make_mesh_2d`); the positions are then
taken in row-major order.

The payload comes one of two ways. The port's own: ``data`` a sequence of
one payload per position, each on its device. The JAX package's: ``data``
one pytree (a tensor, or tuples, lists and dicts of them) and
``data_specs`` a matching pytree of partition specs, as ``shard_map`` reads
them: a leaf whose spec names mesh axes in its first entry (``("i",)``,
``("i", None)``, ``(("dcn", "i"),)`` or the JAX ``PartitionSpec`` of the
same entries) has its rows cut over those axes
(:func:`rlaopt_tpu_torch.parallel.shard_rows`), a leaf whose spec is
``None`` or names none is replicated, and each position receives the pytree
of its blocks.
"""

from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from .base import TwoSidedLinOp
from .enums import _DistributionMode
from ..parallel.distributed import axis_size
from ..parallel.mesh import Mesh, gather, move, pad_to_multiple, psum, shard_rows


__all__ = [
    "ShardedLinOp",
    "DistributedLinOp",
    "DistributedTwoSidedLinOp",
    "DistributedSymmetricLinOp",
]


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _check_axis(mesh: Mesh, axis):
    """The sharded dim is cut over every position of the mesh."""
    if set(_axes(axis)) != set(mesh.axis_names) or len(_axes(axis)) != len(mesh.axis_names):
        raise ValueError(
            f"axis {axis!r} must name every axis of the mesh {mesh.axis_names}"
        )


def _apply(op, x, adjoint: bool):
    """``op @ x`` or ``opᵀ @ x`` for a 1-D or 2-D operand."""
    if not adjoint:
        return op @ x
    return op.rmatvec(x) if x.ndim == 1 else op.rmatmat(x)


def _pad_rows(x, target: int):
    return x if x.shape[0] == target else pad_to_multiple(x, target)[0]


def _row_axes(spec):
    """The mesh axes a leaf's partition spec cuts its rows over (None:
    replicated). Only the first dimension may be sharded."""
    if spec is None or isinstance(spec, str):
        return spec
    entries = tuple(spec)
    if any(e is not None for e in entries[1:]):
        raise NotImplementedError(
            f"partition spec {spec!r}: only the first dimension of a payload may be sharded"
        )
    return entries[0] if entries else None


def _place(data, specs, mesh: Mesh) -> list:
    """The JAX package's payload ``data`` with its partition specs
    ``specs``: one pytree of blocks per position (None at another
    process's). A container of ``data`` meets a container of specs of the
    same length (or keys) element by element; any other spec applies to
    every leaf below it."""
    if isinstance(data, dict):
        keys = list(data)
        sub = specs if isinstance(specs, dict) else dict.fromkeys(keys, specs)
        placed = {key: _place(data[key], sub[key], mesh) for key in keys}
        return mesh.map(lambda p: {key: placed[key][p] for key in keys})
    if isinstance(data, (tuple, list)):
        paired = isinstance(specs, (tuple, list)) and len(specs) == len(data)
        parts = [_place(x, specs[i] if paired else specs, mesh) for i, x in enumerate(data)]
        return mesh.map(lambda p: type(data)(part[p] for part in parts))
    axes = _row_axes(specs)
    if axes is None:
        return mesh.map(lambda p: move(data, mesh.devices[p]))
    return shard_rows(data, mesh, axis=axes)


class ShardedLinOp(TwoSidedLinOp):
    """Operator whose payload is sharded over the positions of a mesh.

    Args:
        shape: logical (n_rows, n_cols) — unpadded.
        matvec / rmatvec: local functions ``f(payload, x)``; in ROW mode
            matvec receives a position's payload and the full operand,
            rmatvec the position's row chunk of the operand.
        mesh: the device mesh.
        data: one payload per position, each on its position's device (any
            value, None for one, at another process's positions); or, with
            ``data_specs``, the JAX package's payload pytree.
        data_specs: None, or the partition specs of ``data`` (the module's
            note): rows cut over the named axes, the rest replicated.
        mode: "row" or "column".
        axis: mesh axis name (or the tuple of all names of a 2-D mesh).
        padded_shape: physical (padded) shape if the sharded dim was padded.
        gather_idx: logical→physical index map along the sharded dim for
            ragged chunks whose padding is interleaved; ``None`` means
            padding, if any, sits at the physical end.
    """

    def __init__(
        self,
        shape: Tuple[int, int],
        matvec: Callable,
        rmatvec: Callable,
        mesh: Mesh,
        data: Sequence[Any],
        data_specs: Any = None,
        mode: str = "row",
        axis="i",
        dtype: torch.dtype = torch.float32,
        padded_shape: Optional[Tuple[int, int]] = None,
        scale=1.0,
        gather_idx: Optional[torch.Tensor] = None,
    ):
        _check_axis(mesh, axis)
        if data_specs is not None:
            data = _place(data, data_specs, mesh)
        if len(data) != mesh.size:
            raise ValueError(f"one payload per position ({mesh.size}), got {len(data)}")
        super().__init__(
            shape, matvec, rmatvec, matmat=matvec, rmatmat=rmatvec,
            dtype=dtype, device=mesh.home, scale=scale,
        )
        self.mesh = mesh
        self.axis = axis
        self.mode = _DistributionMode._from_str(mode, "mode")
        self._data = list(data)
        self.data_specs = data_specs
        self.padded_shape = tuple(padded_shape or shape)
        self.gather_idx = gather_idx

    # -- helpers -------------------------------------------------------------
    def _pad_operand(self, x, target: int):
        if x.shape[0] == target:
            return x
        if self.gather_idx is not None:
            # Ragged chunks: real entries sit at gather_idx inside the padded
            # layout; scatter them there and leave zeros elsewhere.
            z = x.new_zeros((target,) + tuple(x.shape[1:]))
            z[self.gather_idx] = x
            return z
        return pad_to_multiple(x, target)[0]

    def _split(self, x) -> list:
        """A padded operand cut into the positions' chunks, each of this
        process's moved to its position's device."""
        chunks = x.chunk(self.mesh.size, dim=0)
        return self.mesh.map(lambda p: move(chunks[p], self.mesh.devices[p]))

    def _gather(self, parts) -> torch.Tensor:
        """Per-position outputs concatenated on the home device."""
        return torch.cat(gather(parts, self.mesh), dim=0)

    def _collect_sharded(self, out, logical_len: int):
        """Drop padding from a sharded-dim output (slice or ragged gather)."""
        if self.gather_idx is not None:
            return out[self.gather_idx]
        return out[:logical_len]

    def _row_forward(self, local_fn, x):
        """Local compute on each position's shard, output sharded (concat)."""
        mesh = self.mesh
        out = self._gather(mesh.map(lambda p: local_fn(self._data[p], move(x, mesh.devices[p]))))
        if self.mode == _DistributionMode.ROW:
            return self._collect_sharded(out, self.shape[0])
        return out

    def _row_adjoint(self, local_fn, y, padded_len: int, out_len: int):
        """Operand sharded like the payload's rows, partials psum-combined."""
        chunks = self._split(self._pad_operand(y, padded_len))
        parts = self.mesh.map(lambda p: local_fn(self._data[p], chunks[p]))
        return psum(parts, self.mesh)[:out_len]

    # -- dispatch ------------------------------------------------------------
    def matvec(self, x):
        return self._apply_scale(self._matvec_impl(x))

    def matmat(self, X):
        return self._apply_scale(self._matvec_impl(X))

    def rmatvec(self, x):
        return self._apply_scale(self._rmatvec_impl(x))

    def rmatmat(self, X):
        return self._apply_scale(self._rmatvec_impl(X))

    def _matvec_impl(self, x):
        if self.mode == _DistributionMode.ROW:
            return self._row_forward(self._mv, x)
        # COLUMN: x is chunked along the operator's column dim; partials sum.
        return self._row_adjoint(self._mv, x, self.padded_shape[1], self.shape[0])

    def _rmatvec_impl(self, y):
        if self.mode == _DistributionMode.ROW:
            return self._row_adjoint(self._rmv, y, self.padded_shape[0], self.shape[1])
        out = self._row_forward(self._rmv, y)
        return self._collect_sharded(out, self.shape[1])

    @property
    def T(self) -> "ShardedLinOp":
        """Transpose: flips the distribution mode (metadata only)."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._shape = (self._shape[1], self._shape[0])
        new.padded_shape = (self.padded_shape[1], self.padded_shape[0])
        new._mv, new._rmv = self._rmv, self._mv
        new._mm, new._rmm = self._rmm, self._mm
        new.mode = (
            _DistributionMode.COLUMN
            if self.mode == _DistributionMode.ROW
            else _DistributionMode.ROW
        )
        return new

    def shutdown(self):
        """No-op (API parity: the reference tears down worker processes)."""

    @classmethod
    def from_local_ops(cls, ops, mesh: Mesh, mode: str = "row", axis="i") -> "ShardedLinOp":
        """Build a distributed operator from per-position local operators.

        Reference-style constructor (``DistributedLinOp(A=[ops...], ...)``):
        one operator per position, each on its position's device, stacked
        along the sharded dim (rows in ``"row"`` mode, columns in
        ``"column"``). Ragged chunks are accepted, as the JAX package accepts
        them: each position's chunk is padded to the largest in the physical
        layout, and operands and outputs go through ``gather_idx``, so
        results match the unpadded concatenation exactly. A local operator
        applies to its own rows only (the padding never reaches it). On a
        mesh that spans processes, ``ops`` holds this process's operators
        (None at the others' positions); their shapes are gathered.
        """
        ndev = axis_size(mesh, axis)
        if len(ops) != ndev:
            raise ValueError(f"need one local op per device ({ndev}), got {len(ops)}")
        shard_dim = 0 if mode == "row" else 1
        other_dim = 1 - shard_dim
        sizes = mesh.map(lambda p: torch.tensor(ops[p].shape, device=mesh.home))
        shapes = [tuple(t.tolist()) for t in gather(sizes, mesh)]
        other_sizes = {s[other_dim] for s in shapes}
        if len(other_sizes) != 1:
            raise ValueError(
                "local ops must agree along the non-sharded dim; "
                f"got sizes {sorted(other_sizes)}"
            )
        loc_sizes = [s[shard_dim] for s in shapes]
        loc_max = max(loc_sizes)
        row = mode == "row"

        # In the physical layout each chunk has loc_max entries: the output
        # along the sharded dim is padded, the operand along it sliced.
        def mv(d, x):
            op, sz = d
            return _pad_rows(_apply(op, x, False), loc_max) if row else _apply(op, x[:sz], False)

        def rmv(d, y):
            op, sz = d
            if not op._is_two_sided:
                raise TypeError("local ops have no rmatvec")
            return _apply(op, y[:sz], True) if row else _pad_rows(_apply(op, y, True), loc_max)

        n_logical = sum(loc_sizes)
        other = shapes[0][other_dim]
        if row:
            shape, padded_shape = (n_logical, other), (loc_max * ndev, other)
        else:
            shape, padded_shape = (other, n_logical), (other, loc_max * ndev)
        gather_idx = None
        if len(set(loc_sizes)) != 1:
            gather_idx = torch.cat([
                dev * loc_max + torch.arange(sz, device=mesh.home)
                for dev, sz in enumerate(loc_sizes)
            ])
        return cls(
            shape, mv, rmv, mesh, mesh.map(lambda p: (ops[p], loc_sizes[p])), mode=mode,
            axis=axis, dtype=ops[mesh.local_positions[0]].dtype, padded_shape=padded_shape,
            gather_idx=gather_idx,
        )

    @classmethod
    def from_dense(cls, M: torch.Tensor, mesh: Mesh, mode: str = "row", axis="i") -> "ShardedLinOp":
        """Shard a dense matrix over the mesh as a matrix-free operator: rows
        (``"row"``) or columns (``"column"``) zero-padded to a multiple of
        the mesh size and cut into equal chunks."""
        ndev = axis_size(mesh, axis)
        shard_dim = 0 if mode == "row" else 1
        Mp, _ = pad_to_multiple(M, ndev, axis=shard_dim)
        chunks = Mp.chunk(ndev, dim=shard_dim)
        data = mesh.map(lambda p: move(chunks[p], mesh.devices[p]))

        def mv(d, x):
            return d @ x

        def rmv(d, y):
            return d.T @ y

        padded_shape = (Mp.shape[0], M.shape[1]) if mode == "row" else (M.shape[0], Mp.shape[1])
        return cls(
            tuple(M.shape), mv, rmv, mesh, data, mode=mode, axis=axis,
            dtype=M.dtype, padded_shape=padded_shape,
        )


# Reference-familiar aliases (the reference distinguishes one-sided,
# two-sided, and symmetric distributed operators; sharding metadata makes the
# distinction vestigial here).
DistributedLinOp = ShardedLinOp
DistributedTwoSidedLinOp = ShardedLinOp


class DistributedSymmetricLinOp(ShardedLinOp):
    """Square symmetric sharded operator; ``.T`` returns self."""

    @property
    def T(self):
        return self
