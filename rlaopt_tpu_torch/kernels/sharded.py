"""Mesh-sharded kernel Gram operators.

Port of ``rlaopt_tpu/kernels/sharded.py``. A1 is row-sharded over the mesh
positions (zero-padded to a multiple of the mesh size); A2 is kept
row-sharded too (for the column-distributed row oracle and the ring) and,
only in ``memory_mode="replicated"`` with ``use_full_kernel=True``, whole at
every position. Positions are those of :class:`~rlaopt_tpu_torch.parallel.
Mesh`; payloads are per-position lists and the collectives are
:func:`~rlaopt_tpu_torch.parallel.psum` (in position order) and
:func:`~rlaopt_tpu_torch.parallel.ppermute` (a rotation of the list).

* ``"replicated"``: ``matvec`` streams each position's row slab
  k(X1_p, A2) @ v (no collective, the output stays sharded); ``rmatvec`` is
  one psum.
* ``"ring"``: nothing is replicated. The (A2 shard, operand shard) pairs
  rotate around the ring while each position accumulates its output rows;
  on a 2-D mesh the fast (last) axis rotates every step and the slow one
  once per inner cycle.
* The symmetric half-ring: one data set (``A1 is A2``, object identity) in
  ring mode on a 1-D mesh of P ≥ 2 positions visits each unordered shard
  pair {p, q} once: one kernel evaluation of K_pq serves K_pq V_q → out_p
  and K_pqᵀ V_p → out_q (:func:`~rlaopt_tpu_torch.ops.kernel_dispatch.
  kernel_pair`: K4, K4b or K6 on a card for k ≤ 16), the diagonal block runs
  the triangle kernel, and one rotation by ns − 1 hops brings every mirror
  accumulator home. For even P the antipodal step would cover its pairs
  twice, and only the positions p < P/2 take it: where the JAX package
  multiplies the other half's operands by zero, the port skips their
  launches (the sum is the same; the launch counts show it).
* ``row_oracle`` is column-distributed (one psum per apply), ``blk_oracle``
  row-distributed over the gathered block.
* ``matmat_compensated`` TwoSum-adds the per-visit partials of the ring;
  ``matmat_f64`` (and its ``(hi, lo)`` form ``matmat_value64``) runs the
  float64 kernels K7 (a position's own shard of one data set) and K8 over
  the same ring, with the points where they are: the JAX package gathers
  them to the host there (ROADMAP Queue 3).

Padding is not neutral for a kernel (k(x, 0) ≠ 0): a padded point's kernel
values with real points are not zero. Every schedule relies on the
OPERAND's padded rows being zero, and slices the padded output rows away;
the mirror accumulators' padded rows hold values and are dropped with them.

A bf16 ``compute_dtype`` keeps the tier parts of each shard (and of the
replicated A2) beside its points, made once when the operator is built, as
:class:`~rlaopt_tpu_torch.kernels.linop.KernelLinOp` does.
"""

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from .configs import KernelConfig, _is_kernel_config
from .functions import scale_inputs
from ..linops.sharded import ShardedLinOp, _axes
from ..ops.kernel_dispatch import (
    check_impl,
    kernel_matmat,
    kernel_matmat_compensated,
    kernel_matmat_f64,
    kernel_matmat_tier,
    kernel_pair,
    kernel_pair_tier,
)
from ..ops.kernel_plain import _two_sum
from ..ops.kernel_tiers import TierOperand, normalize_compute_dtype, tier_operand
from ..parallel.distributed import axis_size
from ..parallel.mesh import make_mesh, move, pad_to_multiple, ppermute, psum
from ..utils.checkers import _is_tensor


__all__ = ["ShardedKernelLinOp"]


@dataclass(frozen=True)
class _Points:
    """A block of points and, on a bf16 tier, their parts."""

    X: torch.Tensor
    T: Optional[TierOperand] = None

    def rows(self, idx) -> "_Points":
        return _Points(self.X[idx], None if self.T is None else self.T.rows(idx))

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def _map_rows(fn, *blocks: _Points) -> _Points:
    """``fn`` applied field by field (tier parts included) to row blocks of
    one layout."""

    def one(*ts):
        if ts[0] is None:
            return None
        if isinstance(ts[0], TierOperand):
            return TierOperand(*(one(*parts) for parts in zip(*(
                (t.hi, t.lo, t.sq) for t in ts))))
        return fn(*ts)

    return _Points(*(one(*fs) for fs in zip(*(b.tensors() for b in blocks))))


class ShardedKernelLinOp(ShardedLinOp):
    """Row-sharded Gram operator K[i,j] = c·k(A1[i], A2[j]) over a mesh."""

    def __init__(
        self,
        A1: torch.Tensor,
        A2: torch.Tensor,
        kernel_config: KernelConfig,
        kind: str,
        mesh=None,
        axis="i",
        impl: str = "auto",
        use_full_kernel: bool = True,
        memory_mode: str = "replicated",
        compute_dtype=None,
    ):
        """``memory_mode``: ``"replicated"`` (A2 also kept whole at every
        position) or ``"ring"`` (nothing replicated). ``mesh`` defaults to
        :func:`~rlaopt_tpu_torch.parallel.make_mesh` over every CUDA
        device. ``impl``: as :class:`~rlaopt_tpu_torch.kernels.linop.
        KernelLinOp`'s, for every local product."""
        self._check_inputs(A1, A2, kernel_config)
        self.impl = check_impl(impl)
        if memory_mode not in ("replicated", "ring"):
            raise ValueError(f"unknown memory_mode {memory_mode!r}")
        if mesh is None:
            if not isinstance(axis, str):
                raise ValueError(
                    "a multi-axis `axis` tuple requires an explicit mesh "
                    "(see rlaopt_tpu_torch.parallel.make_mesh_2d)"
                )
            mesh = make_mesh(axis=axis)
        ndev = axis_size(mesh, axis)
        compute_dtype = normalize_compute_dtype(compute_dtype)
        self.kind = kind
        self.compute_dtype = compute_dtype
        self._kernel_config = kernel_config
        self.use_full_kernel = use_full_kernel
        self.memory_mode = memory_mode
        self._c = float(kernel_config.const_scaling)
        # One data set on both sides (object identity): the triangle kernel
        # on own shards, and in ring mode on a 1-D mesh the half-ring.
        symmetric = A1 is A2
        self._symmetric = symmetric
        tier = compute_dtype is not None and kind != "laplace" and A1.dtype == torch.float32

        n, d = A1.shape
        m = A2.shape[0]
        home = mesh.home

        def points(A) -> _Points:
            A = move(A, home)
            T = None
            if tier:
                ls = kernel_config.lengthscale_tensor(A.dtype, home)
                T = tier_operand(scale_inputs(A, ls), compute_dtype)
            return _Points(A, T)

        def shards(A):
            """Rows of A zero-padded to a multiple of the mesh size, cut into
            equal blocks (with their tier parts), each on its position."""
            Ap = points(pad_to_multiple(move(A, home), ndev)[0])
            loc = Ap.X.shape[0] // ndev
            return [
                move(Ap.rows(slice(p * loc, (p + 1) * loc)), dev)
                for p, dev in enumerate(mesh.devices)
            ], Ap.X.shape[0]

        X1, n_pad = shards(A1)
        if symmetric:
            X2s, m_pad = X1, n_pad  # one data set: share the shards
        else:
            X2s, m_pad = shards(A2)
        X2r = None
        if use_full_kernel and memory_mode == "replicated":
            X2r = points(A2)
        data = []
        for p, dev in enumerate(mesh.devices):
            entry = {
                "X1": X1[p],
                "X2s": X2s[p],
                "ls": kernel_config.lengthscale_tensor(A1.dtype, dev),
                # The compensated and float64 routes divide by the
                # lengthscale in float64.
                "ls64": kernel_config.lengthscale_tensor(torch.float64, dev),
            }
            if X2r is not None:
                entry["X2r"] = move(X2r, dev)
            data.append(entry)

        axes = _axes(axis)
        sym_ring = memory_mode == "ring" and symmetric and len(axes) == 1 and ndev > 1
        if sym_ring:
            mv = rmv = self._half_ring  # square symmetric Gram: Kᵀ = K
        elif memory_mode == "ring":
            mv, rmv = self._ring_forward, self._ring_adjoint
        else:

            def mv(dd, v):
                # local row slab: k(X1_loc, A2) @ v — no collective needed
                return self._gram(dd["X1"], dd["X2r"], v, dd["ls"])

            def rmv(dd, y_loc):
                # partial column result: k(A2, X1_loc) @ y_loc (psum-combined)
                return self._gram(dd["X2r"], dd["X1"], y_loc, dd["ls"])

        super().__init__(
            shape=(n, m),
            matvec=mv,
            rmatvec=rmv,
            mesh=mesh,
            data=data,
            mode="row",
            axis=axis,
            dtype=A1.dtype,
            padded_shape=(n_pad, m_pad),
        )
        self._m_padded = m_pad

    # -- properties ----------------------------------------------------------
    @property
    def A1(self) -> torch.Tensor:
        """The points of the rows, gathered on the first position's device."""
        return torch.cat([move(d["X1"].X, self.mesh.home) for d in self._data])[: self.shape[0]]

    @property
    def A2(self) -> torch.Tensor:
        if self._symmetric:
            return self.A1
        return torch.cat([move(d["X2s"].X, self.mesh.home) for d in self._data])[: self.shape[1]]

    @property
    def kernel_config(self) -> KernelConfig:
        return self._kernel_config

    @property
    def lengthscale64(self) -> torch.Tensor:
        """The lengthscale in float64 on the first position's device."""
        return self._data[0]["ls64"]

    @property
    def const_scaling(self) -> float:
        """c of ``c·k``: the config's scale times the operator's (``op * c``)."""
        return self._c * float(self._scale)

    def _check_inputs(self, A1, A2, kernel_config):
        _is_tensor(A1, "A1")
        _is_tensor(A2, "A2")
        if A1.ndim != 2 or A2.ndim != 2:
            raise ValueError("A1 and A2 must be 2D tensors.")
        if A1.dtype != A2.dtype:
            raise ValueError("A1 and A2 must have the same dtype.")
        _is_kernel_config(kernel_config, "kernel_config")

    def _require_full(self):
        if not self.use_full_kernel:
            raise RuntimeError(
                "operator built with use_full_kernel=False exposes only "
                "row_oracle/blk_oracle"
            )

    # -- the local products --------------------------------------------------
    def _gram(self, L: _Points, R: _Points, V, ls, symmetric: bool = False):
        """``c·k(L, R) @ V`` on the operator's tier."""
        if L.T is not None:
            return kernel_matmat_tier(self.kind, L.T, R.T, V, self._c, symmetric, self.impl)
        return kernel_matmat(self.kind, L.X, R.X, V, ls, self._c, symmetric=symmetric,
                             impl=self.impl)

    def _pair(self, L: _Points, R: _Points, V2, V1, ls):
        """``(c·K @ V2, c·Kᵀ @ V1)`` with K = k(L, R) on the operator's tier."""
        if L.T is not None:
            return kernel_pair_tier(self.kind, L.T, R.T, V2, V1, self._c, self.impl)
        return kernel_pair(self.kind, L.X, R.X, V2, V1, ls, self._c, self.impl)

    # -- ring schedules ------------------------------------------------------
    def _sweep(self, rotating, stationary, visit):
        """Visit every shard position once: ``visit(p, moving, staying) ->
        (moving, staying)`` at each position before each rotation of the
        ``rotating`` list (hierarchical on a 2-D mesh: the fast axis every
        step, the slow axis once per inner cycle). Returns both lists, the
        rotating one back home."""
        axes, mesh = _axes(self.axis), self.mesh
        fast = axes[-1]

        def inner(rot, sta):
            for _ in range(mesh.shape[fast]):
                for p in range(mesh.size):
                    rot[p], sta[p] = visit(p, rot[p], sta[p])
                rot = ppermute(rot, mesh, fast)
            return rot, sta

        rot, sta = list(rotating), list(stationary)
        if len(axes) == 1:
            return inner(rot, sta)
        for _ in range(mesh.shape[axes[0]]):
            rot, sta = inner(rot, sta)
            rot = ppermute(rot, mesh, axes[0])
        return rot, sta

    def _ring_forward(self, data, chunks):
        """The general ring's ``K @ v``: (A2 shard, operand shard) pairs
        rotate; each position accumulates its output rows in place."""

        def visit(p, moving, acc):
            x2s, vs = moving
            part = self._gram(data[p]["X1"], x2s, vs, data[p]["ls"])
            return moving, part if acc is None else acc + part

        _, acc = self._sweep(
            [(d["X2s"], c) for d, c in zip(data, chunks)], [None] * len(data), visit
        )
        return acc

    def _ring_adjoint(self, data, chunks):
        """The general ring's ``Kᵀ @ y``: (A2 shard, its output accumulator)
        pairs rotate; each position adds k(A2 shard, X1_p) @ y_p to the
        accumulator visiting it, which is home again after the sweep."""

        def visit(p, moving, staying):
            x2s, acc = moving
            part = self._gram(x2s, data[p]["X1"], chunks[p], data[p]["ls"])
            return (x2s, part if acc is None else acc + part), staying

        rot, _ = self._sweep([(d["X2s"], None) for d in data], [None] * len(data), visit)
        return [acc for _, acc in rot]

    def _half_ring(self, data, chunks):
        """The symmetric half-ring sweep: ~half the kernel evaluations.

        Position p starts with its own (shard, operand, zero mirror
        accumulator) as the rotating carry; after s forward rotations it
        holds shard q = p − s and computes both products of the pair
        {p, q} from one evaluation, adding the mirror product to the carried
        accumulator of shard q. Steps s = 1 .. ns − 1 visit each unordered
        pair once (for even P the antipodal step is taken by p < P/2 only);
        then one rotation by −(ns − 1) delivers every mirror accumulator
        home. The diagonal block runs the triangle kernel locally.
        """
        mesh, ax = self.mesh, _axes(self.axis)[0]
        P = mesh.size
        ns = P // 2 + 1 if P % 2 == 0 else (P + 1) // 2
        squeeze = chunks[0].ndim == 1
        V = [c[:, None] if squeeze else c for c in chunks]
        out = [
            self._gram(d["X1"], d["X1"], v, d["ls"], symmetric=True)
            for d, v in zip(data, V)
        ]
        carry = [(d["X1"], v, torch.zeros_like(v)) for d, v in zip(data, V)]
        for s in range(1, ns):
            carry = ppermute(carry, mesh, ax)
            for p in range(P):
                if P % 2 == 0 and not (s < ns - 1 or p < P // 2):
                    continue  # the antipodal pair is taken from its other side
                xq, vq, mir = carry[p]
                o_p, o_q = self._pair(data[p]["X1"], xq, vq, V[p], data[p]["ls"])
                out[p] = out[p] + o_p
                carry[p] = (xq, vq, mir + o_q)
        # the mirror of shard q sits ns - 1 hops ahead: one rotation home
        mirrors = ppermute([c[2] for c in carry], mesh, ax, -(ns - 1))
        out = [o + mr for o, mr in zip(out, mirrors)]
        return [o[:, 0] for o in out] if squeeze else out

    # Ring mode: both operand and output are sharded over the mesh.
    def _ring_apply(self, fn, x, padded_len: int, out_len: int):
        chunks = self._split(self._pad_operand(x, padded_len))
        return self._gather(fn(self._data, chunks))[:out_len]

    def _matvec_impl(self, x):
        if self.memory_mode != "ring":
            return super()._matvec_impl(x)
        return self._ring_apply(self._mv, x, self.padded_shape[1], self.shape[0])

    def _rmatvec_impl(self, y):
        if self.memory_mode != "ring":
            return super()._rmatvec_impl(y)
        return self._ring_apply(self._rmv, y, self.padded_shape[0], self.shape[1])

    def matvec(self, x):
        self._require_full()
        return super().matvec(x)

    def matmat(self, X):
        self._require_full()
        return super().matmat(X)

    def rmatvec(self, x):
        self._require_full()
        return super().rmatvec(x)

    def rmatmat(self, X):
        self._require_full()
        return super().rmatmat(X)

    # -- certified-residual routes -------------------------------------------
    def matmat_compensated(self, V: torch.Tensor):
        """``K @ V`` as a compensated ``(hi, lo)`` pair across the mesh (add
        ``lo`` last): each position's row slab through the compensated
        kernel (K1c, K3c on a card); in ring mode the per-visit partials are
        TwoSum-added, so the cross-shard sums do not bring back the float32
        floor the pair exists to beat."""
        self._require_full()
        squeeze = V.ndim == 1
        Vm = V[:, None] if squeeze else V
        kind, c = self.kind, self._c
        if self.memory_mode == "replicated":
            parts = [
                kernel_matmat_compensated(kind, d["X1"].X, d["X2r"].X, move(Vm, dev),
                                          d["ls64"], c, impl=self.impl)
                for d, dev in zip(self._data, self.mesh.devices)
            ]
        else:
            chunks = self._split(self._pad_operand(Vm, self.padded_shape[1]))

            def visit(p, moving, acc):
                x2s, vs = moving
                h, lo = kernel_matmat_compensated(
                    kind, self._data[p]["X1"].X, x2s.X, vs, self._data[p]["ls64"], c,
                    impl=self.impl,
                )
                if acc is None:
                    return moving, (h, lo)
                ah, al = acc
                s, e = _two_sum(ah, h)
                return moving, (s, al + (e + lo))

            _, parts = self._sweep(
                [(d["X2s"], ch) for d, ch in zip(self._data, chunks)],
                [None] * len(chunks), visit,
            )
        n = self.shape[0]
        hi = self._gather([h for h, _ in parts])[:n]
        lo = self._gather([lo for _, lo in parts])[:n]
        if squeeze:
            hi, lo = hi[:, 0], lo[:, 0]
        return self._apply_scale(hi), self._apply_scale(lo)

    def matmat_f64(self, V: torch.Tensor) -> torch.Tensor:
        """``K @ V`` with float64 kernel values and sums (float64 out, on the
        first position's device), over the ring of the A2 shards in either
        memory mode: K7 where a position meets its own shard of one data set,
        K8 elsewhere (the plain float64 version on the CPU). The points stay
        on their positions."""
        self._require_full()
        squeeze = V.ndim == 1
        V64 = move(V[:, None] if squeeze else V, self.mesh.home).double()
        chunks = self._split(self._pad_operand(V64, self.padded_shape[1]))

        def visit(p, moving, acc):
            x2s, vs, q = moving
            d = self._data[p]
            part = kernel_matmat_f64(
                self.kind, d["X1"].X, x2s.X, vs, d["ls64"], self._c,
                symmetric=self._symmetric and q == p,
            )
            return moving, part if acc is None else acc + part

        _, acc = self._sweep(
            [(d["X2s"], ch, q) for q, (d, ch) in enumerate(zip(self._data, chunks))],
            [None] * len(chunks), visit,
        )
        out = self._gather(acc)[: self.shape[0]] * float(self._scale)
        return out[:, 0] if squeeze else out

    def matmat_value64(self, V: torch.Tensor):
        """:meth:`matmat_f64` as the JAX package's ``(hi, lo)`` float32 pair
        (add ``lo`` last)."""
        out = self.matmat_f64(V)
        hi = out.float()
        return hi, (out - hi.double()).float()

    def row_matmat_f64(self, idx: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        """``K[idx, :] @ W`` in float64 (K8 at each position on its A2
        shard, one psum), on the first position's device."""
        xr = self._gather_rows("X1", idx).X
        W64 = move(W[:, None] if W.ndim == 1 else W, self.mesh.home).double()
        chunks = self._split(self._pad_operand(W64, self.padded_shape[1]))
        parts = [
            kernel_matmat_f64(self.kind, move(xr, dev), d["X2s"].X, w, d["ls64"], self._c)
            for d, dev, w in zip(self._data, self.mesh.devices, chunks)
        ]
        out = psum(parts, self.mesh.home) * float(self._scale)
        return out[:, 0] if W.ndim == 1 else out

    # -- oracles -------------------------------------------------------------
    def _gather_rows(self, key: str, blk) -> _Points:
        """Logical rows ``blk`` of the sharded points ``key`` ("X1" or
        "X2s"), with their tier parts, on the first position's device: each
        position's shard is read at the rows it owns (a small cross-shard
        gather)."""
        home = self.mesh.home
        blk = torch.as_tensor(blk, device=home, dtype=torch.long)
        loc = self._data[0][key].X.shape[0]
        owner, local = blk // loc, blk % loc
        out = None
        for p, (d, dev) in enumerate(zip(self._data, self.mesh.devices)):
            rows = move(d[key].rows(move(local, dev)), home)
            if out is None:
                out = rows
            else:
                keep = owner == p
                out = _map_rows(
                    lambda a, b: torch.where(keep.view(-1, *[1] * (a.ndim - 1)), a, b),
                    rows, out,
                )
        return out

    def row_oracle(self, blk) -> ShardedLinOp:
        """K[blk, :] as a column-distributed operator (one psum per apply)."""
        xb = self._gather_rows("X1", blk)
        b = xb.X.shape[0]
        data = [
            {"Xb": move(xb, dev), "X2s": d["X2s"], "ls": d["ls"]}
            for d, dev in zip(self._data, self.mesh.devices)
        ]

        def mv(dd, w_loc):
            return self._gram(dd["Xb"], dd["X2s"], w_loc, dd["ls"])

        def rmv(dd, y):
            return self._gram(dd["X2s"], dd["Xb"], y, dd["ls"])

        return ShardedLinOp(
            shape=(b, self.shape[1]), matvec=mv, rmatvec=rmv, mesh=self.mesh,
            data=data, mode="column", axis=self.axis, dtype=self.dtype,
            padded_shape=(b, self._m_padded), scale=self._scale,
        )

    def blk_oracle(self, blk) -> ShardedLinOp:
        """K[blk, blk] as a row-distributed operator over the mesh: the block
        of points is gathered (small), padded to a multiple of the mesh size
        and row-sharded; the other side is kept whole at every position."""
        x1b = self._gather_rows("X1", blk)
        x2b = self._gather_rows("X2s", blk)
        b = x1b.X.shape[0]
        ndev = self.mesh.size
        x1b_p = _map_rows(lambda t: pad_to_multiple(t, ndev)[0], x1b)
        b_pad = x1b_p.X.shape[0]
        loc = b_pad // ndev
        data = [
            {"Xb_s": move(x1b_p.rows(slice(p * loc, (p + 1) * loc)), dev),
             "Xb": move(x2b, dev), "ls": d["ls"]}
            for p, (d, dev) in enumerate(zip(self._data, self.mesh.devices))
        ]

        def mv(dd, v):
            # local rows of K[blk, blk] @ v
            return self._gram(dd["Xb_s"], dd["Xb"], v, dd["ls"])

        def rmv(dd, y_loc):
            return self._gram(dd["Xb"], dd["Xb_s"], y_loc, dd["ls"])

        return ShardedLinOp(
            shape=(b, b), matvec=mv, rmatvec=rmv, mesh=self.mesh, data=data,
            mode="row", axis=self.axis, dtype=self.dtype, padded_shape=(b_pad, b),
            scale=self._scale,
        )
