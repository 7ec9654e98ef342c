"""Device meshes and the collectives of the sharded operators.

Port of ``rlaopt_tpu/parallel/mesh.py``. The JAX package runs one program
over a ``jax.sharding.Mesh`` with ``shard_map``, ``psum`` and ``ppermute``;
the port keeps that model:

* a :class:`Mesh` is an ordered grid of positions, each a ``torch.device``,
  with axis names. A device may stand at several positions: P entries of
  ``cuda:0`` are P positions on one card, P entries of ``cpu`` are what the
  tests use;
* a sharded payload is a list of per-position entries, in the mesh's
  row-major position order;
* :func:`psum` adds the positions' partials in position order (so the sum
  does not change from run to run), :func:`ppermute` rotates the list along
  an axis, moving each entry to its new position's device with
  ``non_blocking=True`` (nothing moves between positions of one device),
  :func:`gather` brings every position's entry to :attr:`Mesh.home`.

A mesh built after :func:`~rlaopt_tpu_torch.parallel.initialize_multihost`
spans processes: every process runs the same program on the same
replicated state, and owns the positions of its own row (``owners``). A
per-position list holds ``None`` at the positions of other processes, and
only the collectives cross processes, through the mesh's
:class:`Transport`: :func:`gather` and :func:`psum` gather every position's
entry (an all-gather of equal-shape entries) and add in position order, so
every process holds the bits one process would; :func:`ppermute` sends and
receives the entries that cross a process. A mesh built without ``owners``
is one process's: every position is local and nothing leaves the process.

Everything runs on the current stream; there is no thread and no fallback.
"""

import dataclasses
import time
from typing import Optional, Sequence

import torch


__all__ = [
    "Mesh",
    "Transport",
    "gather",
    "make_mesh",
    "move",
    "pad_to_multiple",
    "ppermute",
    "psum",
    "replicate",
    "shard_rows",
]


class Transport:
    """The cross-process collectives of a mesh, over one process group.

    ``name`` is ``"nccl"`` (each process holds cards of its own: CUDA
    tensors go to NCCL as they are) or ``"gloo"`` (processes that share a
    card, or hold CPU positions: a CUDA tensor is copied through pinned
    host memory, since gloo has no CUDA all-gather or send/receive).
    Entries cross as bytes, one buffer per entry. ``seconds``, ``calls``
    and ``bytes`` count the host's time inside the collectives (the
    staging copies included), their number and the bytes this process
    contributed.
    """

    def __init__(self, name: str, rank: int, world: int, group=None):
        if name not in ("nccl", "gloo"):
            raise ValueError(f"unknown transport {name!r}")
        self.name, self.rank, self.world, self.group = name, rank, world, group
        self.seconds = 0.0
        self.calls = 0
        self.bytes = 0

    def __repr__(self):
        return f"Transport({self.name!r}, rank={self.rank}, world={self.world})"

    def _staged(self, t: torch.Tensor) -> bool:
        return self.name == "gloo" and t.is_cuda

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend reads it: a pinned host copy for gloo."""
        if not self._staged(t):
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _landing(self, t: torch.Tensor) -> torch.Tensor:
        """Where the backend writes ``t``'s bytes: ``t``, or a pinned host
        buffer for gloo (copied into ``t`` by :meth:`_land`)."""
        if not self._staged(t):
            return t
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

    @staticmethod
    def _land(t: torch.Tensor, landing: torch.Tensor):
        if landing is not t:
            t.copy_(landing, non_blocking=True)

    def all_gather(self, t: torch.Tensor) -> list:
        """Every process's ``t`` (equal shapes), by rank, on ``t``'s device."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.world)]
        landings = [self._landing(o) for o in out]
        dist.all_gather(landings, self._wire(t), group=self.group)
        for o, landing in zip(out, landings):
            self._land(o, landing)
        self._count(t0, t)
        return out

    def exchange(self, sends, recvs) -> None:
        """Point to point: ``sends`` and ``recvs`` of ``(peer, tag,
        tensor)``; each received tensor is written in place."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        ops = [dist.P2POp(dist.isend, self._wire(t.contiguous()), peer, self.group, tag)
               for peer, tag, t in sends]
        landings = [self._landing(t) for _, _, t in recvs]
        ops += [dist.P2POp(dist.irecv, landing, peer, self.group, tag)
                for (peer, tag, _), landing in zip(recvs, landings)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for (_, _, t), landing in zip(recvs, landings):
            self._land(t, landing)
        self._count(t0, *(t for _, _, t in sends))

    def _count(self, t0: float, *sent: torch.Tensor):
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes += sum(t.numel() * t.element_size() for t in sent)


class Mesh:
    """An ordered grid of positions over ``torch.device`` s.

    Args:
        devices: the positions' devices, row-major over the grid. On a mesh
            that spans processes, a position of another process names the
            device of this process that takes its entries' place (the one
            of the same column).
        axis_names: one name per grid axis.
        grid: the grid's shape (default: one axis over all devices).
        owners: the rank of the process that owns each position (None:
            every position is this process's). Every process owns as many
            positions.
        transport: the :class:`Transport` of a mesh with ``owners``.
    """

    def __init__(self, devices: Sequence, axis_names, grid: Optional[Sequence[int]] = None,
                 owners: Optional[Sequence[int]] = None,
                 transport: Optional[Transport] = None):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        grid = (len(self.devices),) if grid is None else tuple(int(g) for g in grid)
        if len(grid) != len(self.axis_names):
            raise ValueError(f"grid {grid} for axes {self.axis_names}")
        if _prod(grid) != len(self.devices) or not self.devices:
            raise ValueError(f"grid {grid} for {len(self.devices)} devices")
        self.grid = grid
        self.transport = None
        self.owners = None
        self.local_positions = tuple(range(len(self.devices)))
        if owners is not None:
            owners = tuple(int(o) for o in owners)
            if transport is None:
                raise ValueError("a mesh over processes needs their transport")
            if len(owners) != len(self.devices):
                raise ValueError(f"{len(owners)} owners for {len(self.devices)} positions")
            counts = [owners.count(r) for r in range(transport.world)]
            if sorted(set(owners)) != list(range(transport.world)) or len(set(counts)) != 1:
                raise ValueError(
                    f"owners {owners}: every one of the {transport.world} processes "
                    "owns as many positions"
                )
            self.owners, self.transport = owners, transport
            self.local_positions = tuple(p for p, r in enumerate(owners) if r == transport.rank)

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.grid))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """This process's first position's device, where unsharded results
        are put."""
        return self.devices[self.local_positions[0]]

    def is_local(self, p: int) -> bool:
        """Whether position ``p`` is this process's."""
        return self.owners is None or self.owners[p] == self.transport.rank

    def owned_by(self, rank: int) -> list:
        """The positions of process ``rank``, in order."""
        return [p for p, r in enumerate(self.owners) if r == rank]

    def map(self, fn) -> list:
        """``[fn(p) ...]`` over the positions: computed at this process's
        positions, None at the others'."""
        return [fn(p) if self.is_local(p) else None for p in range(self.size)]

    def __repr__(self):
        spans = "" if self.owners is None else f", owners={list(self.owners)}"
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]}{spans})"


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def make_mesh(
    n_devices: Optional[int] = None,
    axis: str = "i",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 1-D mesh over ``n_devices`` positions (default: all of ``devices``).

    ``devices`` defaults to every CUDA device, and raises without one; it
    may name one device more than once (``[torch.device("cuda", 0)] * 4`` is
    four positions of one card). After
    :func:`~rlaopt_tpu_torch.parallel.initialize_multihost`, the mesh spans
    every process's positions (``devices``: this process's, default those
    it joined with), process by process.
    """
    from .distributed import _multiprocess_mesh

    spanning = _multiprocess_mesh(devices, (axis,), (n_devices,))
    if spanning is not None:
        return spanning
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices=[...] "
                "(for example ['cpu'] * P) to build a mesh of other positions"
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} exist"
            )
        devices = devices[:n_devices]
    return Mesh(devices, (axis,))


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0):
    """Zero-pad ``x`` along ``axis`` to a multiple; returns (padded, orig_len)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    shape = list(x.shape)
    shape[axis] = target - n
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n


def move(obj, device: torch.device):
    """``obj`` on ``device``: tensors (``non_blocking``), and dataclasses
    (the tier parts), tuples, lists and dicts of them; None and other values
    as they are."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=True)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: move(getattr(obj, f.name), device) for f in dataclasses.fields(obj)
        })
    if isinstance(obj, tuple):
        return tuple(move(o, device) for o in obj)
    if isinstance(obj, list):
        return [move(o, device) for o in obj]
    if isinstance(obj, dict):
        return {key: move(o, device) for key, o in obj.items()}
    return obj


def shard_rows(x: torch.Tensor, mesh: Mesh, axis="i") -> list:
    """``x`` with its rows cut over the mesh axis ``axis`` (a name, or a
    tuple of names taken major to minor) and replicated over the others, as
    ``jax.device_put(x, NamedSharding(mesh, P(axis, None, ...)))``: one
    tensor per position, on its device (None at another process's). The
    rows must divide by the axis's size (pad first with
    :func:`pad_to_multiple`)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} is not an axis of {mesh}")
    blocks = _prod(mesh.shape[a] for a in axes)
    if x.shape[0] % blocks:
        raise ValueError(
            f"{x.shape[0]} rows do not divide over {blocks} positions of axis "
            f"{axis!r}; pad_to_multiple first"
        )
    chunks = x.chunk(blocks, dim=0)

    def block(p):
        b = 0
        for a in axes:
            i = mesh.axis_names.index(a)
            b = b * mesh.grid[i] + (p // _prod(mesh.grid[i + 1:])) % mesh.grid[i]
        return move(chunks[b], mesh.devices[p])

    return mesh.map(block)


def replicate(x, mesh: Mesh) -> list:
    """``x`` at every position (one tensor per device, shared by the
    positions of one device; None at another process's)."""
    return mesh.map(lambda p: move(x, mesh.devices[p]))


# -- entries as bytes ---------------------------------------------------------
def _leaves(obj) -> list:
    """The tensors of an entry, in a fixed order: tensors, and dataclasses,
    tuples, lists and dicts of them; None holds none. Anything else cannot
    cross a process."""
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj) for t in _leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _leaves(o)]
    if isinstance(obj, dict):
        return [t for key in obj for t in _leaves(obj[key])]
    raise TypeError(
        f"a {type(obj).__name__} cannot cross a process: an entry holds tensors, "
        "and dataclasses, tuples, lists and dicts of them"
    )


def _rebuild(template, leaves):
    """``template``'s structure with its tensors taken in order from the
    iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)
        })
    if isinstance(template, tuple):
        return tuple(_rebuild(o, leaves) for o in template)
    if isinstance(template, list):
        return [_rebuild(o, leaves) for o in template]
    return {key: _rebuild(template[key], leaves) for key in template}


# Each tensor's bytes start at a multiple of this, so that every slice of a
# buffer views as its dtype.
_ALIGN = 16


def _span(t: torch.Tensor) -> int:
    return -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN


def _pack(entry, device) -> torch.Tensor:
    """An entry's tensors as one byte buffer on ``device``."""
    leaves = _leaves(entry)
    buf = torch.zeros(sum(_span(t) for t in leaves), dtype=torch.uint8, device=device)
    at = 0
    for t in leaves:
        raw = t.to(device).contiguous().reshape(-1).view(torch.uint8)
        buf[at:at + raw.numel()] = raw
        at += _span(t)
    return buf


def _nbytes(entry) -> int:
    return sum(_span(t) for t in _leaves(entry))


def _unpack(buf: torch.Tensor, template, device):
    """The entry of ``template``'s structure, shapes and dtypes whose bytes
    are ``buf``, its tensors on ``device``."""
    out, at = [], 0
    for t in _leaves(template):
        nbytes = t.numel() * t.element_size()
        out.append(buf[at:at + nbytes].view(t.dtype).reshape(t.shape).to(device))
        at += _span(t)
    return _rebuild(template, iter(out))


# -- collectives --------------------------------------------------------------
def gather(parts: Sequence, mesh: Mesh) -> list:
    """Every position's entry on ``mesh.home``, on every process, in
    position order. Across processes the entries (equal structures and
    shapes) are all-gathered as bytes: every process receives the bits of
    each entry's owner."""
    home = mesh.home
    if mesh.transport is None:
        return [move(p, home) for p in parts]
    local = mesh.local_positions
    template = parts[local[0]]
    mine = torch.stack([_pack(parts[p], home) for p in local])
    out = [None] * mesh.size
    for rank, block in enumerate(mesh.transport.all_gather(mine)):
        for i, p in enumerate(mesh.owned_by(rank)):
            out[p] = _unpack(block[i], template, home)
    return out


def psum(parts: Sequence[torch.Tensor], where) -> torch.Tensor:
    """The positions' partials added in position order, on ``where``: a
    device (every partial at hand), or a :class:`Mesh` (its home; across
    processes every position's partial is gathered first, so every process
    adds the same partials in the same order)."""
    if isinstance(where, Mesh):
        parts, device = gather(parts, where), where.home
    else:
        device = where
    out = move(parts[0], device)
    for p in parts[1:]:
        out = out + move(p, device)
    return out


def _destination(mesh: Mesh, axis: str, shift: int):
    """``q(p)``: the position that the entry at ``p`` goes to when a list
    rotates by ``shift`` along ``axis``."""
    a = mesh.axis_names.index(axis)
    size = mesh.grid[a]
    stride = _prod(mesh.grid[a + 1:])

    def q(p):
        c = (p // stride) % size
        return p + (((c + shift) % size) - c) * stride

    return q


def ppermute(parts: list, mesh: Mesh, axis: str, shift: int = 1) -> list:
    """Rotate a per-position list by ``shift`` along mesh ``axis``: the
    entry of the position at coordinate c goes to coordinate c + shift (mod
    the axis size), the other coordinates kept; each moved entry goes to its
    new position's device. An entry that crosses a process is sent as
    bytes; its receiver reads its structure, shapes and dtypes from the
    entry it holds itself (every position's entry has the same)."""
    dest = _destination(mesh, axis, shift)
    out = [None] * len(parts)
    sends, recvs = [], []
    for p in range(mesh.size):
        q = dest(p)
        if mesh.is_local(p) and mesh.is_local(q):
            out[q] = move(parts[p], mesh.devices[q])
        elif mesh.is_local(p):
            sends.append((mesh.owners[q], q, _pack(parts[p], mesh.devices[p])))
        elif mesh.is_local(q):
            recvs.append((mesh.owners[p], q, parts[q]))
    if sends or recvs:
        bufs = [torch.empty(_nbytes(template), dtype=torch.uint8, device=mesh.devices[q])
                for _, q, template in recvs]
        mesh.transport.exchange(sends, [(peer, q, buf) for (peer, q, _), buf in zip(recvs, bufs)])
        for (_, q, template), buf in zip(recvs, bufs):
            out[q] = _unpack(buf, template, mesh.devices[q])
    return out
