"""Device meshes and the collectives of the sharded operators, in one process.

Port of ``rlaopt_tpu/parallel/mesh.py``. The JAX package runs one controller
over a ``jax.sharding.Mesh`` with ``shard_map``, ``psum`` and ``ppermute``;
the port keeps that model in one process:

* a :class:`Mesh` is an ordered grid of positions, each a ``torch.device``,
  with axis names. A device may stand at several positions: P entries of
  ``cuda:0`` are P positions on one card, P entries of ``cpu`` are what the
  tests use;
* a sharded payload is a list of per-position tensors, in the mesh's
  row-major position order;
* :func:`psum` adds the positions' partials in position order (so the sum
  does not change from run to run), :func:`ppermute` rotates the list along
  an axis, moving each tensor to its new position's device with
  ``non_blocking=True`` (nothing moves between positions of one device).

Everything runs on the current stream; there is no thread, no process and no
fallback.
"""

import dataclasses
from typing import Optional, Sequence

import torch


__all__ = [
    "Mesh",
    "make_mesh",
    "move",
    "pad_to_multiple",
    "ppermute",
    "psum",
    "replicate",
    "shard_rows",
]


class Mesh:
    """An ordered grid of positions over ``torch.device`` s.

    Args:
        devices: the positions' devices, row-major over the grid.
        axis_names: one name per grid axis.
        grid: the grid's shape (default: one axis over all devices).
    """

    def __init__(self, devices: Sequence, axis_names, grid: Optional[Sequence[int]] = None):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        grid = (len(self.devices),) if grid is None else tuple(int(g) for g in grid)
        if len(grid) != len(self.axis_names):
            raise ValueError(f"grid {grid} for axes {self.axis_names}")
        if _prod(grid) != len(self.devices) or not self.devices:
            raise ValueError(f"grid {grid} for {len(self.devices)} devices")
        self.grid = grid

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.grid))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """The first position's device, where unsharded results are put."""
        return self.devices[0]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


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
    four positions of one card).
    """
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


def shard_rows(x: torch.Tensor, mesh: Mesh) -> list:
    """``x`` cut into ``mesh.size`` equal row blocks, each on its position's
    device (pad first with :func:`pad_to_multiple` if the rows do not
    divide)."""
    if x.shape[0] % mesh.size:
        raise ValueError(
            f"{x.shape[0]} rows do not divide over {mesh.size} positions; "
            "pad_to_multiple first"
        )
    return [move(c, d) for c, d in zip(x.chunk(mesh.size, dim=0), mesh.devices)]


def replicate(x, mesh: Mesh) -> list:
    """``x`` at every position (one tensor per device, shared by the
    positions of one device)."""
    return [move(x, d) for d in mesh.devices]


def psum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The positions' partials added in position order, on ``device``."""
    out = move(parts[0], device)
    for p in parts[1:]:
        out = out + move(p, device)
    return out


def ppermute(parts: list, mesh: Mesh, axis: str, shift: int = 1) -> list:
    """Rotate a per-position list by ``shift`` along mesh ``axis``: the
    entry of the position at coordinate c goes to coordinate c + shift (mod
    the axis size), the other coordinates kept; each moved entry goes to its
    new position's device."""
    a = mesh.axis_names.index(axis)
    size = mesh.grid[a]
    stride = _prod(mesh.grid[a + 1:])
    out = [None] * len(parts)
    for p, entry in enumerate(parts):
        c = (p // stride) % size
        q = p + (((c + shift) % size) - c) * stride
        out[q] = move(entry, mesh.devices[q])
    return out
