"""The 2-D ``("dcn", "i")`` mesh, in one process.

Port of the single-process half of ``rlaopt_tpu/parallel/distributed.py``
(``make_mesh_2d``, ``axis_size``): the mesh whose fast axis rotates every
step of the hierarchical ring and whose slow axis once per inner cycle. The
multi-process runtime of that module (``initialize_multihost``,
``run_multiprocess_dryrun``, ``_multihost_dryrun.py``) is not ported yet.
"""

from typing import Optional, Sequence

import torch

from .mesh import Mesh


__all__ = ["make_mesh_2d", "axis_size"]


def make_mesh_2d(
    n_dcn: Optional[int] = None,
    n_ici: Optional[int] = None,
    dcn_axis: str = "dcn",
    ici_axis: str = "i",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 2-D ``(dcn_axis, ici_axis)`` mesh of ``n_dcn x n_ici`` positions.

    Defaults: one row (one process), all positions of ``devices`` (every
    CUDA device when None) in it. Extra devices are left out.
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_mesh_2d: no CUDA device is available; pass devices=[...]"
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    if n_dcn is None:
        n_dcn = 1
    if n_ici is None:
        n_ici = len(devices) // n_dcn
    if n_dcn * n_ici > len(devices):
        raise ValueError(
            f"mesh {n_dcn}x{n_ici} needs {n_dcn * n_ici} devices, "
            f"have {len(devices)}"
        )
    return Mesh(devices[: n_dcn * n_ici], (dcn_axis, ici_axis), (n_dcn, n_ici))


def axis_size(mesh: Mesh, axis) -> int:
    """Total position count along ``axis`` (a name or tuple of names)."""
    if isinstance(axis, (tuple, list)):
        size = 1
        for a in axis:
            size *= mesh.shape[a]
        return size
    return mesh.shape[axis]
