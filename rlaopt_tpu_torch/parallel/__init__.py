"""Device meshes: ordered positions, each a ``torch.device``, with axis names.

Port of ``rlaopt_tpu/parallel``'s single-process half. The multi-process
runtime (``initialize_multihost``, ``run_multiprocess_dryrun`` and
``_multihost_dryrun.py``) is the one part of the JAX package not ported
yet (``ROADMAP.md``, Queue 1, item 16).
"""

from .distributed import axis_size, make_mesh_2d  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    move,
    pad_to_multiple,
    ppermute,
    psum,
    replicate,
    shard_rows,
)

__all__ = [
    "Mesh",
    "axis_size",
    "make_mesh",
    "make_mesh_2d",
    "move",
    "pad_to_multiple",
    "ppermute",
    "psum",
    "replicate",
    "shard_rows",
]
