"""Device meshes and the multi-process runtime: ordered positions, each a
``torch.device``, with axis names, over one process or many.

Port of ``rlaopt_tpu/parallel``: :func:`initialize_multihost` joins
processes over ``torch.distributed``, after which :func:`make_mesh` and
:func:`make_mesh_2d` span every process's positions and the sharded
operators' collectives cross processes; :func:`run_multiprocess_dryrun`
drives that path in fresh interpreters.
"""

from .distributed import (  # noqa: F401
    axis_size,
    initialize_multihost,
    make_mesh_2d,
    process_count,
    process_index,
    run_multiprocess_dryrun,
    shutdown_multihost,
)
from .mesh import (  # noqa: F401
    Mesh,
    Transport,
    gather,
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
    "Transport",
    "axis_size",
    "gather",
    "initialize_multihost",
    "make_mesh",
    "make_mesh_2d",
    "move",
    "pad_to_multiple",
    "ppermute",
    "process_count",
    "process_index",
    "psum",
    "replicate",
    "run_multiprocess_dryrun",
    "shard_rows",
    "shutdown_multihost",
]
