"""Sketch factory (port of ``rlaopt_tpu/sketches/factory.py``)."""

from .enums import _SketchMode
from .base import Sketch
from .gauss import Gauss
from .ortho import Ortho
from .sparse_sign import Sparse
from .srht import SRHT


SKETCH_MODE_TO_CLASS = {
    _SketchMode.GAUSS: Gauss,
    _SketchMode.ORTHO: Ortho,
    _SketchMode.SPARSE: Sparse,
    _SketchMode.SRHT: SRHT,
}


__all__ = ["get_sketch"]


def get_sketch(
    name: str,
    mode: str,
    sketch_size: int,
    matrix_dim: int,
    dtype,
    key=None,
    device=None,
) -> Sketch:
    """Create a Sketch.

    Args:
        name: "gauss", "ortho", "sparse", or "srht".
        mode: "left" or "right".
        sketch_size: target dimension s.
        matrix_dim: original dimension d.
        dtype: element dtype (a ``torch.dtype``).
        key: ``torch.Generator`` / int seed / None (the package chain).
        device: where the embedding is drawn; None is the CUDA card.
    """
    sketch_name = _SketchMode._from_str(name, "name")
    sketch_class = SKETCH_MODE_TO_CLASS[sketch_name]
    return sketch_class(mode, sketch_size, matrix_dim, dtype, key, device)
