"""Sketch enums (port of ``rlaopt_tpu/sketches/enums.py``)."""

from enum import Enum, auto


class _SketchSide(Enum):
    """Which side the sketch multiplies on."""

    LEFT = auto()
    RIGHT = auto()

    @classmethod
    def _from_str(cls, value, param_name):
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            v = value.lower()
            if v == "left":
                return cls.LEFT
            if v == "right":
                return cls.RIGHT
        raise ValueError(
            f"Invalid value for {param_name}: {value}. "
            "Expected 'left', 'right', _SketchSide.LEFT, or _SketchSide.RIGHT."
        )


class _SketchMode(Enum):
    """Sketch family."""

    GAUSS = auto()
    ORTHO = auto()
    SPARSE = auto()
    SRHT = auto()

    @classmethod
    def _from_str(cls, value, param_name):
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            v = value.lower()
            if v == "gauss":
                return cls.GAUSS
            if v == "ortho":
                return cls.ORTHO
            if v == "sparse":
                return cls.SPARSE
            if v == "srht":
                return cls.SRHT
        raise ValueError(
            f"Invalid value for {param_name}: {value}. "
            "Expected 'gauss', 'ortho', 'sparse', 'srht', or a _SketchMode."
        )
