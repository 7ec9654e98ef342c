"""Linop enums (port of ``rlaopt_tpu/linops/enums.py``)."""

from enum import Enum, auto


class _DistributionMode(Enum):
    """How an operator is partitioned across the mesh axis."""

    ROW = auto()
    COLUMN = auto()

    @classmethod
    def _from_str(cls, value, param_name):
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            v = value.lower()
            if v == "row":
                return cls.ROW
            if v == "column":
                return cls.COLUMN
        raise ValueError(
            f"Invalid value for {param_name}: {value}. "
            "Expected 'row', 'column', or a _DistributionMode."
        )
