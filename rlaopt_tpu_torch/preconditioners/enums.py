"""Preconditioner enums (port of ``rlaopt_tpu/preconditioners/enums.py``)."""

from enum import Enum, auto


class _DampingMode(Enum):
    """Damping strategy for the Nyström preconditioner."""

    ADAPTIVE = auto()
    NON_ADAPTIVE = auto()

    @classmethod
    def _from_str(cls, value, param_name):
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            v = value.lower()
            if v == "adaptive":
                return cls.ADAPTIVE
            if v == "non_adaptive":
                return cls.NON_ADAPTIVE
        raise ValueError(
            f"Invalid value for {param_name}: {value}. "
            "Expected 'adaptive', 'non_adaptive', or a _DampingMode."
        )
