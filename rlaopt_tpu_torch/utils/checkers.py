"""Input validation helpers.

Port of ``rlaopt_tpu/utils/checkers.py``: the same TypeError/ValueError
contract (which check fires on which bad input), on torch tensors, torch
dtypes and ``torch.Generator`` in place of JAX arrays and PRNG keys.
"""

from typing import Any

import numpy as np
import torch


__all__ = [
    "_is_bool",
    "_is_callable",
    "_is_dict",
    "_is_float",
    "_is_int",
    "_is_list",
    "_is_set",
    "_is_str",
    "_is_tensor",
    "_is_tensor_1d_2d",
    "_is_dtype",
    "_is_dtype_f32_f64",
    "_is_nonneg_float",
    "_is_pos_float",
    "_is_pos_int",
    "_is_generator",
    "_as_generator",
]


def _require_type(param: Any, param_name: str, types, want: str):
    """Raise TypeError unless ``param`` is an instance of ``types``."""
    if not isinstance(param, types):
        raise TypeError(
            f"expected {param_name} to be {want}; "
            f"got {type(param).__name__} instead"
        )


def _is_bool(param: Any, param_name: str):
    _require_type(param, param_name, bool, "a bool")


def _is_callable(param: Any, param_name: str):
    if not callable(param):
        raise TypeError(
            f"expected {param_name} to be callable; "
            f"got {type(param).__name__} instead"
        )


def _is_dict(param: Any, param_name: str):
    _require_type(param, param_name, dict, "a dict")


def _is_float(param: Any, param_name: str):
    _require_type(param, param_name, float, "a float")


def _is_int(param: Any, param_name: str):
    # bool is an int subclass in Python; reject it explicitly.
    if isinstance(param, bool):
        raise TypeError(f"expected {param_name} to be an int; got bool instead")
    _require_type(param, param_name, (int, np.integer), "an int")


def _is_list(param: Any, param_name: str):
    _require_type(param, param_name, list, "a list")


def _is_set(param: Any, param_name: str):
    _require_type(param, param_name, set, "a set")


def _is_str(param: Any, param_name: str):
    _require_type(param, param_name, str, "a str")


def _is_tensor(param: Any, param_name: str):
    _require_type(param, param_name, torch.Tensor, "a torch.Tensor")


def _is_tensor_1d_2d(param: Any, param_name: str):
    _is_tensor(param, param_name)
    if param.ndim not in (1, 2):
        raise ValueError(
            f"{param_name} needs 1 or 2 dimensions; this tensor has {param.ndim}"
        )


def _is_dtype(param: Any, param_name: str):
    _require_type(param, param_name, torch.dtype, "a torch.dtype")


def _is_dtype_f32_f64(param: Any, param_name: str):
    _is_dtype(param, param_name)
    if param not in (torch.float32, torch.float64):
        raise ValueError(f"{param_name} must be float32 or float64 (got {param})")


def _is_nonneg_float(param: Any, param_name: str):
    _is_float(param, param_name)
    if param < 0:
        raise ValueError(f"{param_name} cannot be negative (got {param})")


def _is_pos_float(param: Any, param_name: str):
    _is_float(param, param_name)
    if param <= 0:
        raise ValueError(f"{param_name} must be > 0 (got {param})")


def _is_pos_int(param: Any, param_name: str):
    _is_int(param, param_name)
    if param <= 0:
        raise ValueError(f"{param_name} must be > 0 (got {param})")


def _is_generator(param: Any, param_name: str):
    _require_type(param, param_name, torch.Generator, "a torch.Generator")


def _as_generator(key: Any, param_name: str = "key") -> torch.Generator:
    """Coerce ``key`` to a ``torch.Generator``.

    Accepts an existing generator, an int seed, or None (a fresh generator
    split off the package chain, see :mod:`rlaopt_tpu_torch.utils.rng`).
    """
    from .rng import next_generator

    if key is None:
        return next_generator()
    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        return torch.Generator().manual_seed(int(key))
    _is_generator(key, param_name)
    return key


def _as_device(device: Any) -> torch.device:
    """``device`` as a ``torch.device``; None is the CUDA card, every entry
    point's default, and raises where there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the default device is the CUDA card and none is available: "
            "pass device='cpu' to run on the host"
        )
    return torch.device("cuda")
