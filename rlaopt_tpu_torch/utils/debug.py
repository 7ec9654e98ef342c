"""Numerical-debug helpers.

Port of ``rlaopt_tpu/utils/debug.py``. The failure modes that matter in a
solve are numerical: NaN and Inf carried through the iterations. These
helpers make them visible:

* :func:`check_finite` prints a message when a tensor holds a NaN or an Inf
  and returns it unchanged (a pass-through tap);
* :func:`assert_finite_tree` raises ``FloatingPointError`` on the first
  floating leaf of a nested state that is not finite, naming its path as
  ``jax.tree_util.keystr`` writes it (``['state'].W``, ``['mask'][0]``);
* :func:`debug_nans` is a context in which any torch operation whose
  output holds a NaN raises ``FloatingPointError`` (JAX's ``jax_debug_nans``
  flag: NaN only, not Inf).

Every check reads the values on the host, so on a CUDA card each one
synchronizes the device: they are for debugging, not for timed runs.
"""

import contextlib
from typing import Any

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ._tree import flatten_with_path


__all__ = ["check_finite", "debug_nans", "assert_finite_tree"]


def _is_floating(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point() or x.is_complex()
    if isinstance(x, np.ndarray):
        return np.issubdtype(x.dtype, np.floating) or np.issubdtype(x.dtype, np.complexfloating)
    return False


def _all_finite(x) -> bool:
    if isinstance(x, torch.Tensor):
        return bool(torch.all(torch.isfinite(x)))
    return bool(np.all(np.isfinite(x)))


def check_finite(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """Print ``[rlaopt_tpu_torch] non-finite values detected in {name}`` when
    ``x`` holds a NaN or an Inf; return ``x`` unchanged.

    On a CUDA tensor the check synchronizes the device (it reads one bool
    on the host).
    """
    if not _all_finite(x):
        print(f"[rlaopt_tpu_torch] non-finite values detected in {name}")
    return x


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` on the first floating leaf of ``tree``
    (dicts in sorted key order, NamedTuples, lists, tuples; torch tensors or
    numpy arrays) that holds a NaN or an Inf. Synchronizes a CUDA device."""
    for path, leaf in flatten_with_path(tree):
        if _is_floating(leaf) and not _all_finite(leaf):
            raise FloatingPointError(f"non-finite values in {name}{path}")


# Ops whose outputs are not checked. The empty family's outputs are
# uninitialized memory, any bits (NaN patterns among them) until something
# writes them; the kernel wrappers allocate their outputs so. The constant
# constructors make what the code asked for: a NaN there is a sentinel
# (``cholesky_or_nan``'s fallback, ``torch.where(ok, U, nan)``), and it
# raises where an operation carries it into a result.
_UNCHECKED = {
    torch.ops.aten.empty,
    torch.ops.aten.empty_strided,
    torch.ops.aten.empty_like,
    torch.ops.aten.new_empty,
    torch.ops.aten.new_empty_strided,
    torch.ops.aten.empty_permuted,
    torch.ops.aten.full,
    torch.ops.aten.full_like,
    torch.ops.aten.new_full,
    torch.ops.aten.scalar_tensor,
    torch.ops.aten.lift_fresh,
    torch.ops.aten.lift_fresh_copy,
}

_state = {"on": False, "mode": None}


class _NaNCheck(TorchDispatchMode):
    """Raise when a floating output of an aten op holds a NaN (while the
    module's flag is on)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _state["on"] and func.overloadpacket not in _UNCHECKED:
            for _, t in flatten_with_path(out):
                if isinstance(t, torch.Tensor) and _is_floating(t) and bool(torch.isnan(t).any()):
                    raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the context, any torch operation whose output holds a NaN
    raises ``FloatingPointError`` (Infs pass, as under JAX's flag).

    Each operation's outputs are read on the host, so on a card every
    operation synchronizes. The outputs of the ``empty`` family
    (uninitialized memory) and of the constant constructors (``full``,
    ``full_like``, a tensor of a Python number: a NaN there is a sentinel
    the code chose) are not checked. The CUDA kernels write their outputs
    through their own entry points, outside PyTorch's dispatcher: a NaN
    that a kernel writes raises at the next torch operation that reads it.
    Nested contexts restore the enclosing state on exit;
    ``debug_nans(False)`` inside an enabled block turns the check off.
    """
    prev = _state["on"]
    _state["on"] = bool(enable)
    pushed = None
    if enable and _state["mode"] is None:
        pushed = _state["mode"] = _NaNCheck()
        pushed.__enter__()
    try:
        yield
    finally:
        if pushed is not None:
            pushed.__exit__(None, None, None)
            _state["mode"] = None
        _state["on"] = prev
