"""Type helpers for linear operators (port of ``rlaopt_tpu/linops/types.py``)."""

from typing import Any, Union

import torch

from .base import LinOp, TwoSidedLinOp, SymmetricLinOp


__all__ = ["LinOpType", "_is_linop_or_tensor", "is_linop"]


LinOpType = Union[LinOp, TwoSidedLinOp, SymmetricLinOp]


def is_linop(obj: Any) -> bool:
    return isinstance(obj, LinOp)


def _is_linop_or_tensor(param: Any, param_name: str):
    if isinstance(param, (LinOp, torch.Tensor)):
        return
    from ..sparse.sparse_tensor import _SparseTensor

    if isinstance(param, _SparseTensor):
        return
    raise TypeError(
        f"{param_name} is of type {type(param).__name__}, "
        "but expected type LinOpType, torch.Tensor, or a sparse tensor"
    )
