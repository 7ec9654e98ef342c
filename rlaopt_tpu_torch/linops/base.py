"""Matrix-free linear operators as plain classes.

Port of ``rlaopt_tpu/linops/base.py``. Operators are not pytrees here:
``matvec``/``matmat`` are closures over tensors, and nothing has to cross a
``jit`` boundary. As in the JAX package, a caller may pass the payload as
``data`` instead: the callables are then called as ``f(data, x)``. Without
an explicit matmat, one is derived by applying the matvec to each column.
Scalar scaling is folded into every application, and nested scalings merge
by ``__mul__``. The parameters keep the JAX package's order; ``device``, the
port's own, comes after them.
"""

from typing import Callable, Optional, Tuple

import torch

from ..utils.checkers import _is_callable


__all__ = ["LinOp", "TwoSidedLinOp", "SymmetricLinOp", "aslinop"]


def _cols(fn: Callable) -> Callable:
    """Derive a matmat from a matvec, one column at a time."""

    def mm(X):
        return torch.stack([fn(X[:, i]) for i in range(X.shape[1])], dim=1)

    return mm


def _bind(fn: Optional[Callable], data) -> Optional[Callable]:
    """``fn`` itself without a payload; ``x ↦ fn(data, x)`` with one (the
    JAX package's calling convention when ``data`` is given)."""
    if fn is None or data is None:
        return fn
    return lambda x: fn(data, x)


def _data_device(data):
    """The device of the first tensor in ``data`` (a tensor, or a tuple,
    list or dict of them), or None."""
    if isinstance(data, torch.Tensor):
        return data.device
    leaves = data.values() if isinstance(data, dict) else data
    if isinstance(leaves, (tuple, list)) or isinstance(data, dict):
        for leaf in leaves:
            dev = _data_device(leaf)
            if dev is not None:
                return dev
    return None


class LinOp:
    """One-sided matrix-free operator: supports ``A @ x`` only.

    Args:
        shape: (n_rows, n_cols).
        matvec: ``f(x) -> y``, or ``f(data, x) -> y`` when ``data`` is given.
        matmat: optional ``f(X) -> Y`` (``f(data, X)``); derived from matvec
            if omitted.
        dtype: operator element dtype.
        data: optional payload handed to the callables as their first
            argument, as in the JAX package; ``()`` when omitted.
        scale: scalar multiplier folded into every application.
        device: device of the operator's payload; by default that of the
            first tensor in ``data``, else the CPU.
    """

    _is_two_sided = False

    def __init__(
        self,
        shape: Tuple[int, int],
        matvec: Callable,
        matmat: Optional[Callable] = None,
        dtype: torch.dtype = torch.float32,
        data=None,
        scale=1.0,
        device=None,
    ):
        _is_callable(matvec, "matvec")
        if matmat is not None:
            _is_callable(matmat, "matmat")
        if len(shape) != 2:
            raise ValueError(f"shape must have length 2, got {shape}")
        self._shape = (int(shape[0]), int(shape[1]))
        self._dtype = dtype
        if device is None:
            device = _data_device(data)
        self._device = torch.device(device if device is not None else "cpu")
        self._data = () if data is None else data
        self._mv = _bind(matvec, data)
        mm = _bind(matmat, data)
        self._mm = mm if mm is not None else _cols(self._mv)
        self._scale = scale

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def data(self):
        """The payload given as ``data`` (``()`` when none was)."""
        return self._data

    @property
    def scale(self):
        return self._scale

    def _apply_scale(self, y):
        if isinstance(self._scale, (int, float)) and self._scale == 1.0:
            return y
        return self._scale * y

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply_scale(self._mv(x))

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        return self._apply_scale(self._mm(X))

    def __matmul__(self, x):
        if isinstance(x, LinOp):
            return _compose(self, x)
        if x.ndim not in (1, 2):
            raise ValueError(f"x must be 1D or 2D, got {x.ndim}D")
        if x.shape[0] != self._shape[1]:
            raise ValueError(
                f"dimension mismatch: operator is {self._shape}, "
                f"operand has leading dim {x.shape[0]}"
            )
        return self.matvec(x) if x.ndim == 1 else self.matmat(x)

    def __rmatmul__(self, x):
        raise TypeError(
            "x @ A requires a two-sided operator (TwoSidedLinOp/SymmetricLinOp)"
        )

    def _with_scale(self, scale):
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._scale = scale
        return new

    def __mul__(self, c):
        return self._with_scale(self._scale * c)

    __rmul__ = __mul__

    def __neg__(self):
        return self * (-1.0)

    def todense(self) -> torch.Tensor:
        """Densify via ``A @ I``."""
        eye = torch.eye(self._shape[1], dtype=self._dtype, device=self._device)
        return self.matmat(eye)

    def __repr__(self):
        return f"{type(self).__name__}(shape={self._shape}, dtype={self._dtype})"


class TwoSidedLinOp(LinOp):
    """Operator with forward and adjoint: ``A @ x``, ``x @ A``, ``A.T``."""

    _is_two_sided = True

    def __init__(
        self,
        shape: Tuple[int, int],
        matvec: Callable,
        rmatvec: Callable,
        matmat: Optional[Callable] = None,
        rmatmat: Optional[Callable] = None,
        dtype: torch.dtype = torch.float32,
        data=None,
        scale=1.0,
        device=None,
    ):
        super().__init__(
            shape, matvec, matmat=matmat, dtype=dtype, data=data, scale=scale, device=device
        )
        _is_callable(rmatvec, "rmatvec")
        if rmatmat is not None:
            _is_callable(rmatmat, "rmatmat")
        self._rmv = _bind(rmatvec, data)
        rmm = _bind(rmatmat, data)
        self._rmm = rmm if rmm is not None else _cols(self._rmv)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply_scale(self._rmv(x))

    def rmatmat(self, X: torch.Tensor) -> torch.Tensor:
        return self._apply_scale(self._rmm(X))

    def __rmatmul__(self, x):
        if x.ndim not in (1, 2):
            raise ValueError(f"x must be 1D or 2D, got {x.ndim}D")
        if x.ndim == 1:
            if x.shape[0] != self._shape[0]:
                raise ValueError(
                    f"dimension mismatch: operator is {self._shape}, "
                    f"left operand has dim {x.shape[0]}"
                )
            return self.rmatvec(x)
        if x.shape[1] != self._shape[0]:
            raise ValueError(
                f"dimension mismatch: operator is {self._shape}, "
                f"left operand has trailing dim {x.shape[1]}"
            )
        return self.rmatmat(x.T).T

    @property
    def T(self) -> "TwoSidedLinOp":
        """Transpose: swaps forward and adjoint."""
        new = object.__new__(TwoSidedLinOp)
        new.__dict__.update(self.__dict__)
        new._shape = (self._shape[1], self._shape[0])
        new._mv, new._rmv = self._rmv, self._mv
        new._mm, new._rmm = self._rmm, self._mm
        return new


class SymmetricLinOp(TwoSidedLinOp):
    """Square symmetric operator; ``.T`` returns self."""

    def __init__(
        self,
        shape: Tuple[int, int],
        matvec: Callable,
        matmat: Optional[Callable] = None,
        dtype: torch.dtype = torch.float32,
        data=None,
        scale=1.0,
        device=None,
    ):
        if shape[0] != shape[1]:
            raise ValueError(
                f"SymmetricLinOp requires a square shape, received {tuple(shape)}."
            )
        super().__init__(
            shape, matvec, rmatvec=matvec, matmat=matmat, rmatmat=matmat,
            dtype=dtype, data=data, scale=scale, device=device,
        )

    @property
    def T(self) -> "SymmetricLinOp":
        return self


def _compose(A: LinOp, B: LinOp) -> LinOp:
    """Operator composition ``(A @ B) x = A (B x)``."""
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"cannot compose {A.shape} with {B.shape}")
    shape = (A.shape[0], B.shape[1])

    def mv(x):
        return A @ (B @ x)

    if A._is_two_sided and B._is_two_sided:
        return TwoSidedLinOp(
            shape, mv, lambda x: (x @ A) @ B, matmat=mv,
            dtype=A.dtype, device=A.device,
        )
    return LinOp(shape, mv, matmat=mv, dtype=A.dtype, device=A.device)


def aslinop(M) -> TwoSidedLinOp:
    """Wrap a dense matrix, or a sparse CSR/CSC tensor, as a two-sided
    operator; sparse tensors go to
    :func:`rlaopt_tpu_torch.sparse.linop.sparse_aslinop`."""
    from ..sparse.sparse_tensor import _SparseTensor

    if isinstance(M, _SparseTensor):
        from ..sparse.linop import sparse_aslinop

        return sparse_aslinop(M)
    if M.ndim != 2:
        raise ValueError(f"expected a 2D matrix, got {M.ndim}D")
    return TwoSidedLinOp(
        tuple(M.shape),
        lambda x: torch.matmul(M, x),
        lambda x: torch.matmul(M.T, x),
        dtype=M.dtype,
        device=M.device,
    )
