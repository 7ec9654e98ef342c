"""Matrix-free linear operators as plain classes.

Port of ``rlaopt_tpu/linops/base.py``. Operators are not pytrees here:
``matvec``/``matmat`` are closures over tensors, and nothing has to cross a
``jit`` boundary. Without an explicit matmat, one is derived by applying the
matvec to each column. Scalar scaling is folded into every application, and
nested scalings merge by ``__mul__``.
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


class LinOp:
    """One-sided matrix-free operator: supports ``A @ x`` only.

    Args:
        shape: (n_rows, n_cols).
        matvec: ``f(x) -> y``.
        matmat: optional ``f(X) -> Y``; derived from matvec if omitted.
        dtype: operator element dtype.
        device: device of the operator's payload.
        scale: scalar multiplier folded into every application.
    """

    _is_two_sided = False

    def __init__(
        self,
        shape: Tuple[int, int],
        matvec: Callable,
        matmat: Optional[Callable] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
        scale=1.0,
    ):
        _is_callable(matvec, "matvec")
        if matmat is not None:
            _is_callable(matmat, "matmat")
        if len(shape) != 2:
            raise ValueError(f"shape must have length 2, got {shape}")
        self._shape = (int(shape[0]), int(shape[1]))
        self._dtype = dtype
        self._device = torch.device(device if device is not None else "cpu")
        self._mv = matvec
        self._mm = matmat if matmat is not None else _cols(matvec)
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
        device=None,
        scale=1.0,
    ):
        super().__init__(
            shape, matvec, matmat=matmat, dtype=dtype, device=device, scale=scale
        )
        _is_callable(rmatvec, "rmatvec")
        if rmatmat is not None:
            _is_callable(rmatmat, "rmatmat")
        self._rmv = rmatvec
        self._rmm = rmatmat if rmatmat is not None else _cols(rmatvec)

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
        device=None,
        scale=1.0,
    ):
        if shape[0] != shape[1]:
            raise ValueError(
                f"SymmetricLinOp requires a square shape, received {tuple(shape)}."
            )
        super().__init__(
            shape, matvec, rmatvec=matvec, matmat=matmat, rmatmat=matmat,
            dtype=dtype, device=device, scale=scale,
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
