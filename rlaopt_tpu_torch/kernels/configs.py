"""Kernel configuration (port of ``rlaopt_tpu/kernels/configs.py``).

``lengthscale`` may be a float (isotropic) or a 1-D tensor or array (ARD).
"""

from dataclasses import dataclass
from typing import Any, Union

import numpy as np
import torch

from ..utils.checkers import _as_device, _is_float


__all__ = ["KernelConfig", "_is_kernel_config"]


@dataclass(kw_only=True, frozen=False)
class KernelConfig:
    """Kernel hyperparameters.

    Attributes:
        const_scaling: scalar multiplier on the kernel matrix.
        lengthscale: float or 1-D tensor (ARD, one scale per feature).
    """

    const_scaling: float = 1.0
    lengthscale: Union[float, torch.Tensor, np.ndarray]

    def __post_init__(self):
        _is_float(self.const_scaling, "const_scaling")
        if not isinstance(self.lengthscale, (float, torch.Tensor, np.ndarray)):
            raise TypeError(
                f"lengthscale is of type {type(self.lengthscale).__name__}, "
                "but expected type float or torch.Tensor"
            )
        if not isinstance(self.lengthscale, float) and self.lengthscale.ndim != 1:
            raise ValueError(
                f"lengthscale has {self.lengthscale.ndim} dimensions, "
                "but expected 1 dimension"
            )

    def to_dict(self) -> dict:
        ls = self.lengthscale
        return {
            "const_scaling": self.const_scaling,
            "lengthscale": ls if isinstance(ls, float) else np.asarray(
                ls.cpu() if isinstance(ls, torch.Tensor) else ls
            ).tolist(),
        }

    def lengthscale_tensor(self, dtype: torch.dtype, device) -> torch.Tensor:
        """Lengthscale as a 0-D or (d,) tensor of ``dtype`` on ``device``."""
        return torch.as_tensor(self.lengthscale, dtype=dtype, device=device)

    def lengthscale_array(self, dtype, *, device=None) -> torch.Tensor:
        """Lengthscale as a broadcastable 0-D or (d,) tensor of ``dtype`` (a
        torch or numpy dtype), as the JAX package's ``lengthscale_array``.

        It lies on the config's device: a tensor lengthscale's own, the CUDA
        card for a float or a numpy array (raising where there is none)
        unless ``device``, the port's own keyword, names another."""
        if device is None:
            ls = self.lengthscale
            device = ls.device if isinstance(ls, torch.Tensor) else _as_device(None)
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.empty(0, dtype=dtype)).dtype
        return self.lengthscale_tensor(dtype, device)


def _is_kernel_config(param: Any, param_name: str):
    if not isinstance(param, KernelConfig):
        raise TypeError(
            f"{param_name} is of type {type(param).__name__}, "
            "but expected type KernelConfig"
        )
