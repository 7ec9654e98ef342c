"""rlaopt_tpu_torch — the PyTorch + CUDA port of ``rlaopt_tpu``.

Same module layout and names as the JAX package, in PyTorch idiom: plain
classes on tensors, an explicit ``device``, ``torch.Generator`` in place of
PRNG keys and Python loops in place of ``jit``/``lax.scan``. The Gram
products of the kernel operators (exact tier, bf16 tiers, and the float64
route of refinement) run through hand-written CUDA kernels (``csrc/*.cu``)
for CUDA tensors and through their plain PyTorch versions
(``ops/kernel_plain.py``) for CPU tensors; so do the sparse operators' CSR
products (``csrc/spmv.cu``, plain versions in ``sparse/ops.py``).

This package never imports ``jax``.
"""

__version__ = "0.1.0"

from . import utils  # noqa: F401
from . import linops  # noqa: F401
from . import ops  # noqa: F401
from . import kernels  # noqa: F401
from . import sketches  # noqa: F401
from . import spectral_estimators  # noqa: F401
from . import sparse  # noqa: F401
from . import preconditioners  # noqa: F401
from . import solvers  # noqa: F401
from . import models  # noqa: F401
from . import interop  # noqa: F401

from .utils.rng import seed  # noqa: F401
