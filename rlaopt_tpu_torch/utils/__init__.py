"""Utility layer: validators, logging, RNG, profiling, checkpoints, debug
helpers and small linear algebra."""

from .checkers import *  # noqa: F401,F403
from .logger import *  # noqa: F401,F403
from .rng import *  # noqa: F401,F403
from .wandb_ import *  # noqa: F401,F403
from .profiling import *  # noqa: F401,F403
from .checkpoint import *  # noqa: F401,F403
from .debug import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403

from . import checkers, logger, rng, wandb_, profiling, checkpoint, debug, linalg

__all__ = []
for _m in (checkers, logger, rng, wandb_, profiling, checkpoint, debug, linalg):
    __all__.extend(_m.__all__)
