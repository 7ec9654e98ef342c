"""Package-level RNG convenience.

Port of ``rlaopt_tpu/utils/rng.py``: a ``torch.Generator`` chain takes the
place of the JAX key chain. The functional core takes explicit generators;
the object shell may omit one, and then a generator seeded from the package
chain is used. Call :func:`seed` for reproducibility of the implicit path.

Generators live on the CPU. :func:`device_generator` derives a generator on
another device from one draw of a CPU generator, so large random draws are
made where they are used. :func:`fold_in` derives a generator from another
and an integer without drawing from it (``jax.random.fold_in``).
"""

import threading

import numpy as np
import torch


__all__ = ["seed", "next_generator", "device_generator", "fold_in"]

_lock = threading.Lock()
_state = {"gen": None}

_SEED_BOUND = 1 << 62


def seed(s: int) -> None:
    """Seed the package chain (analog of ``torch.manual_seed``)."""
    with _lock:
        _state["gen"] = torch.Generator().manual_seed(int(s))


def next_generator() -> torch.Generator:
    """A fresh CPU generator seeded by one draw of the package chain."""
    with _lock:
        if _state["gen"] is None:
            _state["gen"] = torch.Generator().manual_seed(0)
        s = int(torch.randint(_SEED_BOUND, (1,), generator=_state["gen"]))
    return torch.Generator().manual_seed(s)


def device_generator(gen: torch.Generator, device) -> torch.Generator:
    """``gen`` itself for the CPU; otherwise a generator on ``device`` seeded
    by one draw of ``gen`` (so a seed gives one stream per device type)."""
    device = torch.device(device)
    if device.type == "cpu":
        return gen
    s = int(torch.randint(_SEED_BOUND, (1,), generator=gen))
    return torch.Generator(device=device).manual_seed(s)


def fold_in(gen: torch.Generator, data: int) -> torch.Generator:
    """A new CPU generator determined by ``gen``'s seed and ``data``; ``gen``
    is not advanced, so equal inputs give equal streams."""
    words = np.random.SeedSequence([gen.initial_seed(), int(data)]).generate_state(2)
    s = (int(words[0]) << 32 | int(words[1])) % _SEED_BOUND
    return torch.Generator().manual_seed(s)
