"""The data of a run, drawn on the device from ``--seed``.

The recipe is the repository's HIGGS surrogate (``chip_smoke.py::
synthetic_higgs``, after the JAX benchmarks' dataset module): d
standard-normal features and the target ``tanh(X w) + 0.1·ε`` with a
standard-normal ``w``. Here it is drawn with a ``torch.Generator`` on the
device, in one call for the points and one for each target's ``w`` and
``ε``, so that set-up pays no host draw and no copy. Every stream has a seed
of its own, derived from the run's seed and the stream's name and index, so
that one seed gives the same points and targets, and solve ``j`` of a run
takes the same target whatever the runs before it did. Traffic whose work
would change with the data draws the points and targets of every seed from
one fixed seed, and each run's seed draws the sign of each target.
"""

import zlib

import numpy as np
import torch


def stream_seed(seed: int, name: str, index: int = 0) -> int:
    """A 63-bit seed for the stream ``name``/``index`` of a run's ``seed``
    (any whole number)."""
    entropy = [seed % (1 << 64), zlib.crc32(name.encode()), index]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, name: str, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, name, index))


def points(seed: int, n: int, d: int, device) -> torch.Tensor:
    """X (n, d) float32, standard normal."""
    g = generator(seed, "points", 0, device)
    return torch.randn((n, d), generator=g, device=device, dtype=torch.float32)


def target(seed: int, j: int, X: torch.Tensor, columns: int, noise: float,
           stream: str = "targets") -> torch.Tensor:
    """Target ``j`` of the stream: ``tanh(X w) + noise·ε``, (n, columns)
    float32, with a fresh w (d, columns) and ε (n, columns)."""
    n, d = X.shape
    g = generator(seed, stream, j, X.device)
    w = torch.randn((d, columns), generator=g, device=X.device, dtype=X.dtype)
    eps = torch.randn((n, columns), generator=g, device=X.device, dtype=X.dtype)
    return torch.tanh(X @ w) + noise * eps


def sign(seed: int, j: int) -> float:
    """+1.0 or -1.0 for target ``j`` of a run: the seed's draw for traffic
    that takes every seed's targets from one pool (the solve of -y is that
    of y, negated)."""
    return 1.0 if stream_seed(seed, "signs", j) & 1 else -1.0


def sample_rows(seed: int, n: int, rows) -> torch.Tensor:
    """The rows the check reads: all of them when ``rows`` is None or at
    least n, else that many distinct rows drawn from the seed, sorted (on
    the host, int64)."""
    if rows is None or rows >= n:
        return torch.arange(n)
    rng = np.random.default_rng(stream_seed(seed, "check_rows"))
    return torch.from_numpy(np.sort(rng.choice(n, size=rows, replace=False)))
