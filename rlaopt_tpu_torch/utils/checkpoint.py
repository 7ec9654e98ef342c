"""Checkpoint and resume for solver state.

Port of ``rlaopt_tpu/utils/checkpoint.py``. A solver state (the PCG, SAP
or LSQR NamedTuple), the convergence mask and the iteration counter are
saved every ``checkpoint_freq`` logging rounds and restored to resume a
solve. The files are the JAX package's own ``.npz`` layout:
``step_%08d.npz`` holds the payload's leaves as ``leaf_0 … leaf_{n-1}``
in the JAX package's flatten order (dict keys sorted, NamedTuple fields in
order, list and tuple items in order), and ``step_%08d.aux.json`` the log
and the cumulative wall-clock. No orbax (it imports JAX).

So the two packages read each other's checkpoints where the states agree
leaf for leaf: PCG's ``(W, R, Z, P_, RZ, ok)`` and LSQR's ``(Y, U, V, W,
alpha, phibar, rhobar)``, with the mask first. SAP's do not cross: the JAX
state carries a PRNG key that the port's has no counterpart for (the port
draws from the solver's generator and the iteration counter).
"""

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from ._tree import flatten_with_path, unflatten


__all__ = ["SolveCheckpointer"]


def _jsonify(obj):
    """A log or metrics tree as JSON-safe values (tensors as lists)."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return repr(obj)


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(ref, x: np.ndarray):
    """``x`` as ``ref``'s kind of leaf: a tensor of its dtype on its device,
    or a Python scalar of its type."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(x)).to(device=ref.device, dtype=ref.dtype)
    if isinstance(ref, (bool, int, float)):
        return type(ref)(x.item())
    return x


class SolveCheckpointer:
    """Persist (iteration, solver state, mask) under a directory."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    steps.append(int(name.split("_")[1].split(".")[0]))
                except ValueError:
                    continue
        return max(steps) if steps else None

    # -- save/restore --------------------------------------------------------
    def save(self, step: int, payload: Any, aux: Optional[dict] = None) -> None:
        """Save ``payload``'s leaves at ``step`` (Python scalars as 0-d
        arrays). ``aux``: a JSON sidecar (the log, the cumulative
        wall-clock) so a resumed solve keeps its log and timing."""
        leaves = [leaf for _, leaf in flatten_with_path(payload)]
        np.savez(
            self._step_dir(step) + ".npz",
            **{f"leaf_{i}": _as_numpy(x) for i, x in enumerate(leaves)},
        )
        if aux is not None:
            with open(self._step_dir(step) + ".aux.json", "w") as f:
                json.dump(_jsonify(aux), f)

    def restore_aux(self, step: Optional[int] = None) -> Optional[dict]:
        """Load the aux sidecar saved at ``step`` (default: latest), if any."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = self._step_dir(step) + ".aux.json"
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore(self, step: Optional[int] = None, like: Any = None):
        """``(payload, step)`` at ``step`` (default: latest).

        ``like`` gives the structure, and each leaf's dtype and device
        (required: payloads are stored as flat leaves). A tensor leaf comes
        back on ``like``'s device, so a solve on the card resumes there.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        if like is None:
            raise ValueError("restore requires `like` (reference pytree)")
        with np.load(self._step_dir(step) + ".npz", allow_pickle=False) as data:
            n = len([k for k in data.files if k.startswith("leaf_")])
            stored = [data[f"leaf_{i}"] for i in range(n)]
        refs = [leaf for _, leaf in flatten_with_path(like)]
        return unflatten(like, [_like(r, x) for r, x in zip(refs, stored)]), step
