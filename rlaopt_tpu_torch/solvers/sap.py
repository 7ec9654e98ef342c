"""SAP — randomized block-coordinate solver ("ASkotch" for KRR).

Port of ``rlaopt_tpu/solvers/sap.py`` with the same iterates: uniform
block sampling without replacement, a block preconditioner per step
(Identity, Newton or Nyström) built from ``A_blk_oracle(blk)``, the stepsize
``1/λ_max(P⁻¹(A_blk + reg·I))`` by power iteration (exactly 1 for Newton at
``rho == reg``), the block gradient through ``A_row_oracle(blk)``, optional
Nesterov-type acceleration with (β, γ, α) from (μ, ν), and per-column
convergence masking.

In PyTorch:

* ``_run_chunk(n)`` is a Python loop of n steps in place of one
  ``lax.scan``; nothing in a step reads a value back to the host (the
  stepsize, the finite-direction test and the mask stay tensors), so the
  only waits on the device are the model's logging boundaries.
* ``W.at[blk].add`` is ``index_add``; the block indices are distinct.
* A failed factorization gives NaN factors (:func:`cholesky_or_nan`), so a
  degenerate block yields a non-finite direction and is skipped for the
  columns it touches, as in the JAX package.
* Randomness comes from the solver's ``torch.Generator``, whose seed the
  state carries as its ``key`` (the JAX package's field): each step draws
  its sketch and its power-iteration start from generators folded from it
  and the iteration counter, and host block sampling seeds numpy with the
  seed and the counter. The numbers differ from the JAX key
  stream; the test hooks ``_block_schedule`` (a fixed (T, blk_sz) block
  schedule) and ``_draws`` (``t ↦ (Ω, v0)``, the sketch and the start of
  step t) let tests give both packages the same ones.

Spans (while a profiler records; :mod:`rlaopt_tpu_torch.utils.profiling`):
``rlaopt.sap.step`` around each step, and inside it ``rlaopt.sap.precond``
(the block preconditioner, built from ``A_blk_oracle(blk)``, or from the
block's dense tile, whose materialization is the operator's
``rlaopt.linop.blk_dense`` span inside it), ``rlaopt.sap.stepsize`` (the
power iteration), ``rlaopt.sap.row_oracle`` (the block gradient: one
``A_row_oracle(blk)`` apply) and ``rlaopt.sap.update`` (P⁻¹ of the
gradient, the finite-direction test and the recurrence), each with the
card's time inside it on a card;
``rlaopt.sync.sap_blocks`` around the upload of a chunk's host-drawn
blocks, which waits for the card. Counters
``rlaopt.sap.steps``, ``rlaopt.sap.dense_blocks`` (steps whose block tile
was materialized) and ``rlaopt.sap.degenerate_blocks`` (steps whose
direction is not finite in an active column, so skipped there; counted
on the card and read with the counters).
"""

import math
from typing import Callable, NamedTuple, Optional, TYPE_CHECKING

import numpy as np
import torch

from .configs import SAPAccelConfig
from .solver import Solver
from ..linops.base import LinOp
from ..preconditioners import (
    IdentityConfig,
    NewtonConfig,
    NystromConfig,
    PreconditionerConfig,
)
from ..preconditioners.enums import _DampingMode
from ..preconditioners.newton import newton_apply_inv, newton_update
from ..preconditioners.nystrom import (
    nystrom_apply_inv,
    nystrom_inv_chol,
    nystrom_update,
)
from ..spectral_estimators.spectral_norm import randomized_powering
from ..utils.checkers import _as_generator
from ..utils.linalg import hmm
from ..utils.profiling import annotate, annotate_sync, count, recording
from ..utils.rng import device_generator, fold_in

if TYPE_CHECKING:
    from ..models import LinSys


__all__ = ["SAP", "SAPState", "sap_accel_from_pilot"]


def sap_accel_from_pilot(
    rel_res: float, iters: int, n: int, blk_sz: int, safety: float = 0.9,
) -> SAPAccelConfig:
    """Accelerated-SAP (μ, ν) from a short plain-SAP pilot run.

    Plain SAP's measured per-iteration contraction ``c`` gives
    ``1 − c ≈ (blk_sz/n)·λ_min(P̄⁻¹Ā)``, the μ the accelerated recurrence
    wants, and ``ν = n/blk_sz``; μ is capped at ``safety/ν`` (μ·ν < 1 keeps
    the recurrence live). ``rel_res``: the pilot's final max relative
    residual; ``iters``: its iteration count.
    """
    if not (0.0 < rel_res < 1.0):
        raise ValueError(
            f"pilot rel_res must be in (0, 1), got {rel_res} — run enough "
            "pilot iterations for measurable contraction"
        )
    nu = n / blk_sz
    c = math.exp(math.log(rel_res) / max(iters, 1))
    mu = min(1.0 - c, safety / nu)
    return SAPAccelConfig(mu=float(mu), nu=float(nu))


VALID_PRECONDS = [IdentityConfig, NewtonConfig, NystromConfig]


class SAPState(NamedTuple):
    """The JAX package's fields in its order. ``key`` is what the draws come
    from: the solver generator's seed as two 32-bit words in an int64 (2,)
    tensor on the host, the layout of a JAX key (``PRNGKey(s)`` is ``[0, s]``
    for a seed below 2³², as here). It stays fixed: each step folds ``t``
    into it. A key read from a JAX checkpoint seeds the port's stream (the
    two streams differ by design)."""

    W: torch.Tensor
    V: torch.Tensor  # momentum term (W itself when accel=False)
    Y: torch.Tensor  # acceleration point (W itself when accel=False)
    key: torch.Tensor  # the seed of the draws, two 32-bit words
    t: int  # iteration counter (drives the block schedule and the draws)


def _key_of(gen: torch.Generator) -> torch.Tensor:
    """The state's ``key`` for the stream of ``gen``: its seed's two words."""
    seed = gen.initial_seed()
    return torch.tensor([seed >> 32, seed & 0xFFFFFFFF], dtype=torch.int64)


def _stream(key: torch.Tensor) -> torch.Generator:
    """A host generator seeded by the state's ``key`` (the inverse of
    :func:`_key_of`); the step's draws fold the iteration counter into it."""
    hi, lo = (int(w) & 0xFFFFFFFF for w in key.reshape(-1)[-2:])
    return torch.Generator().manual_seed(hi << 32 | lo)


class SAP(Solver):
    """SAP solver over a :class:`~rlaopt_tpu_torch.models.LinSys` system."""

    _BLK_DENSE_BUDGET = 512 << 20  # bytes: auto-materialization cap

    def __init__(
        self,
        system: "LinSys",
        W_init: torch.Tensor,
        precond_config: PreconditionerConfig,
        blk_sz: int,
        accel: bool,
        accel_config: SAPAccelConfig,
        power_iters: int,
        key=None,
        _block_schedule=None,
        blk_dense=None,
        sampling="auto",
        _draws: Optional[Callable] = None,
    ):
        self.system = system
        if type(precond_config) not in VALID_PRECONDS:
            raise TypeError(
                f"Valid preconditioner configs for SAP are {VALID_PRECONDS}, "
                f"but received {type(precond_config)}"
            )
        if system.A_row_oracle is None or system.A_blk_oracle is None:
            raise ValueError("SAP requires A_row_oracle and A_blk_oracle")
        self.precond_config = precond_config
        self.blk_sz = blk_sz
        self.accel = accel
        self.accel_config = accel_config
        self.power_iters = power_iters
        W0 = W_init[:, None] if W_init.ndim == 1 else W_init
        if self.accel:
            self.beta = 1 - (accel_config.mu / accel_config.nu) ** 0.5
            self.gamma = 1 / (accel_config.mu * accel_config.nu) ** 0.5
            self.alpha = 1 / (1 + self.gamma * accel_config.nu)
        self._block_schedule = (
            None if _block_schedule is None
            else torch.as_tensor(np.asarray(_block_schedule), device=W0.device)
        )
        self._draws = _draws
        self._blk_dense_fn = self._resolve_blk_dense(blk_dense, W0.dtype)
        # Host sampling draws each chunk's blocks with numpy (one upload per
        # chunk); "auto" takes it from n = 2**17 on, as the JAX package does,
        # where a device draw would sort n keys every step.
        n = system.A.shape[0]
        self._host_sampling = _block_schedule is None and (
            sampling == "host" or (sampling == "auto" and n >= (1 << 17))
        )
        self.state = SAPState(W=W0, V=W0, Y=W0, key=_key_of(_as_generator(key)), t=0)

    def _resolve_blk_dense(self, blk_dense, dtype):
        """The per-step block-tile materializer, or None.

        The block operator is applied ~power_iters + rank times a step; an
        oracle that can materialize K[blk, blk] (a bound method of an object
        with ``blk_dense``) does so once and the rest are dense products.
        None (auto) takes it when the tile fits the budget; True requires
        it; False never takes it.
        """
        if blk_dense is False:
            return None
        owner = getattr(self.system.A_blk_oracle, "__self__", None)
        fn = getattr(owner, "blk_dense", None)
        if fn is None:
            if blk_dense is True:
                raise ValueError(
                    "blk_dense=True requires the block oracle to expose a "
                    "dense materialization (e.g. a KernelLinOp.blk_oracle)"
                )
            return None
        tile_bytes = self.blk_sz * self.blk_sz * torch.finfo(dtype).bits // 8
        if blk_dense is None and tile_bytes > self._BLK_DENSE_BUDGET:
            return None
        return fn

    @property
    def W(self):
        return self.state.W

    # -- per-step pieces ------------------------------------------------------
    def _get_precond(self, blk_mm, dtype, device, gen, Omega=None, K_blk=None):
        """The block preconditioner: ``(apply_inv, exact)``."""
        reg = self.system.reg
        cfg = self.precond_config
        if isinstance(cfg, IdentityConfig):
            return (lambda x: x), False
        if isinstance(cfg, NewtonConfig):
            A_blk = K_blk if K_blk is not None else blk_mm(
                torch.eye(self.blk_sz, dtype=dtype, device=device)
            )
            L = newton_update(A_blk, cfg.rho)
            return (lambda x: newton_apply_inv(L, x)), cfg.rho == reg
        f = nystrom_update(
            blk_mm, self.blk_sz, cfg.rank, cfg.sketch, gen, dtype, device,
            Omega=Omega,
        )
        if cfg.damping_mode == _DampingMode.ADAPTIVE:
            rho = reg + f.S[-1]
        else:
            rho = torch.as_tensor(cfg.rho, dtype=dtype, device=device)
        L = nystrom_inv_chol(f.U, f.S, rho) if dtype != torch.float64 else None
        return (lambda x: nystrom_apply_inv(f, rho, x, L)), False

    def _get_stepsize(self, apply_inv, exact, blk_mm, dtype, device, gen, v0=None):
        if exact:
            return torch.ones((), dtype=dtype, device=device)
        reg = self.system.reg

        def mv(v):
            return apply_inv(blk_mm(v) + reg * v)

        S_op = LinOp((self.blk_sz, self.blk_sz), matvec=mv, dtype=dtype, device=device)
        max_eig, _ = randomized_powering(
            S_op, max_iters=self.power_iters, key=gen, v0=v0
        )
        return 1.0 / max_eig

    def _blk_products(self, blk):
        """``(Z ↦ A[blk, blk] @ Z, the dense tile or None)``."""
        if self._blk_dense_fn is not None:
            # one tile evaluation; the sketch and every power iteration
            # become dense products on the resident block
            count("rlaopt.sap.dense_blocks")
            K_blk = self._blk_dense_fn(blk)
            return (lambda Z: hmm(K_blk, Z)), K_blk
        blk_op = self.system.A_blk_oracle(blk)
        return (lambda Z: blk_op @ Z), None

    def _step_fn(self, state: SAPState, mask, blk) -> SAPState:
        W0 = state.W
        dtype, device = W0.dtype, W0.device
        reg = self.system.reg
        B = self.system.B
        g = fold_in(_stream(state.key), state.t)
        Omega, v0 = self._draws(state.t) if self._draws is not None else (None, None)
        with annotate("rlaopt.sap.precond", device):
            blk_mm, K_blk = self._blk_products(blk)
            apply_inv, exact = self._get_precond(
                blk_mm, dtype, device, fold_in(g, 1), Omega=Omega, K_blk=K_blk
            )
        with annotate("rlaopt.sap.stepsize", device):
            stepsize = self._get_stepsize(
                apply_inv, exact, blk_mm, dtype, device, fold_in(g, 2), v0=v0
            )

        eval_pt = state.Y if self.accel else state.W
        with annotate("rlaopt.sap.row_oracle", device):
            grad = self.system.A_row_oracle(blk) @ eval_pt + reg * eval_pt[blk] - B[blk]
        with annotate("rlaopt.sap.update", device):
            return self._update(state, mask, blk, apply_inv(grad), stepsize)

    def _update(self, state: SAPState, mask, blk, direction, stepsize) -> SAPState:
        # A degenerate block (failed factorization, divergent power
        # iteration) gives a non-finite direction: those columns skip the
        # update instead of poisoning the iterate.
        dir_ok = torch.all(torch.isfinite(direction), dim=0) & torch.isfinite(stepsize)
        if recording():
            count("rlaopt.sap.degenerate_blocks", torch.any(mask & ~dir_ok))
        mcol = (mask & dir_ok)[None, :]
        if self.accel:
            Wc = state.Y.index_add(0, blk, -stepsize * direction)
            W = torch.where(mcol, Wc, state.W)
            Vc = (self.beta * state.V + (1 - self.beta) * state.Y).index_add(
                0, blk, -stepsize * self.gamma * direction
            )
            V = torch.where(mcol, Vc, state.V)
            Y = torch.where(mcol, self.alpha * V + (1 - self.alpha) * W, state.Y)
            return SAPState(W=W, V=V, Y=Y, key=state.key, t=state.t + 1)
        W = torch.where(mcol, state.W.index_add(0, blk, -stepsize * direction), state.W)
        return SAPState(W=W, V=W, Y=W, key=state.key, t=state.t + 1)

    # -- sampling and chunks --------------------------------------------------
    def _sample_host_blocks(self, n_steps: int) -> torch.Tensor:
        """(n_steps, blk_sz) iid uniform without-replacement block draws,
        seeded from the state's key and the iteration counter, so a (key,
        chunk boundary) pair reproduces across runs."""
        n = self.system.A.shape[0]
        seed = _stream(self.state.key).initial_seed()
        rng = np.random.default_rng([seed, self.state.t])
        blks = np.empty((n_steps, self.blk_sz), dtype=np.int64)
        for i in range(n_steps):
            blks[i] = rng.choice(n, size=self.blk_sz, replace=False)
        device = self.state.W.device
        with annotate_sync("rlaopt.sync.sap_blocks", device):
            return torch.from_numpy(blks).to(device)

    def _device_block(self, t: int) -> torch.Tensor:
        n = self.system.A.shape[0]
        device = self.state.W.device
        gen = device_generator(fold_in(_stream(self.state.key), t), device)
        return torch.randperm(n, generator=gen, device=device)[: self.blk_sz]

    def _step(self):
        self._run_chunk(1)

    def _run_chunk(self, n_steps: int):
        blks = self._sample_host_blocks(n_steps) if self._host_sampling else None
        mask = self.system.mask
        for i in range(n_steps):
            t = self.state.t
            if blks is not None:
                blk = blks[i]
            elif self._block_schedule is not None:
                blk = self._block_schedule[t % self._block_schedule.shape[0]]
            else:
                blk = self._device_block(t)
            count("rlaopt.sap.steps")
            with annotate("rlaopt.sap.step", self.state.W):
                self.state = self._step_fn(self.state, mask, blk)
