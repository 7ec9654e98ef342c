"""Iteration logger with wall-clock timing and optional wandb.

Port of ``rlaopt_tpu/utils/logger.py``: frequency-gated logging with
per-round and cumulative wall-clock time, and ``wandb.init``/``log``/
``finish`` when asked. The timer synchronizes the CUDA device before it
reads the clock, so the times are device time and not enqueue time. The
clock is ``time.perf_counter``, the monotonic clock of the program's spans
(:mod:`rlaopt_tpu_torch.utils.profiling`).
"""

import time
from typing import Any, Callable, Optional

import torch

from .profiling import annotate_sync

__all__ = ["Logger"]


class Logger:
    """Frequency-gated metrics logger.

    Args:
        log_freq: Log every ``log_freq`` iterations.
        log_fn: Called as ``log_fn(w)``; returns the metrics dict.
        wandb_kwargs: If not None, ``wandb.init(**wandb_kwargs)`` is called
            (``wandb`` imported here, not before) and every log round is
            mirrored to wandb.
    """

    def __init__(
        self,
        log_freq: int,
        log_fn: Callable,
        wandb_kwargs: Optional[dict] = None,
    ):
        self.log_freq = log_freq
        self.log_fn = log_fn

        if wandb_kwargs is not None:
            import wandb

            self._wandb = wandb
            self.log_in_wandb = True
            wandb.init(**wandb_kwargs)
        else:
            self._wandb = None
            self.log_in_wandb = False

        self.start_time = time.perf_counter()
        self.iter_time = 0.0
        self.cum_time = 0.0

    def _reset_timer(self):
        self.start_time = time.perf_counter()

    def _update_cum_time(self):
        self.iter_time = time.perf_counter() - self.start_time
        self.cum_time += self.iter_time

    def _compute_log(self, i: int, *args: Any, force: bool = False, **kwargs: Any):
        """The log dict for iteration ``i`` (None off-frequency).

        ``force=True`` logs regardless of frequency, for the final iteration
        when ``max_iters`` is not a multiple of ``log_freq``.
        """
        if i % self.log_freq != 0 and not force:
            return None
        if args and isinstance(args[0], torch.Tensor) and args[0].is_cuda:
            with annotate_sync("rlaopt.sync.logger", args[0]):
                torch.cuda.synchronize(args[0].device)
        self._update_cum_time()
        metrics = self.log_fn(*args, **kwargs)
        log_dict = {"iter_time": self.iter_time, "cum_time": self.cum_time}
        log_dict["metrics"] = metrics

        if self.log_in_wandb:
            self._wandb.log(log_dict, step=i)

        self._reset_timer()
        return log_dict

    def _terminate(self):
        if self.log_in_wandb:
            self._wandb.finish()
