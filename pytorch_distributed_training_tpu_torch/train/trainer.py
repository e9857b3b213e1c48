"""Epoch loop: the core of the JAX package's ``train/trainer.py``.

Drives the train step over a batch iterator with ``prefetch`` batches in
flight on the device, logs the loss every ``log_every`` steps and reads
values back from the device only there and once at the end of the epoch
(the closing fetch, which also closes the timing window: every step's
state chains into the last loss).  Between log points steps are only
enqueued, never waited for.  The epoch summary has the JAX trainer's keys:
``epoch, step, elapsed_s, examples, examples_per_sec,
rolling_examples_per_sec, loss``, then the step's other metrics as read at
the last log point (an image classifier's ``accuracy``).  Under data
parallelism the batch a rank holds is its share of the global one:
examples count the global batch, as the JAX trainer's global arrays do.

The telemetry emitter, spans, fault injection, recovery, preemption,
goodput ledger, profile windows and step checkpoints wait for their
slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

from ..comm.init import process_count
from ..data.loader import prefetch_to_device, to_device
from ..utils.profiling import StepTimer
from .state import TrainState


@dataclasses.dataclass
class TrainerConfig:
    log_every: int = 50
    prefetch: int = 2        # batches kept in flight on device (0 disables)


class Trainer:
    """Runs ``train_step`` over batches on ``device``."""

    def __init__(self, state: TrainState,
                 train_step: Callable[[TrainState, Any], tuple[TrainState, dict]],
                 device, config: TrainerConfig | None = None):
        self.state = state
        self.train_step = train_step
        self.device = device
        self.config = config or TrainerConfig()
        self.history: list[dict] = []
        self.last_epoch_losses: list[float] = []
        self._global_step = state.step

    def run_epoch(self, loader: Iterable, *, epoch: int = 0) -> dict:
        cfg = self.config
        if cfg.prefetch > 0:
            it = prefetch_to_device(loader, self.device, size=cfg.prefetch)
        else:
            it = (to_device(b, self.device) for b in loader)
        examples = 0
        losses: list[float] = []
        timer = StepTimer()
        batch_size = 0
        world = process_count()
        metrics: dict | None = None
        last_metrics: dict = {}
        step_idx = -1
        last_logged_step = -1
        t0 = time.perf_counter()
        for step_idx, batch in enumerate(it):
            self.state, metrics = self.train_step(self.state, batch)
            batch_size = int(next(iter(batch.values())).shape[0]) * world
            examples += batch_size
            timer.tick()  # dispatch rate, no device sync
            if step_idx % cfg.log_every == 0:
                # The host waits for the device only here.
                last_metrics = {k: float(v) for k, v in metrics.items()}
                losses.append(last_metrics["loss"])
                last_logged_step = step_idx
            self._global_step += 1
        if examples:
            # The closing fetch: completes only after all device work has.
            final_loss = float(metrics["loss"])
            if last_logged_step != step_idx:
                losses.append(final_loss)
        elapsed = time.perf_counter() - t0
        summary = {
            "epoch": epoch,
            "step": self._global_step,
            "elapsed_s": elapsed,
            "examples": examples,
            "examples_per_sec": examples / elapsed if elapsed > 0 else 0.0,
            "rolling_examples_per_sec": timer.examples_per_sec(batch_size),
            "loss": losses[-1] if losses else float("nan"),
            **{k: v for k, v in last_metrics.items() if k != "loss"},
        }
        self.history.append(summary)
        self.last_epoch_losses = losses
        return summary
