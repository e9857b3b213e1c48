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
examples count the global batch, as the JAX trainer's global arrays do
(a sharded state's batch axes, the ranks that hold different rows: fewer
than the world when tensor, sequence or pipeline ranks share rows).

The resilience hooks are the JAX trainer's, in its order within a step:
the fault plane (``faults.on_step``) before the step dispatches; then,
after it, the preemption latch (a synchronous ``checkpoint_fn(state,
wait=True)`` and :class:`~..resilience.Preempted`), then the step
checkpoint cadence (``checkpoint_every_steps``: an async
``checkpoint_fn(state, wait=False)`` when the global step is a multiple).
The supervisor's heartbeat (``Heartbeat.from_env``) beats at the epoch's
start, at log points and around saves.  Under the skip gate
(``recovery``, a ``resilience.RecoveryManager``) the device's bad streak
is read at log points only, where the host waits anyway, and may roll the
state back or abort; after each step the manager stages its host
snapshot at its own cadence; the summary carries the gate's metrics as
read at the last log point (``skipped_total`` among them) and the
rollbacks so far.  The telemetry emitter, spans, goodput ledger and
profile windows wait for their slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

from ..comm.init import process_count
from ..comm.mesh import BATCH_AXES
from ..data.loader import prefetch_to_device, to_device
from ..resilience.preemption import Preempted
from ..utils.profiling import StepTimer
from ..utils.supervisor import Heartbeat
from .state import TrainState


@dataclasses.dataclass
class TrainerConfig:
    log_every: int = 50
    prefetch: int = 2        # batches kept in flight on device (0 disables)
    # Mid-epoch checkpoint cadence (global steps): an async step-granular
    # save through ``checkpoint_fn`` every N steps, so a preemption or
    # crash loses at most N steps.
    checkpoint_every_steps: int | None = None


class Trainer:
    """Runs ``train_step`` over batches on ``device``.  ``faults``
    (``resilience.FaultInjector``), ``preemption``
    (``resilience.PreemptionHandler``), ``checkpoint_fn(state, wait)``
    and ``recovery`` (``resilience.RecoveryManager``) are the resilience
    hooks (module docstring)."""

    def __init__(self, state: TrainState,
                 train_step: Callable[[TrainState, Any], tuple[TrainState, dict]],
                 device, config: TrainerConfig | None = None, *,
                 faults=None, preemption=None,
                 checkpoint_fn: Callable[..., None] | None = None,
                 recovery=None):
        self.state = state
        self.train_step = train_step
        self.device = device
        self.config = config or TrainerConfig()
        self.faults = faults
        self.preemption = preemption
        self.checkpoint_fn = checkpoint_fn
        self.recovery = recovery
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
        layout = self.state.shardings
        world = (process_count() if layout is None
                 else layout.mesh.axes_size(BATCH_AXES))
        metrics: dict | None = None
        last_metrics: dict = {}
        step_idx = -1
        last_logged_step = -1
        # Liveness for the elastic supervisor: beat at the epoch's start
        # (covers the first batch's load), at log points and around saves.
        heartbeat = Heartbeat.from_env()
        if heartbeat is not None:
            heartbeat.beat()
        t0 = time.perf_counter()
        for step_idx, batch in enumerate(it):
            if self.faults is not None:
                # May stall without beating, SIGTERM this process or end
                # it outright (resilience/faults.py).
                batch = self.faults.on_step(self._global_step, batch)
            self.state, metrics = self.train_step(self.state, batch)
            batch_size = int(next(iter(batch.values())).shape[0]) * world
            examples += batch_size
            timer.tick()  # dispatch rate, no device sync
            if step_idx % cfg.log_every == 0:
                if heartbeat is not None:
                    heartbeat.beat()
                # The host waits for the device only here.
                last_metrics = {k: float(v) for k, v in metrics.items()}
                losses.append(last_metrics["loss"])
                last_logged_step = step_idx
                if self.recovery is not None and "bad_streak" in metrics:
                    # Rollback or abort at log cadence: every bad step in
                    # between was a no-op update by construction.
                    self.state = self.recovery.observe(
                        self.state, self._global_step,
                        int(last_metrics["bad_streak"]))
            self._global_step += 1
            if self.recovery is not None:
                # The host snapshot at its own cadence (waits for the
                # state's in-flight computation).
                self.recovery.maybe_stage(self.state, self._global_step)
            if self.preemption is not None and self.preemption.triggered:
                # SIGTERM landed during this step: commit a synchronous
                # step checkpoint at this boundary, then leave with the
                # distinct preemption exit (the CLI's exit 75).
                if heartbeat is not None:
                    heartbeat.beat()  # cover the blocking save
                saved = self.checkpoint_fn is not None
                if saved:
                    self.checkpoint_fn(self.state, wait=True)
                raise Preempted(self._global_step, saved)
            if (cfg.checkpoint_every_steps and self.checkpoint_fn is not None
                    and self._global_step % cfg.checkpoint_every_steps == 0):
                # Async: staging is enqueued on the device, the write
                # overlaps the following steps.
                self.checkpoint_fn(self.state, wait=False)
                if heartbeat is not None:
                    heartbeat.beat()
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
            **({"rollbacks": self.recovery.rollbacks}
               if self.recovery is not None else {}),
        }
        self.history.append(summary)
        self.last_epoch_losses = losses
        return summary
