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
rollbacks so far.

Telemetry rides the loop through one spine (``obs/``), in the JAX
trainer's order: ``epoch_start`` and ``epoch_end`` phases, the goodput
ledger around the batch iterator (``ledger.wrap_batches``) and at each
dispatch (``begin_step``), a ``train/step`` span per step with its
``train/host_sync``, ``train/snapshot`` and ``train/checkpoint``
children, the step marker ``train#<step>`` around the dispatch, one
``emitter.step`` record every step with the host's step time ``dt`` (the
loss, ``steps_per_sec`` and ``skipped_total`` join at log points), the
flight recorder's ``check_step``, the ``mfu_live`` gauge and the
ledger's gauges at log points, ``slo.evaluate`` after every step, the
restart watermark (``note_progress``), the saves inside ``ckpt_save``
brackets and a ``preemption`` anomaly before the preemption exit.  None
of it reads the device: the values it records at a log point are the
ones that point reads anyway.  ``cost_report`` (set by the CLI's flop
probe) is completed after the first step with the collective census of
that step and the allocator's peaks and emitted as ``compiled_cost``.
A profile window (``profile_steps``, global steps ``[start, stop)``)
captures once, with ``utils.profiling``'s ``torch.profiler`` session,
and is cut at the end of the data; closing it waits for the card once,
so the trace holds the device work of the steps it brackets.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from collections import deque
from typing import Any, Callable, Iterable

from ..comm import collectives
from ..comm.init import process_count
from ..comm.mesh import BATCH_AXES
from ..data.loader import prefetch_to_device, to_device
from ..obs.cost import collective_census, memory_stats, mfu, step_cost_report
from ..obs.trace import step_annotation
from ..resilience.preemption import Preempted
from ..utils import profiling
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
    profile_dir: str | None = None   # torch.profiler trace destination
    # (start, stop) GLOBAL step window to capture, [start, stop); None
    # with profile_dir set: the caller brackets the epoch itself.
    profile_steps: tuple[int, int] | None = None


class Trainer:
    """Runs ``train_step`` over batches on ``device``.  ``faults``
    (``resilience.FaultInjector``), ``preemption``
    (``resilience.PreemptionHandler``), ``checkpoint_fn(state, wait)``
    and ``recovery`` (``resilience.RecoveryManager``) are the resilience
    hooks; ``emitter`` (``obs.MetricsEmitter``), ``spans``
    (``obs.SpanRecorder``), ``anatomy`` (the attributes of every
    ``train/step`` span: what one step holds), ``slo``
    (``obs.SLOPolicy``) and ``ledger`` (``obs.GoodputLedger``) the
    telemetry hooks (module docstring).  Each is optional and costs
    nothing when absent; the step marker's range is opened on every
    step (a few µs of host time)."""

    def __init__(self, state: TrainState,
                 train_step: Callable[[TrainState, Any], tuple[TrainState, dict]],
                 device, config: TrainerConfig | None = None, *,
                 faults=None, preemption=None,
                 checkpoint_fn: Callable[..., None] | None = None,
                 recovery=None, emitter=None, spans=None, anatomy=None,
                 slo=None, ledger=None):
        self.state = state
        self.train_step = train_step
        self.device = device
        self.config = config or TrainerConfig()
        self.faults = faults
        self.preemption = preemption
        self.checkpoint_fn = checkpoint_fn
        self.recovery = recovery
        self.emitter = emitter
        self.spans = spans
        self.anatomy = dict(anatomy) if anatomy else {}
        self.slo = slo
        self.ledger = ledger
        self.recorder = None
        if emitter is not None and emitter.enabled:
            from ..obs import FlightRecorder

            self.recorder = FlightRecorder(emitter)
        # The flop probe's report, completed and emitted after the first
        # step (module docstring); its FLOPs and the card's peak feed the
        # mfu_live gauge.
        self.cost_report: dict | None = None
        self.step_flops: float | None = None
        self.peak_flops: float | None = None
        self._recent_dts: deque = deque(maxlen=32)
        self.history: list[dict] = []
        self.last_epoch_losses: list[float] = []
        self._global_step = state.step
        self._profiling = False
        self._profile_done = False   # a window captures once, ever
        # Host mirror of the skip counter, updated at log points: the
        # flight recorder flags the delta since the last one.
        self._skipped_seen = 0

    # ---- profile window (profile_steps) --------------------------------

    def _profile_tick(self, heartbeat) -> None:
        """Start the step-window capture at its first global step; beat
        the heartbeat on every captured step."""
        cfg = self.config
        if cfg.profile_dir is None or cfg.profile_steps is None \
                or self._profile_done:
            return
        start, stop = cfg.profile_steps
        if not self._profiling and start <= self._global_step < stop:
            profiling.start_trace(cfg.profile_dir)
            self._profiling = True
            if self.emitter is not None:
                self.emitter.phase("profile_start", step=self._global_step)
        if self._profiling and heartbeat is not None:
            heartbeat.beat()

    def _profile_stop_if_done(self) -> None:
        cfg = self.config
        if not self._profiling or cfg.profile_steps is None:
            return
        if self._global_step + 1 >= cfg.profile_steps[1]:
            profiling.stop_trace()
            self._profiling = False
            self._profile_done = True
            if self.emitter is not None:
                self.emitter.phase("profile_stop", step=self._global_step)

    def _finalize_profile(self) -> None:
        # The window ran past the epoch's data (or an exception landed
        # here): close the capture and retire the window.
        if self._profiling:
            profiling.stop_trace()
            self._profiling = False
            self._profile_done = True
            if self.emitter is not None:
                self.emitter.phase("profile_stop", step=self._global_step,
                                   truncated=True)

    def _emit_cost(self, tally: dict) -> None:
        """Complete the probe's report with the first step's census and
        the allocator's peaks (host reads, no device sync) and emit it."""
        report, self.cost_report = self.cost_report, None
        if "error" not in report:
            report = step_cost_report(
                report["flops"], peak_flops=report.get("peak_flops"),
                memory=memory_stats(self.device),
                collectives=collective_census(tally))
            self.step_flops = report["flops"]
            self.peak_flops = report["peak_flops"]
        self.emitter.emit("compiled_cost", report)

    def _bracket(self, category: str):
        return (self.ledger.bracket(category) if self.ledger is not None
                else contextlib.nullcontext())

    def run_epoch(self, loader: Iterable, *, epoch: int = 0) -> dict:
        cfg = self.config
        if cfg.prefetch > 0:
            it = prefetch_to_device(loader, self.device, size=cfg.prefetch)
        else:
            it = (to_device(b, self.device) for b in loader)
        if self.ledger is not None:
            # Outside the prefetch: a pull that blocks here is input the
            # pipeline could not hide — what data_wait charges.
            it = self.ledger.wrap_batches(it)
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
        if self.emitter is not None:
            self.emitter.phase("epoch_start", epoch=epoch)
        spans = self.spans
        t0 = time.perf_counter()
        prev_tick = t0
        try:
            for step_idx, batch in enumerate(it):
                self._profile_tick(heartbeat)
                if self.faults is not None:
                    # May stall without beating, SIGTERM this process or
                    # end it outright (resilience/faults.py).
                    batch = self.faults.on_step(self._global_step, batch)
                sspan = (spans.start_span("train/step",
                                          corr=self._global_step,
                                          **self.anatomy)
                         if spans is not None else None)
                census = self.cost_report is not None
                if census:
                    collectives.census_start()
                with step_annotation(self._global_step):
                    self.state, metrics = self.train_step(self.state, batch)
                if census:
                    self._emit_cost(collectives.census_stop())
                batch_size = int(next(iter(batch.values())).shape[0]) * world
                examples += batch_size
                timer.tick()  # dispatch rate, no device sync
                now = time.perf_counter()
                if self.ledger is not None:
                    # Classify batch-ready..dispatch and the host tail:
                    # compile for the first step, rework under a restart
                    # watermark, else the grad_sync/step_compute split.
                    self.ledger.begin_step(self._global_step)
                step_fields: dict = {"dt": now - prev_tick}
                prev_tick = now
                self._recent_dts.append(step_fields["dt"])
                if step_idx % cfg.log_every == 0:
                    if heartbeat is not None:
                        heartbeat.beat()
                    # The host waits for the device only here.
                    hspan = (spans.start_span("train/host_sync",
                                              corr=self._global_step,
                                              parent=sspan)
                             if spans is not None else None)
                    last_metrics = {k: float(v) for k, v in metrics.items()}
                    if spans is not None:
                        spans.end_span(hspan)
                    loss = last_metrics["loss"]
                    losses.append(loss)
                    last_logged_step = step_idx
                    step_fields["loss"] = loss
                    step_fields["steps_per_sec"] = timer.steps_per_sec
                    skipped_delta = None
                    if "skipped_total" in last_metrics:
                        total_skips = int(last_metrics["skipped_total"])
                        skipped_delta = total_skips - self._skipped_seen
                        self._skipped_seen = total_skips
                        step_fields["skipped_total"] = total_skips
                    if self.recorder is not None:
                        self.recorder.check_step(self._global_step, {
                            "loss": loss,
                            "grad_norm": last_metrics.get("grad_norm"),
                            "skipped": skipped_delta,
                            "dt": step_fields["dt"],
                        })
                    if (self.emitter is not None and self.step_flops
                            and self.peak_flops):
                        # Live MFU: the probe's FLOPs over the median of
                        # the recent host step times.
                        live = mfu(self.step_flops,
                                   statistics.median(self._recent_dts),
                                   self.peak_flops)
                        if live is not None:
                            self.emitter.gauge("mfu_live", live)
                    if self.ledger is not None and self.emitter is not None:
                        self.ledger.emit_gauges(self.emitter)
                    if self.recovery is not None and "bad_streak" in metrics:
                        # Rollback or abort at log cadence: every bad step
                        # in between was a no-op update by construction.
                        self.state = self.recovery.observe(
                            self.state, self._global_step,
                            int(last_metrics["bad_streak"]))
                if self.emitter is not None:
                    self.emitter.observe("step_time_s", step_fields["dt"])
                    self.emitter.step(self._global_step, **step_fields)
                if self.slo is not None:
                    self.slo.evaluate()
                self._profile_stop_if_done()
                self._global_step += 1
                if self.ledger is not None:
                    # The next attempt's restart-rework watermark.
                    self.ledger.note_progress(self._global_step)
                if self.recovery is not None:
                    # The host snapshot at its own cadence (waits for the
                    # state's in-flight computation).
                    snap = (spans.start_span("train/snapshot", parent=sspan)
                            if sspan is not None else None)
                    self.recovery.maybe_stage(self.state, self._global_step)
                    if spans is not None:
                        spans.end_span(snap)
                if self.preemption is not None and self.preemption.triggered:
                    # SIGTERM landed during this step: commit a synchronous
                    # step checkpoint at this boundary, then leave with the
                    # distinct preemption exit (the CLI's exit 75).
                    if heartbeat is not None:
                        heartbeat.beat()  # cover the blocking save
                    saved = self.checkpoint_fn is not None
                    if saved:
                        with self._bracket("ckpt_save"):
                            self.checkpoint_fn(self.state, wait=True)
                    if self.emitter is not None:
                        self.emitter.anomaly(
                            "preemption", step=self._global_step,
                            checkpointed=saved)
                    raise Preempted(self._global_step, saved)
                if (cfg.checkpoint_every_steps
                        and self.checkpoint_fn is not None
                        and self._global_step % cfg.checkpoint_every_steps
                        == 0):
                    # Async: staging is enqueued on the device, the write
                    # overlaps the following steps.
                    cspan = (spans.start_span("train/checkpoint",
                                              parent=sspan)
                             if sspan is not None else None)
                    with self._bracket("ckpt_save"):
                        self.checkpoint_fn(self.state, wait=False)
                    if spans is not None:
                        spans.end_span(cspan)
                    if heartbeat is not None:
                        heartbeat.beat()
                if spans is not None:
                    spans.end_span(sspan)
        finally:
            self._finalize_profile()
            if spans is not None:
                spans.flush()
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
        if self.emitter is not None:
            self.emitter.phase("epoch_end", epoch=epoch, examples=examples,
                               elapsed_s=elapsed)
        return summary
