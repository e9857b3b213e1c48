"""Host-side recovery: last-good snapshots, rollback, escalation.  The
counterpart of the JAX package's ``resilience/recovery.py``.

The skip gate (``anomaly.guarded_apply``) never applies a *detected* bad
update, so the live state is always the last good one at the moment it
was written.  What it cannot undo is a state that went bad undetected (a
spike under the threshold that saturated the optimizer's moments, after
which every gradient trips the gate), nor make progress when every step
is skipped.  That escalation is the host's:

1. **snapshot**: every ``snapshot_every_steps`` global steps the manager
   stages a host copy of the learned state (parameters, optimizer state
   with its counts, ``batch_stats``, the two-tier sync's error-feedback
   residual).  Staging waits for the state's in-flight computation: that
   pause is its cost.
2. **rollback**: when the device-side bad streak reaches
   ``rollback_after`` (read at the trainer's log points, where the host
   waits anyway), the snapshot is copied back into the live tensors, the
   streak resets (``skipped_total`` does not), and training continues on
   the next batches.
3. **abort**: past ``max_rollbacks`` rollbacks in one process it raises
   :class:`RecoveryAborted`, a nonzero exit that the supervisor
   (``--elastic``) relaunches from the last committed checkpoint,
   charging ``--max-restarts``.

Rollbacks and the abort are anomaly events on the telemetry emitter
(``emitter``, ``--metrics-dir``), as in JAX; with no emitter live they
are printed to stderr.  The goodput ledger (``ledger``, ``--goodput``)
re-classifies a rollback's discarded steps as ``rework`` and charges the
restore to ``ckpt_restore``; a snapshot retires the window below it.
The trainer's epoch summary counts the rollbacks.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from ..checkpoint.manager import flatten_state, set_counters, split_counters


class RecoveryAborted(RuntimeError):
    """Raised after the rollback budget is exhausted."""


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    rollback_after: int = 8       # K consecutive skipped steps -> rollback
    max_rollbacks: int = 2        # R rollbacks -> abort
    snapshot_every_steps: int = 200


class RecoveryManager:
    def __init__(self, config: RecoveryConfig | None = None, *, emitter=None,
                 ledger=None):
        self.config = config or RecoveryConfig()
        self.emitter = emitter
        self.ledger = ledger
        self.rollbacks = 0
        self.stage_seconds: list[float] = []   # each staging's host time
        self._snapshot: tuple[dict, dict, object] | None = None
        self._snapshot_step: int | None = None
        self._last_stage_step: int | None = None

    # ---- snapshot -------------------------------------------------------

    def maybe_stage(self, state, global_step: int) -> None:
        """Stage a host copy at the configured cadence (and at the first
        opportunity).  The skip gate keeps the live state applied-good, so
        no health check is needed before staging."""
        if self._last_stage_step is not None and (
                global_step - self._last_stage_step
                < self.config.snapshot_every_steps):
            return
        self.stage(state, global_step)

    def stage(self, state, global_step: int) -> None:
        t0 = time.perf_counter()
        tensors, counters = split_counters(*flatten_state(state))
        residual = state.grad_sync_residual
        self._snapshot = (
            {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()},
            {n: int(v) for n, v in counters.items()
             if not n.startswith("resilience/")},
            residual.to("cpu", copy=True)
            if isinstance(residual, torch.Tensor) else residual,
        )
        self._snapshot_step = global_step
        self._last_stage_step = global_step
        self.stage_seconds.append(time.perf_counter() - t0)
        if self.ledger is not None:
            self.ledger.note_snapshot(global_step)

    # ---- rollback / abort ----------------------------------------------

    def observe(self, state, global_step: int, bad_streak: int):
        """React to the device-side streak (read at a log point).  Returns
        the state, rolled back when the streak reached ``rollback_after``;
        raises :class:`RecoveryAborted` past the rollback budget."""
        if bad_streak < self.config.rollback_after or self._snapshot is None:
            return state
        if self.rollbacks >= self.config.max_rollbacks:
            if self.emitter is not None:
                self.emitter.anomaly(
                    "recovery_abort", step=global_step,
                    rollbacks=self.rollbacks, bad_streak=bad_streak)
            else:
                print(f"recovery: abort at step {global_step} (bad streak "
                      f"{bad_streak}, {self.rollbacks} rollbacks)",
                      file=sys.stderr, flush=True)
            raise RecoveryAborted(
                f"{bad_streak} consecutive bad steps at step {global_step} "
                f"after {self.rollbacks} rollbacks — aborting for a "
                "supervised restart from the last committed checkpoint")
        self.rollbacks += 1
        if self.emitter is not None:
            self.emitter.anomaly(
                "rollback", step=global_step, bad_streak=bad_streak,
                snapshot_step=self._snapshot_step, rollback=self.rollbacks)
        else:
            print(f"recovery: rollback {self.rollbacks} at step "
                  f"{global_step} to the snapshot of step "
                  f"{self._snapshot_step} (bad streak {bad_streak}; the "
                  f"snapshot staged in {self.stage_seconds[-1] * 1e3:.2f} "
                  "ms)", file=sys.stderr, flush=True)
        if self.ledger is not None:
            # The updates of [snapshot_step, global_step] are discarded:
            # their charged wall time moves to rework, and the restore
            # is a ckpt_restore interval.
            self.ledger.note_rollback(self._snapshot_step, global_step)
            with self.ledger.bracket("ckpt_restore"):
                return self._restore(state)
        return self._restore(state)

    def _restore(self, state):
        tensors, counters, residual = self._snapshot
        live = split_counters(*flatten_state(state))[0]
        with torch.no_grad():
            for name, t in live.items():
                t.copy_(tensors[name])
            if isinstance(residual, torch.Tensor):
                state.grad_sync_residual.copy_(residual)
        # Reset ONLY the streak: the restored state is good by
        # construction, and a stale streak would re-trip the next check.
        # ``skipped_total`` counts the run's skips; the trainer reads it
        # as is.  The step stays live: the data order marches on.
        skipped = int(state.resilience.skipped_total)
        restored = set_counters(state, {
            **counters, "step": state.step,
            "resilience/skipped_total": skipped})
        return restored
