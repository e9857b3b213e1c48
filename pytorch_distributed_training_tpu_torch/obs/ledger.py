"""Training goodput ledger: exhaustive wall-clock attribution per rank.

Every second of a training run is classified into exactly one of
:data:`CATEGORIES` — compile, step_compute, grad_sync (split ICI/DCN via
the analytic per-fabric wall model), data_wait, ckpt_save, ckpt_restore,
rework (steps re-executed after an anomaly rollback or a crash restart,
charged retroactively on restore), supervisor_backoff, other — with the
pinned identity ``sum(categories) == wall_clock`` EXACT per rank.

The exactness is an integer-nanosecond design, not a tolerance: the
ledger never accumulates floats.  Each boundary reads the clock once,
converts to int ns, and charges the full ``now - last`` delta to exactly
one category (or, for a step interval, splits it into integer parts that
sum back to the delta).  The total is then a telescoping sum: category
ns add up to ``final_now - t0`` (plus the inherited backoff), bit-exact,
on every platform.

The port's own copy of the JAX package's ``obs/ledger.py``, with its
categories.  How the trainer feeds it (train/trainer.py; every hook is None-guarded
so a run without ``--goodput`` pays nothing):

- :meth:`wrap_batches` brackets the iterator pull: the pull interval is
  ``data_wait``; the interval from batch-ready through dispatch (where
  the host blocks on the device's queue — i.e. on device compute, at
  steady state) plus the post-dispatch host tail belongs to the step.
- :meth:`begin_step` classifies the step interval: the first dispatched
  step is ``compile``.  The port compiles nothing at run time (its
  kernels are built before the step), but its first step pays the
  one-time costs all the same: creating the cuBLAS and cuDNN handles,
  cuDNN's algorithm search, loading the built kernel libraries and the
  caching allocator's first blocks; a
  step below the restart watermark (:meth:`set_rework_until`) or marked
  by a rollback is ``rework``; anything else splits ``grad_sync`` vs
  ``step_compute`` against the per-step analytic quota
  (:meth:`set_grad_sync_model` — the obs/cost.py wall model), which
  also yields the ICI/DCN sub-split.
- :meth:`bracket` charges checkpoint saves/restores and the CLI's
  flop probe (``compiled_cost``) explicitly.
- rollback (resilience/recovery.py): :meth:`note_rollback` moves the
  recorded per-step charges of the discarded steps (snapshot..current)
  from ``step_compute``/``grad_sync`` into ``rework`` — the work was
  spent and then thrown away, so it is re-classified, never re-counted.
- restart: the trainer records the last completed global step through
  :meth:`note_progress`; the resumed process reads it back
  (:meth:`read_progress`) and classifies the re-executed steps
  ``[restored_step, progress)`` as ``rework``.
- supervisor backoff: ``utils/supervisor.py`` exports the cumulative
  crash-backoff seconds it slept into :data:`BACKOFF_ENV` before each
  relaunch; the child's ledger charges them to ``supervisor_backoff``
  and widens its wall clock by the same amount, so the identity holds
  for the resumed run as a whole.

:func:`fleet_ledger` merges per-rank records: categories sum across
ranks, the fleet wall is ``n_ranks x max(rank wall)``, and the residual
(each rank's gap to the slowest) is ``idle_gap``, attributed to the
straggler rank — the collective-wait time only the slowest rank causes.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterable, Iterator

# Cumulative crash-backoff seconds the supervisor slept before launching
# this process.  The name lives with its writer (utils/supervisor.py,
# which must stay importable without the obs package); re-exported here
# so ledger consumers need only one import.
from ..utils.supervisor import BACKOFF_ENV

# Mutually exclusive wall-clock categories; ``sum == wall`` is pinned.
CATEGORIES = (
    "compile",
    "step_compute",
    "grad_sync",
    "data_wait",
    "ckpt_save",
    "ckpt_restore",
    "rework",
    "supervisor_backoff",
    "other",
)

# Step-interval classes (a step interval is everything from batch-ready
# through dispatch plus the post-dispatch host tail).
_STEP_CLASSES = ("compile", "step_compute", "rework")

# Per-step charge records kept for retroactive rollback re-classification
# are pruned against the recovery snapshot cadence (note_snapshot); this
# cap only bounds memory when no recovery plane ever prunes.
_MAX_STEP_RECORDS = 4096


def _ns(seconds: float) -> int:
    return int(round(seconds * 1e9))


class GoodputLedger:
    """One rank's exhaustive wall-clock attribution (integer ns)."""

    def __init__(
        self,
        *,
        clock=time.monotonic,
        progress_path: str | None = None,
        inherited_backoff_s: float | None = None,
    ):
        self.clock = clock
        now = _ns(clock())
        self._t0_ns = now
        self._last_ns = now
        self._final_ns: int | None = None
        self.totals_ns: dict[str, int] = {cat: 0 for cat in CATEGORIES}
        self.grad_sync_ici_ns = 0
        self.grad_sync_dcn_ns = 0
        if inherited_backoff_s is None:
            inherited_backoff_s = float(os.environ.get(BACKOFF_ENV, 0) or 0)
        self.inherited_backoff_ns = max(_ns(inherited_backoff_s), 0)
        # Backoff happened before this process existed: it widens the
        # wall clock AND its category by the same integer, so the
        # identity holds from the first snapshot on.
        self.totals_ns["supervisor_backoff"] += self.inherited_backoff_ns
        # What the currently-elapsing interval will be charged to: a
        # category name, or "step" for a step interval (split on charge).
        self._pending = "other"
        self._pending_step: int | None = None
        self._pending_class: str | None = None
        # Analytic grad-sync quota per step (obs/cost.py wall model): the
        # integer-ns budget each step interval's charge consumes before
        # the remainder lands in step_compute.
        self._gs_quota_ns = 0
        self._gs_quota_ici_ns = 0
        self._quota_ici_left = 0
        self._quota_dcn_left = 0
        self.grad_sync_model: dict[str, Any] | None = None
        # Retroactive rework bookkeeping.
        self._rework_until = 0
        self._rework_steps: set[int] = set()
        self._step_charges: dict[int, dict[str, int]] = {}
        self.step_intervals = {cls: 0 for cls in _STEP_CLASSES}
        self._first_step_seen = False
        # Restart-rework progress file (last completed global step).
        self.progress_path = progress_path
        self._progress_file = None

    # ---- core accounting ------------------------------------------------

    def _charge(self, ns: int) -> None:
        """Charge ``ns`` to the pending category; integer parts of a step
        interval split to grad_sync (ICI/DCN) + step_compute and sum back
        to ``ns`` exactly."""
        if ns <= 0:
            return
        if self._pending != "step":
            self.totals_ns[self._pending] += ns
            return
        step, cls = self._pending_step, self._pending_class
        if cls != "step_compute":
            # compile / rework intervals take the whole charge.
            self.totals_ns[cls] += ns
            return
        gi = min(ns, self._quota_ici_left)
        gd = min(ns - gi, self._quota_dcn_left)
        self._quota_ici_left -= gi
        self._quota_dcn_left -= gd
        rest = ns - gi - gd
        self.totals_ns["grad_sync"] += gi + gd
        self.grad_sync_ici_ns += gi
        self.grad_sync_dcn_ns += gd
        self.totals_ns["step_compute"] += rest
        if step is not None:
            rec = self._step_charges.setdefault(
                step, {"step_compute": 0, "gs_ici": 0, "gs_dcn": 0, "n": 0}
            )
            rec["step_compute"] += rest
            rec["gs_ici"] += gi
            rec["gs_dcn"] += gd

    def _switch(self, pending: str, step: int | None = None,
                cls: str | None = None) -> None:
        now = _ns(self.clock())
        self._charge(now - self._last_ns)
        self._last_ns = now
        self._pending = pending
        self._pending_step = step
        self._pending_class = cls

    # ---- trainer hooks --------------------------------------------------

    def wrap_batches(self, it: Iterable) -> Iterator:
        """Bracket the iterator pull: pull time is ``data_wait``; the
        interval from batch-ready to :meth:`begin_step` (dispatch, which
        blocks on the device at steady state) joins the step's charge."""
        it = iter(it)
        while True:
            # Close the previous step's host tail, open the pull.
            self._switch("data_wait")
            try:
                batch = next(it)
            except StopIteration:
                # The exhausted pull was still input-side wall time; the
                # epoch tail (eval, epoch-end bookkeeping) is "other".
                self._switch("other")
                return
            # Pull done: what follows (fault hooks, shard, dispatch) is
            # the step's own interval — begin_step classifies it.
            self._switch("step", step=None, cls="step_compute")
            yield batch

    def begin_step(self, step: int) -> None:
        """Classify the step interval that started at batch-ready and
        keep charging the post-dispatch host tail to the same class."""
        if not self._first_step_seen:
            self._first_step_seen = True
            cls = "compile"
        elif step < self._rework_until or step in self._rework_steps:
            cls = "rework"
        else:
            cls = "step_compute"
        # Re-label the batch-ready..dispatch interval (charged now) and
        # the tail (charged at the next boundary) as this step's class.
        self._pending_step = step
        self._pending_class = cls
        self._quota_ici_left = self._gs_quota_ici_ns if cls == "step_compute" else 0
        self._quota_dcn_left = (
            self._gs_quota_ns - self._gs_quota_ici_ns
            if cls == "step_compute" else 0
        )
        self._switch("step", step=step, cls=cls)
        self.step_intervals[cls] += 1
        if cls == "step_compute":
            rec = self._step_charges.setdefault(
                step, {"step_compute": 0, "gs_ici": 0, "gs_dcn": 0, "n": 0}
            )
            rec["n"] += 1
            if len(self._step_charges) > _MAX_STEP_RECORDS:
                for s in sorted(self._step_charges)[: _MAX_STEP_RECORDS // 2]:
                    del self._step_charges[s]

    def bracket(self, category: str) -> contextlib.AbstractContextManager:
        """Charge the bracketed region to ``category`` (checkpoint
        saves/restores, the CLI's compile probe), then resume the
        interrupted pending class."""
        if category not in CATEGORIES:
            raise ValueError(f"unknown ledger category {category!r}")
        return _Bracket(self, category)

    # ---- grad-sync split ------------------------------------------------

    def set_grad_sync_model(
        self, per_step_s: float, *, ici_share: float = 0.0,
        model: dict[str, Any] | None = None,
    ) -> None:
        """Per-step analytic grad-sync wall (obs/cost.py model wall x
        syncs/step) and its ICI share: each step_compute interval's
        charge consumes this integer-ns quota as ``grad_sync`` (ICI
        first, then DCN) before the remainder lands in
        ``step_compute``."""
        quota = max(_ns(per_step_s), 0)
        ici_share = min(max(float(ici_share), 0.0), 1.0)
        self._gs_quota_ns = quota
        self._gs_quota_ici_ns = int(round(quota * ici_share))
        self.grad_sync_model = dict(model) if model else None

    # ---- rework (rollback + restart) ------------------------------------

    def note_snapshot(self, step: int) -> None:
        """A recovery snapshot at ``step`` retires the rollback window
        below it: older per-step charge records can never be re-classified
        and are pruned."""
        for s in [s for s in self._step_charges if s < step]:
            del self._step_charges[s]

    def note_rollback(self, snapshot_step: int, current_step: int) -> None:
        """An anomaly rollback discards the updates of steps
        ``[snapshot_step, current_step]``: move their recorded charges
        from step_compute/grad_sync into rework (re-classified, not
        re-counted) and classify the current step's remaining tail as
        rework too."""
        for s in sorted(self._step_charges):
            if s < snapshot_step:
                continue
            rec = self._step_charges.pop(s)
            moved = rec["step_compute"] + rec["gs_ici"] + rec["gs_dcn"]
            self.totals_ns["step_compute"] -= rec["step_compute"]
            self.totals_ns["grad_sync"] -= rec["gs_ici"] + rec["gs_dcn"]
            self.grad_sync_ici_ns -= rec["gs_ici"]
            self.grad_sync_dcn_ns -= rec["gs_dcn"]
            self.totals_ns["rework"] += moved
            self.step_intervals["step_compute"] -= rec["n"]
            self.step_intervals["rework"] += rec["n"]
        self._rework_steps.add(current_step)
        if self._pending == "step" and self._pending_step == current_step:
            self._pending_class = "rework"
            self._quota_ici_left = self._quota_dcn_left = 0

    def set_rework_until(self, step: int) -> None:
        """Restart path: steps below ``step`` (the interrupted attempt's
        last completed global step, read from the progress file) are
        re-executions and classify as ``rework``."""
        self._rework_until = max(self._rework_until, int(step))

    def note_progress(self, completed_step: int) -> None:
        """Record the last completed global step for the NEXT attempt's
        restart-rework watermark (in-place rewrite of a tiny file — no
        fsync; a torn write costs at most one step of attribution)."""
        if self.progress_path is None:
            return
        if self._progress_file is None:
            self._progress_file = open(self.progress_path, "w")
        f = self._progress_file
        f.seek(0)
        f.write(f"{int(completed_step)}\n")
        f.truncate()
        f.flush()

    @staticmethod
    def read_progress(path: str | None) -> int | None:
        """The interrupted attempt's last completed global step, or None
        (no file / unreadable — a fresh run)."""
        if not path:
            return None
        try:
            with open(path) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return None

    # ---- snapshots / surfacing ------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """Current attribution, identity-exact at this instant: the open
        interval joins its pending category, so ``sum(categories_ns) ==
        wall_ns`` holds mid-run and at finalize alike (pure read — the
        ledger state is not advanced)."""
        now = self._final_ns if self._final_ns is not None else _ns(self.clock())
        open_ns = now - self._last_ns
        cats = dict(self.totals_ns)
        ici, dcn = self.grad_sync_ici_ns, self.grad_sync_dcn_ns
        if open_ns > 0:
            if self._pending == "step":
                cls = self._pending_class
                if cls == "step_compute":
                    gi = min(open_ns, self._quota_ici_left)
                    gd = min(open_ns - gi, self._quota_dcn_left)
                    cats["grad_sync"] += gi + gd
                    ici += gi
                    dcn += gd
                    cats["step_compute"] += open_ns - gi - gd
                else:
                    cats[cls] += open_ns
            else:
                cats[self._pending] += open_ns
        wall = (now - self._t0_ns) + self.inherited_backoff_ns
        goodput = cats["step_compute"] + cats["grad_sync"]
        snap: dict[str, Any] = {
            "wall_ns": wall,
            "categories_ns": cats,
            "grad_sync_ici_ns": ici,
            "grad_sync_dcn_ns": dcn,
            "inherited_backoff_ns": self.inherited_backoff_ns,
            "step_intervals": dict(self.step_intervals),
            "goodput_fraction": goodput / wall if wall > 0 else 0.0,
            "wall_s": wall / 1e9,
            "seconds": {cat: v / 1e9 for cat, v in cats.items()},
            "identity_ok": sum(cats.values()) == wall,
        }
        if self.grad_sync_model is not None:
            snap["grad_sync_model"] = dict(self.grad_sync_model)
        return snap

    def emit_gauges(self, emitter, snap: dict[str, Any] | None = None) -> None:
        """Live gauges for /metrics: the goodput fraction plus every
        category's cumulative seconds (per-category badput)."""
        if snap is None:
            snap = self.snapshot()
        emitter.gauge("goodput_fraction", snap["goodput_fraction"])
        for cat, secs in snap["seconds"].items():
            emitter.gauge(f"ledger_{cat}_s", secs)
        emitter.gauge("ledger_grad_sync_ici_s", snap["grad_sync_ici_ns"] / 1e9)
        emitter.gauge("ledger_grad_sync_dcn_s", snap["grad_sync_dcn_ns"] / 1e9)

    def finalize(self, emitter=None) -> dict[str, Any]:
        """Freeze the wall clock, then emit the final gauges AND the
        ``goodput_ledger`` record from the SAME snapshot — the live
        ``goodput_fraction`` gauge and the post-hoc report agree exactly
        because they are one dict.  Idempotent."""
        if self._final_ns is None:
            self._final_ns = _ns(self.clock())
            self._charge(self._final_ns - self._last_ns)
            self._last_ns = self._final_ns
        snap = self.snapshot()
        if emitter is not None and getattr(emitter, "enabled", False):
            self.emit_gauges(emitter, snap)
            emitter.emit("record", {"record": "goodput_ledger", **snap})
        if self._progress_file is not None:
            self._progress_file.close()
            self._progress_file = None
        return snap


class _Bracket:
    """Context manager for :meth:`GoodputLedger.bracket`: charges the
    region to its category, then restores the interrupted pending class
    (a checkpoint at a log point resumes the step's tail, not "other")."""

    def __init__(self, ledger: GoodputLedger, category: str):
        self.ledger = ledger
        self.category = category

    def __enter__(self) -> "_Bracket":
        led = self.ledger
        self._saved = (led._pending, led._pending_step, led._pending_class)
        led._switch(self.category)
        return self

    def __exit__(self, *exc) -> None:
        self.ledger._switch(*self._saved)


def fleet_ledger(
    rank_records: dict[int, dict[str, Any]],
    *,
    straggler_rank: int | None = None,
) -> dict[str, Any]:
    """Merge per-rank ledger records into a fleet ledger.

    Categories sum across ranks; the fleet wall is ``n_ranks x max(rank
    wall)`` (every rank occupies its slot until the slowest finishes);
    each rank's gap to the slowest is ``idle_gap`` — collective-wait
    residual attributed to the straggler rank (from the flight
    recorder's skew report when available, else the longest-wall rank).
    Identity: ``sum(categories) + idle_gap_total == fleet_wall`` EXACT
    (integer ns end to end).
    """
    if not rank_records:
        raise ValueError("fleet_ledger needs at least one rank record")
    walls = {rank: int(rec["wall_ns"]) for rank, rec in rank_records.items()}
    max_wall = max(walls.values())
    n = len(rank_records)
    cats = {cat: 0 for cat in CATEGORIES}
    ici = dcn = 0
    for rec in rank_records.values():
        for cat in CATEGORIES:
            cats[cat] += int(rec["categories_ns"].get(cat, 0))
        ici += int(rec.get("grad_sync_ici_ns", 0))
        dcn += int(rec.get("grad_sync_dcn_ns", 0))
    idle = {rank: max_wall - wall for rank, wall in walls.items()}
    idle_total = sum(idle.values())
    fleet_wall = n * max_wall
    if straggler_rank is None:
        straggler_rank = max(walls, key=lambda r: (walls[r], -r))
    goodput = cats["step_compute"] + cats["grad_sync"]
    return {
        "n_ranks": n,
        "fleet_wall_ns": fleet_wall,
        "categories_ns": cats,
        "grad_sync_ici_ns": ici,
        "grad_sync_dcn_ns": dcn,
        "idle_gap_ns": idle,
        "idle_gap_total_ns": idle_total,
        "idle_attributed_to": straggler_rank,
        "goodput_fraction": goodput / fleet_wall if fleet_wall > 0 else 0.0,
        "identity_ok": sum(cats.values()) + idle_total == fleet_wall,
        "per_rank_wall_ns": walls,
    }
