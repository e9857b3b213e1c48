"""Multi-host flight recorder: per-rank anomaly detection + rank merge.

A multi-host hang or divergence leaves no single-process evidence: rank 7's
collective stalls because rank 3 is slow, and by the time the supervisor
kills the job the interesting state is gone.  The flight recorder is the
black box each process keeps for the post-mortem:

- **write side** (:class:`FlightRecorder`): wraps a :class:`MetricsEmitter`
  and turns per-step metrics into phase/heartbeat/anomaly events —
  non-finite loss, gradient-norm spikes (rolling z-score), queue-depth
  saturation — appended to the process's own rank log as they happen, so
  the record survives the process;
- **read side** (:func:`load_rank_logs` / :func:`merge_timeline` /
  :func:`straggler_report`): merge every rank's log into one step-aligned
  timeline and flag stragglers by per-rank step-time skew — the "which
  host stalled" answer ``tools/telemetry_report.py`` prints.

Timestamps are per-rank monotonic clocks, NOT comparable across ranks —
alignment is by step number (every rank steps the same optimizer step),
and skew is computed from per-rank step *durations*, which need no shared
clock.  Under torchrun every rank writes its own ``events.rank0000N.jsonl``.
The port's own copy of the JAX package's ``obs/flight.py``, with its
thresholds.
"""

from __future__ import annotations

import glob
import math
import os
import re
from typing import Any

from .emitter import MetricsEmitter, percentiles, read_events

# Defaults for the anomaly detectors; constructor-overridable.
GRAD_SPIKE_Z = 8.0          # z-score over the rolling window
GRAD_SPIKE_WINDOW = 50      # steps of history
QUEUE_SATURATION_FRAC = 0.9  # depth/max_queue that counts as saturated
STRAGGLER_SKEW = 1.25        # rank median step time / fleet median
# Live self-skew: one step's host wall time over the rank's OWN rolling
# median.  Looser than the cross-rank 1.25x (a single step carries log
# -point sync noise a median of medians does not); the obs/slo.py
# promotion turns each firing into a straggler_skew alert.
STEP_SKEW = 2.0
STEP_SKEW_WINDOW = 50


class FlightRecorder:
    """Anomaly-detecting front of one process's event log."""

    def __init__(
        self,
        emitter: MetricsEmitter,
        *,
        grad_spike_z: float = GRAD_SPIKE_Z,
        grad_spike_window: int = GRAD_SPIKE_WINDOW,
        queue_saturation_frac: float = QUEUE_SATURATION_FRAC,
        step_skew: float = STEP_SKEW,
        step_skew_window: int = STEP_SKEW_WINDOW,
    ):
        self.emitter = emitter
        self.grad_spike_z = grad_spike_z
        self.grad_spike_window = grad_spike_window
        self.queue_saturation_frac = queue_saturation_frac
        self.step_skew = step_skew
        self.step_skew_window = step_skew_window
        self._grad_norms: list[float] = []
        self._dts: list[float] = []
        self.anomalies = 0

    def _flag(self, kind: str, **fields: Any) -> None:
        self.anomalies += 1
        self.emitter.anomaly(kind, **fields)

    def check_step(self, step: int, metrics: dict[str, Any]) -> None:
        """Inspect one step's (host-visible) metrics for anomalies.
        ``loss``, ``grad_norm`` and ``skipped`` are the understood keys;
        absent keys are simply not checked.  ``skipped`` (the resilience
        skip-step policy's gate flag) flags a ``skip_step`` anomaly —
        detection AND the recovery action land in the same rank log the
        post-mortem merge reads.  The recovery escalations (``rollback``,
        ``recovery_abort``, ``preemption``, ``checkpoint_restore_failed``,
        ``fault_injected``) are emitted by their owners through the same
        ``anomaly`` spine."""
        skipped = metrics.get("skipped")
        if skipped is not None and float(skipped) > 0:
            # ``skipped`` is the COUNT of gated steps since the last check
            # (the trainer passes the cumulative-counter delta), so skips
            # between log points still surface.
            self._flag("skip_step", step=step, count=int(skipped))
        loss = metrics.get("loss")
        if loss is not None and not math.isfinite(float(loss)):
            self._flag("nonfinite_loss", step=step, loss=float(loss))
        gn = metrics.get("grad_norm")
        if gn is not None:
            gn = float(gn)
            if not math.isfinite(gn):
                self._flag("nonfinite_grad_norm", step=step, grad_norm=gn)
            else:
                hist = self._grad_norms
                if len(hist) >= 8:
                    mean = sum(hist) / len(hist)
                    var = sum((x - mean) ** 2 for x in hist) / len(hist)
                    std = max(math.sqrt(var), 1e-12)
                    z = (gn - mean) / std
                    if z > self.grad_spike_z:
                        self._flag(
                            "grad_norm_spike", step=step, grad_norm=gn,
                            rolling_mean=mean, z=z,
                        )
                hist.append(gn)
                if len(hist) > self.grad_spike_window:
                    hist.pop(0)
        dt = metrics.get("dt")
        if dt is not None:
            # Self-relative straggler detection (the live half of the
            # cross-rank read-side skew report below): a step whose host
            # wall time exceeds ``step_skew`` x the rolling median of
            # this rank's OWN recent steps is a hiccup worth flagging —
            # no shared clock, no other rank needed.
            dt = float(dt)
            dts = self._dts
            if len(dts) >= 8:
                med = _median(dts)
                if med > 0 and dt > self.step_skew * med:
                    self._flag(
                        "straggler_skew", step=step, dt=dt,
                        rolling_median_dt=med, skew=dt / med,
                    )
            dts.append(dt)
            if len(dts) > self.step_skew_window:
                dts.pop(0)

    def check_queue(self, depth: int, max_queue: int) -> None:
        """Serving-side detector: a queue pinned near its bound means the
        backpressure path is live (or admission is starved)."""
        self.emitter.gauge("queue_depth", depth)
        if max_queue > 0 and depth >= self.queue_saturation_frac * max_queue:
            self._flag("queue_saturation", depth=depth, max_queue=max_queue)


# ---- read side (tools/telemetry_report.py + tests) ----------------------

_RANK_RE = re.compile(r"events\.rank(\d+)\.jsonl$")


def load_rank_logs(
    metrics_dir: str, *, allow_truncated: bool = True
) -> dict[int, list[dict[str, Any]]]:
    """{rank: events} for every per-rank JSONL log in ``metrics_dir``.

    Post-mortem reader: a rank killed mid-write leaves a torn final line,
    so truncation tolerance defaults ON here (``read_events`` stays
    strict for callers that want the write-side contract enforced).
    """
    logs: dict[int, list[dict[str, Any]]] = {}
    for path in sorted(glob.glob(os.path.join(metrics_dir, "events.rank*.jsonl"))):
        mo = _RANK_RE.search(path)
        if not mo:
            continue
        logs[int(mo.group(1))] = read_events(
            path, allow_truncated=allow_truncated
        )
    if not logs:
        raise FileNotFoundError(
            f"no events.rank*.jsonl logs under {metrics_dir!r}"
        )
    return logs


def merge_timeline(
    logs: dict[int, list[dict[str, Any]]],
) -> list[dict[str, Any]]:
    """Step-aligned merge: one row per optimizer step, carrying each
    rank's step event.  ``dt`` is the event's own host-measured step time
    when present (the trainer emits it); only events without one fall back
    to the gap from the rank's previous step event — a derivation that
    spans epoch boundaries (eval, checkpoints) and would inflate p99s if
    used unconditionally.  Cross-rank ``t`` values are never compared."""
    per_rank_steps: dict[int, dict[int, dict[str, Any]]] = {}
    for rank, events in logs.items():
        rows: dict[int, dict[str, Any]] = {}
        prev_t = None
        for ev in events:
            if ev.get("kind") != "step":
                continue
            row = {k: v for k, v in ev.items() if k not in ("v", "kind", "rank")}
            if row.get("dt") is None:
                row["dt"] = ev["t"] - prev_t if prev_t is not None else None
            prev_t = ev["t"]
            rows[int(ev["step"])] = row
        per_rank_steps[rank] = rows
    all_steps = sorted({s for rows in per_rank_steps.values() for s in rows})
    timeline = []
    for s in all_steps:
        ranks = {
            rank: rows[s] for rank, rows in per_rank_steps.items() if s in rows
        }
        timeline.append({
            "step": s,
            "ranks": ranks,
            "missing_ranks": sorted(set(per_rank_steps) - set(ranks)),
        })
    return timeline


def _median(xs: list[float]) -> float:
    return percentiles(xs, (50,))["p50"]  # the shared reduction


def straggler_report(
    timeline: list[dict[str, Any]], *, skew_threshold: float = STRAGGLER_SKEW,
) -> dict[str, Any]:
    """Per-rank step-time skew: a rank whose median step duration exceeds
    the fleet median by ``skew_threshold``× is flagged a straggler (every
    rank runs the same compiled step, so sustained skew is a host/link
    problem, not a workload one)."""
    per_rank_dts: dict[int, list[float]] = {}
    for row in timeline:
        for rank, ev in row["ranks"].items():
            if ev.get("dt") is not None:
                per_rank_dts.setdefault(rank, []).append(ev["dt"])
    medians = {
        rank: _median(dts) for rank, dts in per_rank_dts.items() if dts
    }
    if not medians:
        return {"per_rank_median_dt_s": {}, "stragglers": [], "skew": {}}
    fleet = _median(list(medians.values()))
    skew = {rank: (m / fleet if fleet > 0 else None)
            for rank, m in medians.items()}
    stragglers = sorted(
        rank for rank, s in skew.items()
        if s is not None and s > skew_threshold
    )
    return {
        "per_rank_median_dt_s": medians,
        "fleet_median_dt_s": fleet,
        "skew": skew,
        "skew_threshold": skew_threshold,
        "stragglers": stragglers,
    }
