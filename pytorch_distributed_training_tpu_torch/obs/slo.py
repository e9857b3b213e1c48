"""Declared SLOs + multi-window multi-burn-rate alerting over the live
aggregator.

The Google-SRE alerting shape (*Site Reliability Workbook* ch. 5): an
objective declares an **error budget** (a p99 latency target allows 1%
of samples over the threshold; a 0.99 goodput target allows 1% bad
requests), and an alert fires on the budget's **burn rate** — bad
fraction over window / budget — not on raw threshold crossings.  Two
windows gate each alert: the FAST window (1m here) catches a fresh
breach quickly, the SLOW window (10m) proves it is sustained; both must
exceed the burn threshold to fire, and both must drop below it to
clear.  That kills the two classic pager failure modes — a single slow
request paging (fast-only) and a long-dead breach paging forever
(slow-only).

Everything is deterministic under the injected clock: burn rates are
pure functions of the aggregator's window slots, evaluation happens at
host control-loop boundaries (scheduler tick / trainer step), and every
state transition is emitted back into the JSONL spine as a schema-v4
``alert`` event — so the live view (``/slo``) and the post-hoc view
(``tools/telemetry_report.py`` ``alerts`` section) reduce the same
record stream through :func:`reduce_alerts` and agree exactly.

Flight-recorder anomalies (obs/flight.py) are PROMOTED through the same
policy: each anomaly of a promoted kind (queue saturation, grad spikes,
non-finite values, step-time straggler skew) emits exactly one
``state="event"`` alert — anomaly count == alert count, pinned.

Objective spec grammar (CLI ``--slo``)::

    ttft_p99=250ms,tpot_p99=40ms,goodput=0.99,step_time_p95=120ms

``<hist>_p<q>=<duration>`` declares a latency-quantile objective over
histogram ``<hist>_s`` (duration: ``us``/``ms``/``s`` or bare seconds);
``goodput=<frac>`` declares the request-ratio objective over the
scheduler's finished/shed/cancelled/rejected counters.  A
``<hist>_p<q>[<class>]=<duration>`` clause scopes the objective to one
priority class's labeled histogram (``ttft_p99[interactive]=250ms``
watches ``ttft_s[tenant=interactive]``) — burn-rate alerting per class,
and the admission policy (serve/policy.py) reads the breach to bias the
weighted-deficit queue pop toward the burning class.

The port's own copy of the JAX package's ``obs/slo.py``.
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Any

from .live import LiveAggregator, labeled

DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 600.0
# The SRE page-tier factor: at burn 14.4 a 30-day budget dies in ~2 days.
DEFAULT_BURN_THRESHOLD = 14.4

# Ratio objectives: name -> the counter sets whose window deltas form
# good/bad.  The scheduler owns the serve counters (serve/scheduler.py).
RATIO_OBJECTIVES: dict[str, dict[str, tuple[str, ...]]] = {
    "goodput": {
        "good": ("finished_requests",),
        "bad": (
            "shed_requests", "cancelled_requests", "rejected_requests",
            # Failover retirements (serve/failover.py): a request whose
            # retry budget died before it did is work the tier LOST.
            "failed_requests",
        ),
    },
}

# Flight-recorder anomaly kinds promoted to first-class alerts, and the
# alert name each lands under (obs/flight.py emits the anomalies; the
# policy emits one state="event" alert per occurrence).
PROMOTED_ANOMALIES: dict[str, str] = {
    "queue_saturation": "queue_saturation",
    "grad_norm_spike": "grad_spike",
    "nonfinite_grad_norm": "grad_spike",
    "nonfinite_loss": "grad_spike",
    "straggler_skew": "straggler_skew",
    # Serving-tier failover (serve/failover.py): a replica declared dead
    # is an ops page no matter what the burn rates say.
    "replica_dead": "replica_dead",
}

_QUANTILE_KEY_RE = re.compile(
    r"^(?P<base>[a-z][a-z0-9_]*)_p(?P<q>\d{1,2}(?:\.\d+)?)"
    r"(?:\[(?P<cls>[A-Za-z0-9_.:-]+)\])?$"
)


@dataclasses.dataclass(frozen=True)
class Objective:
    name: str        # the spec key ("ttft_p99", "goodput")
    kind: str        # "quantile" | "ratio"
    metric: str      # histogram name ("ttft_s") or ratio key
    threshold: float  # seconds (quantile) / target fraction (ratio)
    q: float | None   # the declared quantile (quantile kind)
    budget: float     # allowed bad fraction (the error budget)
    # Per-class objective (serve/policy.py): ``ttft_p99[interactive]``
    # scopes the objective to one priority class's labeled histogram
    # (``ttft_s[tenant=interactive]``) — the admission policy reads the
    # breach to bias the weighted-deficit pop toward the burning class.
    cls: str | None = None


def parse_duration(text: str) -> float:
    """``"250ms"``/``"40us"``/``"1.5s"``/bare seconds -> seconds."""
    t = text.strip()
    for suffix, scale in (("us", 1e-6), ("ms", 1e-3), ("s", 1.0)):
        if t.endswith(suffix):
            return float(t[: -len(suffix)]) * scale
    return float(t)


def parse_slo_spec(spec: str) -> list[Objective]:
    """The ``--slo`` grammar -> objectives.  Raises ValueError with the
    offending clause on any malformed entry."""
    objectives: list[Objective] = []
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        if "=" not in clause:
            raise ValueError(f"SLO clause {clause!r} wants key=value")
        key, value = (p.strip() for p in clause.split("=", 1))
        mo = _QUANTILE_KEY_RE.match(key)
        if mo:
            q = float(mo.group("q"))
            if not 0.0 < q < 100.0:
                raise ValueError(f"SLO {key!r}: quantile must be in (0, 100)")
            try:
                threshold = parse_duration(value)
            except ValueError:
                raise ValueError(
                    f"SLO {key!r}: bad duration {value!r} "
                    "(want e.g. 250ms / 0.25s)"
                ) from None
            if threshold <= 0:
                raise ValueError(f"SLO {key!r}: threshold must be > 0")
            cls = mo.group("cls")
            metric = f"{mo.group('base')}_s"
            if cls is not None:
                # The scheduler already emits the per-tenant labeled view
                # of every SLO histogram (serve/scheduler.py), so a
                # class-scoped objective is just the labeled metric name.
                metric = labeled(metric, tenant=cls)
            objectives.append(Objective(
                name=key, kind="quantile", metric=metric,
                threshold=threshold, q=q, budget=1.0 - q / 100.0,
                cls=cls,
            ))
        elif key in RATIO_OBJECTIVES:
            target = float(value)
            if not 0.0 < target < 1.0:
                raise ValueError(
                    f"SLO {key!r}: target fraction must be in (0, 1)"
                )
            objectives.append(Objective(
                name=key, kind="ratio", metric=key,
                threshold=target, q=None, budget=1.0 - target,
            ))
        else:
            raise ValueError(
                f"unknown SLO key {key!r} (want <hist>_p<q>=<duration> "
                f"or one of {sorted(RATIO_OBJECTIVES)})"
            )
    if not objectives:
        raise ValueError(f"empty SLO spec {spec!r}")
    names = [o.name for o in objectives]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate SLO objectives in {spec!r}")
    return objectives


class SLOPolicy:
    """Burn-rate alert engine over one :class:`LiveAggregator`.

    Attach to the emitter alongside the aggregator
    (``emitter.attach_sink(policy)``) so flight-recorder anomalies
    promote as they are written; call :meth:`evaluate` from the host
    control loop (the scheduler tick / trainer step already does) — the
    policy never runs its own thread, which is what keeps scripted
    traces deterministic tick for tick.
    """

    def __init__(
        self,
        aggregator: LiveAggregator,
        objectives: list[Objective] | None = None,
        *,
        emitter=None,
        fast_window_s: float = DEFAULT_FAST_WINDOW_S,
        slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
        burn_threshold: float = DEFAULT_BURN_THRESHOLD,
        promoted_anomalies: dict[str, str] | None = None,
    ):
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError(
                f"want 0 < fast_window_s <= slow_window_s, got "
                f"{fast_window_s} / {slow_window_s}"
            )
        self.aggregator = aggregator
        self.objectives = list(objectives or [])
        self.emitter = emitter
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.promoted = (
            dict(PROMOTED_ANOMALIES) if promoted_anomalies is None
            else dict(promoted_anomalies)
        )
        self._state: dict[str, str] = {o.name: "ok" for o in self.objectives}
        self._since: dict[str, float | None] = {
            o.name: None for o in self.objectives
        }
        # Chronological alert log (burn transitions + promoted anomaly
        # events) — the live-side input to reduce_alerts; the JSONL
        # ``alert`` events are the post-hoc side of the same stream.
        self.alert_log: list[dict[str, Any]] = []
        # The ops HTTP thread snapshots this policy while the control
        # loop transitions it; the lock keeps a /slo scrape consistent
        # (an objective's state and the alert log it implies commit
        # together — never a torn "firing but no transition" payload).
        self._lock = threading.Lock()

    # ---- SLI math ------------------------------------------------------

    def _bad_total(
        self, obj: Objective, window_s: float | None, now: float
    ) -> tuple[float, float]:
        """(bad, total) for ``obj`` over ``window_s`` (None = cumulative).
        Pure functions of the aggregator's bucket counts / counter
        deltas, so every evaluation is replayable."""
        agg = self.aggregator
        if obj.kind == "quantile":
            if window_s is None:
                h = agg.hist(obj.metric)
                if h is None:
                    return 0.0, 0.0
                return float(h.count_above(obj.threshold)), float(h.count)
            h = agg.window_hist(obj.metric, window_s, now)
            return float(h.count_above(obj.threshold)), float(h.count)
        sets = RATIO_OBJECTIVES[obj.metric]
        if window_s is None:
            good = sum(agg.counter(c) for c in sets["good"])
            bad = sum(agg.counter(c) for c in sets["bad"])
        else:
            good = sum(
                agg.window_counter(c, window_s, now) for c in sets["good"]
            )
            bad = sum(
                agg.window_counter(c, window_s, now) for c in sets["bad"]
            )
        return bad, good + bad

    def burn_rate(
        self, obj: Objective, window_s: float, now: float
    ) -> float:
        """Bad-fraction over the window divided by the error budget; an
        empty window burns 0 (no evidence is not a breach)."""
        bad, total = self._bad_total(obj, window_s, now)
        if total <= 0:
            return 0.0
        return (bad / total) / obj.budget

    # ---- the alert machine ---------------------------------------------

    def evaluate(self, now: float | None = None) -> list[dict[str, Any]]:
        """One evaluation pass: burn rates for every objective over both
        windows, state transitions where fast AND slow cross the
        threshold (both below to clear).  Returns the transitions made
        this pass (empty most ticks).  Each transition is appended to
        :attr:`alert_log` and emitted as an ``alert`` event."""
        now = self.aggregator.clock() if now is None else float(now)
        # Stamp for the emitted records: the caller's ``now`` may be a
        # tick-START read while the tick's own events were stamped later
        # by the emitter's clock — an alert stamped with the stale read
        # would REGRESS the log's timestamps and fail validate_events.
        # A fresh clamp keeps the log monotone under real clocks and is
        # the identity under scripted VirtualClocks (time frozen per
        # tick), so the pinned transition times are unchanged.
        stamp = max(now, self.aggregator.clock())
        fired: list[dict[str, Any]] = []
        with self._lock:
            for obj in self.objectives:
                fast = self.burn_rate(obj, self.fast_window_s, now)
                slow = self.burn_rate(obj, self.slow_window_s, now)
                firing = (
                    fast >= self.burn_threshold
                    and slow >= self.burn_threshold
                )
                prev = self._state[obj.name]
                if firing == (prev == "firing"):
                    continue
                state = "firing" if firing else "ok"
                self._state[obj.name] = state
                self._since[obj.name] = stamp
                record = {
                    "t": stamp, "alert": obj.name, "state": state,
                    "burn_fast": fast, "burn_slow": slow,
                    "window_fast_s": self.fast_window_s,
                    "window_slow_s": self.slow_window_s,
                    "objective": {
                        "kind": obj.kind, "metric": obj.metric,
                        "threshold": obj.threshold, "q": obj.q,
                        "budget": obj.budget,
                    },
                }
                self.alert_log.append(record)
                fired.append(record)
                if self.emitter is not None:
                    self.emitter.counter_add("slo_alert_transitions", 1)
                    # The payload's own t (the evaluation time) overrides
                    # the emitter's stamp — the JSONL record and the live
                    # log entry are the SAME dict, so reduce_alerts over
                    # either side is equal by construction, real clocks
                    # included.
                    self.emitter.emit("alert", dict(record))
        return fired

    # ---- anomaly promotion (emitter sink: event hook only) -------------

    def event(self, record: dict[str, Any]) -> None:
        """Emitter-sink hook: promote flight-recorder anomalies into
        first-class alerts — one ``state="event"`` alert per promoted
        anomaly, so anomaly count == alert count by construction.  Every
        other kind (including the alert events this policy itself emits)
        passes through untouched."""
        if record.get("kind") != "anomaly":
            return
        alert = self.promoted.get(record.get("anomaly"))
        if alert is None:
            return
        entry = {
            "t": record.get("t"), "alert": alert, "state": "event",
            "anomaly": record.get("anomaly"),
        }
        if record.get("step") is not None:
            entry["step"] = record["step"]
        # Note: this sink hook runs on the control-loop thread (inside
        # emitter.emit); the nested alert emit re-enters the sink chain
        # but "alert" kinds return above before this lock is taken.
        with self._lock:
            self.alert_log.append(entry)
            if self.emitter is not None:
                self.emitter.counter_add("anomaly_alerts", 1)
                self.emitter.emit("alert", dict(entry))

    # ---- reading -------------------------------------------------------

    @property
    def active_alerts(self) -> list[str]:
        with self._lock:
            return sorted(
                name for name, st in self._state.items() if st == "firing"
            )

    def snapshot(self, now: float | None = None) -> dict[str, Any]:
        """The ``/slo`` payload: per-objective status (cumulative SLI +
        both window burn rates + alert state) and the reduced alert
        history.  The ``alerts`` block is :func:`reduce_alerts` over the
        live log — byte-comparable to the offline report's reduction of
        the same run's JSONL.  Taken under the policy lock so a scrape
        concurrent with a transition sees state and log COMMITTED
        together (never "firing" without its transition)."""
        now = self.aggregator.clock() if now is None else float(now)
        with self._lock:
            objectives = []
            for obj in self.objectives:
                bad, total = self._bad_total(obj, None, now)
                objectives.append({
                    "name": obj.name, "kind": obj.kind,
                    "metric": obj.metric,
                    "threshold": obj.threshold, "q": obj.q,
                    "budget": obj.budget,
                    "sli": {
                        "total": total, "bad": bad,
                        "bad_fraction": bad / total if total else None,
                        "attainment": (
                            1.0 - bad / total if total else None
                        ),
                    },
                    "burn_fast": self.burn_rate(
                        obj, self.fast_window_s, now
                    ),
                    "burn_slow": self.burn_rate(
                        obj, self.slow_window_s, now
                    ),
                    "state": self._state[obj.name],
                    "since": self._since[obj.name],
                })
            return {
                "t": now,
                "config": {
                    "fast_window_s": self.fast_window_s,
                    "slow_window_s": self.slow_window_s,
                    "burn_threshold": self.burn_threshold,
                },
                "objectives": objectives,
                "active_alerts": sorted(
                    name for name, st in self._state.items()
                    if st == "firing"
                ),
                "alerts": reduce_alerts(self.alert_log),
            }


def reduce_alerts(alert_records: list[dict[str, Any]]) -> dict[str, Any]:
    """Reduce a chronological alert stream (the policy's live log OR the
    ``alert`` events read back from JSONL — same fields either way) to
    the ops summary: per-objective time-in-violation over CLOSED
    firing→ok intervals, worst observed burn rate, the transition log,
    and promoted-anomaly counts.  One reducer for both sides is what
    makes the live ``/slo`` snapshot and ``tools/telemetry_report.py``'s
    ``alerts`` section exactly equal on the same run."""
    transitions = [
        r for r in alert_records if r.get("state") in ("firing", "ok")
    ]
    events = [r for r in alert_records if r.get("state") == "event"]
    per_objective: dict[str, dict[str, Any]] = {}
    for r in transitions:
        entry = per_objective.setdefault(r["alert"], {
            "transitions": 0, "time_in_violation_s": 0.0,
            "worst_burn": 0.0, "firing_since": None, "log": [],
        })
        entry["transitions"] += 1
        entry["worst_burn"] = max(
            entry["worst_burn"],
            r.get("burn_fast") or 0.0, r.get("burn_slow") or 0.0,
        )
        entry["log"].append({
            k: r.get(k)
            for k in ("t", "state", "burn_fast", "burn_slow")
        })
        if r["state"] == "firing":
            entry["firing_since"] = r.get("t")
        elif entry["firing_since"] is not None:
            entry["time_in_violation_s"] += r["t"] - entry["firing_since"]
            entry["firing_since"] = None
    anomaly_counts: dict[str, int] = {}
    for r in events:
        anomaly_counts[r["alert"]] = anomaly_counts.get(r["alert"], 0) + 1
    return {
        "transitions": len(transitions),
        "objectives": per_objective,
        "anomaly_alerts": {
            "count": len(events), "by_alert": anomaly_counts,
        },
    }
