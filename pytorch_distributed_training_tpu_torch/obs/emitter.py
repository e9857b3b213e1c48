"""The telemetry spine: one structured per-process event log + metric state.

Before this module, every subsystem reported sideways — the trainer kept a
``history`` list and printed, the serving stack hand-rolled percentiles in
two places, and the only machine-readable output was a rank-0 per-epoch
JSONL.  ``MetricsEmitter`` is the single API all of them now point at:

- **counters** (monotonic adds: bytes on wire, tokens served), **gauges**
  (last-value: queue depth, learning rate), and **histograms** (raw
  samples, reduced to percentiles at summary time);
- a **schema-versioned JSONL event log** — one writer per process, every
  record tagged with rank and a monotonic timestamp, first record a
  ``meta`` header so a reader can validate without out-of-band context.
  Per-step records carry the counter *deltas* attributed to that step, so
  "bytes crossed DCN this step" is a field, not a derivation;
- a ``tsv`` export mode for spreadsheet-shaped consumers (write-only; the
  aggregation tooling reads JSONL).

Multi-host runs give every process its OWN file (``events.rank00003.jsonl``)
— unlike the rank-0-only ``utils.metrics.MetricsLogger``, the flight
recorder's whole point is per-rank evidence (which host stalled), merged
after the fact by ``tools/telemetry_report.py``.

The emitter is also constructible disabled (``metrics_dir=None``): every
method short-circuits, so call sites thread one object unconditionally.

The port's own copy of the JAX package's ``obs/emitter.py``: schema v4,
the same kinds and fields, so ``tools/telemetry_report.py`` and
``tools/trace_export.py`` read the port's logs.  The default rank and
world come from ``torch.distributed``; the CLI's meta header names the
backend ``"gpu"`` on the card and ``"cpu"`` on the host.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Iterable

import numpy as np

# Event-log schema history:
#   v1 — the first spine: meta/step/phase/heartbeat/anomaly/compiled_cost/
#        record/summary kinds.
#   v2 — analyzer findings + per-program memory records riding the
#        ``record`` kind (the JAX package's static analysis writes them).
#   v3 — the ``span`` kind (obs/spans.py): request-scoped tracing spans
#        with sid/parent/corr and monotonic t0/t1.
#   v4 — the ``alert`` kind (obs/slo.py): SLO burn-rate state
#        transitions and promoted flight-recorder anomalies, plus
#        summary histograms carrying fixed-log-bucket counts
#        (obs/live.py) so the offline report recomputes the live
#        quantiles from identical buckets.
# Writers always emit the current version; ``validate_events`` accepts
# every version here, so old flight records stay readable (span events
# are only legal at v3+, alert events at v4+ — earlier writers never
# produced them).
SCHEMA_VERSION = 4
SUPPORTED_SCHEMA_VERSIONS = (1, 2, 3, 4)

# Event kinds a valid log may contain (validate_events pins the contract).
EVENT_KINDS = (
    "meta", "step", "phase", "heartbeat", "anomaly", "compiled_cost",
    "record", "summary", "span", "alert",
)

# Legal ``state`` values on an alert event: burn-rate transitions
# (firing/ok) and one-shot promoted anomalies (event).
ALERT_STATES = ("firing", "ok", "event")

LOG_FORMATS = ("jsonl", "tsv")


def percentiles(
    xs: Iterable[float | None], qs: Iterable[float] = (50.0, 99.0)
) -> dict[str, float | None]:
    """Linear-interpolated percentiles of the non-None samples, keyed
    ``"p50"``/``"p99"``/... — the ONE percentile implementation (the serve
    SLO summaries and the histogram reductions both call it, replacing two
    hand-rolled copies)."""
    clean = [x for x in xs if x is not None]
    out: dict[str, float | None] = {}
    for q in qs:
        key = f"p{int(q) if float(q).is_integer() else q}"
        out[key] = (
            float(np.percentile(np.asarray(clean, np.float64), q))
            if clean else None
        )
    return out


class MetricsEmitter:
    """Counters/gauges/histograms + the per-process structured event log.

    ``metrics_dir=None`` constructs a disabled emitter (all methods no-op;
    ``enabled`` is False).  ``rank`` defaults to the ``torch.distributed``
    rank when a process group is initialized, else 0.
    ``clock`` is injectable for deterministic tests (monotonic seconds).
    """

    def __init__(
        self,
        metrics_dir: str | None,
        *,
        rank: int | None = None,
        world: int | None = None,
        log_format: str = "jsonl",
        meta: dict[str, Any] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if log_format not in LOG_FORMATS:
            raise ValueError(
                f"log_format {log_format!r} not in {LOG_FORMATS}"
            )
        self.enabled = metrics_dir is not None
        self.log_format = log_format
        self.clock = clock
        self._counters: dict[str, float] = {}
        self._step_counters: dict[str, float] = {}  # static per-step adds
        self._last_counters: dict[str, float] = {}  # snapshot at last step
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, list[float]] = {}
        # Live sinks (obs/live.py): per-hook callback lists, populated by
        # attach_sink.  The JSONL file is sink one; a LiveAggregator (and
        # an SLOPolicy's anomaly-promotion hook) are the others — one
        # spine, N sinks, no second instrumentation path.
        self._sink_counter: list[Callable[[str, float], None]] = []
        self._sink_gauge: list[Callable[[str, float], None]] = []
        self._sink_observe: list[Callable[[str, float], None]] = []
        self._sink_event: list[Callable[[dict[str, Any]], None]] = []
        self._file = None
        self._closed = False
        if not self.enabled:
            self.rank = rank or 0
            self.path = None
            return
        if rank is None:
            import torch.distributed as dist

            rank, world = 0, world
            if dist.is_available() and dist.is_initialized():
                rank = dist.get_rank()
                world = world if world is not None else dist.get_world_size()
        self.rank = int(rank)
        os.makedirs(metrics_dir, exist_ok=True)
        ext = "jsonl" if log_format == "jsonl" else "tsv"
        self.path = os.path.join(
            metrics_dir, f"events.rank{self.rank:05d}.{ext}"
        )
        # One writer per process: truncate, don't append — a resumed run
        # gets a fresh log with a fresh meta header (the old one is the
        # previous attempt's flight record, not this run's).
        self._file = open(self.path, "w")
        self.emit("meta", {
            "schema": SCHEMA_VERSION,
            "rank": self.rank,
            "world": int(world) if world is not None else 1,
            "unix_time": time.time(),
            **(meta or {}),
        })

    # ---- live sinks -----------------------------------------------------

    def attach_sink(self, sink: Any) -> None:
        """Tee this emitter's metric calls and events into ``sink``
        (obs/live.py's LiveAggregator, obs/slo.py's SLOPolicy): whichever
        of ``counter_add(name, value)`` / ``gauge(name, value)`` /
        ``observe(name, value)`` / ``event(record)`` the sink defines is
        called inline with every write.  A disabled emitter never calls
        its sinks (every method short-circuits first), so the live plane
        rides only where the JSONL spine does."""
        for hook, bucket in (
            ("counter_add", self._sink_counter),
            ("gauge", self._sink_gauge),
            ("observe", self._sink_observe),
            ("event", self._sink_event),
        ):
            fn = getattr(sink, hook, None)
            if callable(fn):
                bucket.append(fn)

    # ---- metric state ---------------------------------------------------

    def counter_add(self, name: str, value: float) -> None:
        """Monotonic counter (bytes, tokens, syncs)."""
        if not self.enabled:
            return
        self._counters[name] = self._counters.get(name, 0.0) + float(value)
        for fn in self._sink_counter:
            fn(name, float(value))

    def set_step_counters(self, per_step: dict[str, float]) -> None:
        """Counters added automatically at every ``step()`` — the shape of
        per-step costs that are static per compiled program (the analytic
        DCN bytes of one gradient sync × syncs/step)."""
        if not self.enabled:
            return
        self._step_counters = {k: float(v) for k, v in per_step.items()}

    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self._gauges[name] = float(value)
        for fn in self._sink_gauge:
            fn(name, float(value))

    def observe(self, name: str, value: float) -> None:
        """Histogram sample; reduced to percentiles in the summary."""
        if not self.enabled:
            return
        self._hists.setdefault(name, []).append(float(value))
        for fn in self._sink_observe:
            fn(name, float(value))

    # ---- events ---------------------------------------------------------

    def emit(self, kind: str, payload: dict[str, Any]) -> None:
        """Append one structured event.  Every record carries ``t``
        (monotonic seconds) and ``rank``; ``kind`` must be a schema kind."""
        if not self.enabled or self._closed:
            return
        record = {
            "v": SCHEMA_VERSION, "t": self.clock(), "rank": self.rank,
            "kind": kind, **payload,
        }
        if self.log_format == "jsonl":
            self._file.write(json.dumps(record) + "\n")
        else:
            fixed = ("v", "t", "rank", "kind", "step")
            cells = [
                f"{record.get('v', '')}", f"{record['t']:.6f}",
                f"{record['rank']}", record["kind"],
                f"{record.get('step', '')}",
            ]
            cells += [
                f"{k}={_tsv_value(v)}" for k, v in record.items()
                if k not in fixed
            ]
            self._file.write("\t".join(cells) + "\n")
        self._file.flush()
        for fn in self._sink_event:
            fn(record)

    def step(self, step: int, **fields: Any) -> None:
        """The per-step record: user fields (loss, step wall time) plus the
        counter deltas attributed to this step (explicit ``counter_add``
        calls since the previous step event + the static per-step set)."""
        if not self.enabled:
            return
        for name, value in self._step_counters.items():
            self.counter_add(name, value)
        deltas = {
            name: total - self._last_counters.get(name, 0.0)
            for name, total in self._counters.items()
        }
        self._last_counters = dict(self._counters)
        payload = {"step": int(step), **fields}
        if deltas:
            payload["counters"] = deltas
        self.emit("step", payload)

    def phase(self, name: str, **fields: Any) -> None:
        self.emit("phase", {"phase": name, **fields})

    def heartbeat(self, **fields: Any) -> None:
        self.emit("heartbeat", fields)

    def anomaly(self, anomaly_kind: str, **fields: Any) -> None:
        self.emit("anomaly", {"anomaly": anomaly_kind, **fields})

    def summary(self, **fields: Any) -> dict[str, Any] | None:
        """Emit the closing record: cumulative counters, final gauges, and
        histogram percentiles.  Returns the payload (None when disabled).

        Each histogram also carries its fixed-log-bucket counts
        (obs/live.py), batch-bucketed here from the RAW sample list —
        independently of any live aggregator's incremental accumulation.
        ``tools/telemetry_report.py`` recomputes quantiles from these
        buckets with the same shared reduction, which is what makes
        "live snapshot == offline report" a real cross-check rather than
        one code path reading itself."""
        if not self.enabled:
            return None
        from .live import bucket_counts_of

        payload = {
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "histograms": {
                name: {
                    "count": len(xs),
                    **percentiles(xs, (50, 90, 99)),
                    "max": max(xs) if xs else None,
                    "sum": float(sum(xs)),
                    "buckets": bucket_counts_of(xs),
                }
                for name, xs in self._hists.items()
            },
            **fields,
        }
        self.emit("summary", payload)
        return payload

    def close(self) -> None:
        if self._file is not None and not self._closed:
            self._file.flush()
            self._file.close()
        self._closed = True

    def __enter__(self) -> "MetricsEmitter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _tsv_value(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, (dict, list)):
        return json.dumps(v, separators=(",", ":"))
    return str(v)


def read_events(
    path: str, *, allow_truncated: bool = False
) -> list[dict[str, Any]]:
    """Load one rank's JSONL event log back (the aggregation input).

    ``allow_truncated`` tolerates an unparseable FINAL line — the torn
    tail a killed process leaves mid-write, which is exactly when the
    flight-recorder read side needs the log most.  A bad line anywhere
    else is corruption, not a crash artifact, and still raises.
    """
    with open(path) as f:
        lines = [line for line in f if line.strip()]
    events = []
    for i, line in enumerate(lines):
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if allow_truncated and i == len(lines) - 1:
                break
            raise
    return events


def validate_events(events: list[dict[str, Any]]) -> None:
    """Schema check: raises ValueError on the first violation.  The
    contract a reader may rely on: a ``meta`` header first (matching
    schema version, integer rank), every record stamped with v/t/rank and
    a known kind, step records carrying integer steps, and per-rank
    timestamps monotonic non-decreasing."""
    if not events:
        raise ValueError("empty event log")
    head = events[0]
    if head.get("kind") != "meta":
        raise ValueError(f"first event must be meta, got {head.get('kind')!r}")
    schema = head.get("schema")
    if schema not in SUPPORTED_SCHEMA_VERSIONS:
        raise ValueError(
            f"schema {schema!r} not in supported {SUPPORTED_SCHEMA_VERSIONS}"
        )
    last_t = None
    for i, ev in enumerate(events):
        for field in ("v", "t", "rank", "kind"):
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        if ev["kind"] not in EVENT_KINDS:
            raise ValueError(f"event {i} has unknown kind {ev['kind']!r}")
        if ev["kind"] == "span":
            if schema < 3:
                raise ValueError(
                    f"event {i} is a span but the log is schema v{schema} "
                    "(spans are v3+)"
                )
            if not isinstance(ev.get("span"), str) or not isinstance(
                ev.get("sid"), int
            ):
                raise ValueError(
                    f"span event {i} lacks a str span name / int sid: {ev}"
                )
            for field in ("t0", "t1", "dur"):
                if not isinstance(ev.get(field), (int, float)):
                    raise ValueError(
                        f"span event {i} field {field!r} is not numeric: {ev}"
                    )
            if ev["t1"] < ev["t0"]:
                raise ValueError(f"span event {i} has t1 < t0: {ev}")
        if ev["kind"] == "alert":
            if schema < 4:
                raise ValueError(
                    f"event {i} is an alert but the log is schema "
                    f"v{schema} (alerts are v4+)"
                )
            if not isinstance(ev.get("alert"), str):
                raise ValueError(
                    f"alert event {i} lacks a str alert name: {ev}"
                )
            if ev.get("state") not in ALERT_STATES:
                raise ValueError(
                    f"alert event {i} state {ev.get('state')!r} not in "
                    f"{ALERT_STATES}"
                )
        if ev["rank"] != head["rank"]:
            raise ValueError(
                f"event {i} rank {ev['rank']} != file rank {head['rank']} "
                "(one writer per process)"
            )
        if ev["kind"] == "step" and not isinstance(ev.get("step"), int):
            raise ValueError(f"step event {i} lacks an integer step: {ev}")
        if last_t is not None and ev["t"] < last_t:
            raise ValueError(f"event {i} timestamp regressed: {ev}")
        last_t = ev["t"]
