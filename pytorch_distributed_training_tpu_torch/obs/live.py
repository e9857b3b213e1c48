"""Live aggregation over the telemetry spine: one spine, two sinks.

Everything the obs spine produces was post-hoc until this module: the
emitter writes JSONL and ``tools/telemetry_report.py`` reduces it after
the run.  A control plane (SLO-weighted scheduling, role re-splitting,
autoscaling) needs the SAME signals while the process runs.  :class:`LiveAggregator` is the online
reader: it attaches to :class:`~.emitter.MetricsEmitter` as a **sink**
(``emitter.attach_sink``) and receives every counter add, gauge write,
histogram sample, and structured event the spine already carries — no
second instrumentation path, so live and post-hoc views reduce one
record stream.

Two design rules make the live numbers trustworthy:

- **Fixed-log-bucket histograms** (:class:`FixedLogHistogram`): samples
  land in deterministic log-spaced buckets (``GROWTH = 2**(1/8)``, ~9%
  relative width — the Prometheus native-histogram schema-3 spacing).
  Bucket boundaries are a pure function of the index, so histograms
  MERGE by adding counts — across rolling-window slots, ranks, or
  replicas — and a merged quantile equals the whole-stream quantile
  *exactly* (both are the same function of the same bucket counts, not
  a sample or a sketch).  The emitter's closing ``summary`` carries the
  same bucket counts computed independently from its raw sample list,
  which is how ``tools/telemetry_report.py`` recomputes the live
  quantiles offline and the tests pin them EQUAL.
- **Rolling time windows** under the injected clock: per-metric
  time-bucketed slots (``resolution_s``) merged on demand for the SLO
  burn-rate windows (obs/slo.py's fast 1m / slow 10m).  Time comes from
  the emitter's own clock, so scripted traces (VirtualClock) evaluate
  deterministically and tests can pin alert transitions to exact ticks.

The aggregator is thread-safe (one lock around state): the mutating
side is the host control loop (scheduler tick / trainer step), the
reading side is the ops HTTP thread (obs/http.py) serving ``/metrics``,
``/healthz``, ``/slo``.  Nothing here touches a device or runs inside
a device kernel — the whole plane is host-thread-only.

The port's own copy of the JAX package's ``obs/live.py``: the same
bucket geometry, windows and names, so the JAX package's tools reduce
the port's logs to the same numbers.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from typing import Any, Callable

# Log-bucket geometry: bucket i covers (GROWTH**(i-1), GROWTH**i], i.e.
# 8 buckets per octave (2**(1/8) ~ 1.0905, <= ~9.05% relative error on a
# bucket-upper-bound quantile).  Values <= 0 land in the ZERO bucket.
BUCKETS_PER_OCTAVE = 8
GROWTH = 2.0 ** (1.0 / BUCKETS_PER_OCTAVE)
ZERO_BUCKET = "zero"


def bucket_index(value: float) -> int:
    """Deterministic bucket index for ``value > 0``: the smallest ``i``
    with ``GROWTH**i >= value``.  The ONE bucketing function — the live
    aggregator, the emitter's summary reduction, and the offline report
    all call it, so their bucket counts are identical by construction."""
    if value <= 0:
        raise ValueError(f"bucket_index wants value > 0, got {value}")
    return math.ceil(round(math.log2(value) * BUCKETS_PER_OCTAVE, 9))


def bucket_upper(index: int) -> float:
    """Upper boundary of bucket ``index`` (its reported quantile value)."""
    return 2.0 ** (index / BUCKETS_PER_OCTAVE)


class FixedLogHistogram:
    """Mergeable fixed-bucket histogram: ``{bucket index: count}`` plus a
    zero-bucket, exact count/sum/max.  ``merge(a, b)`` then ``quantile``
    equals bucketing the concatenated stream — quantiles are pure
    functions of bucket counts (nearest-rank, reported at the containing
    bucket's UPPER bound), so splits across windows/ranks/replicas cannot
    change the answer."""

    __slots__ = ("counts", "zero", "count", "sum", "max")

    def __init__(self):
        self.counts: dict[int, int] = {}
        self.zero = 0
        self.count = 0
        self.sum = 0.0
        self.max: float | None = None

    def add(self, value: float) -> None:
        value = float(value)
        if value <= 0.0:
            self.zero += 1
        else:
            i = bucket_index(value)
            self.counts[i] = self.counts.get(i, 0) + 1
        self.count += 1
        self.sum += value
        self.max = value if self.max is None else max(self.max, value)

    def merge(self, other: "FixedLogHistogram") -> "FixedLogHistogram":
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.zero += other.zero
        self.count += other.count
        self.sum += other.sum
        if other.max is not None:
            self.max = (
                other.max if self.max is None else max(self.max, other.max)
            )
        return self

    def quantile(self, q: float) -> float | None:
        return quantile_from_buckets(self.bucket_counts(), q)

    def count_above(self, threshold: float) -> int:
        """Samples strictly above ``threshold``'s bucket — the SLI "bad"
        count for a latency objective (obs/slo.py).  The threshold snaps
        to its containing bucket's upper bound, so the split is a pure
        function of bucket counts and merges exactly."""
        if threshold <= 0:
            return self.count - self.zero
        ti = bucket_index(threshold)
        return sum(c for i, c in self.counts.items() if i > ti)

    def bucket_counts(self) -> dict[str, int]:
        """JSON-shaped counts (string keys; the summary/report wire
        format): ``{"zero": n?, "<index>": count...}``."""
        out: dict[str, int] = {}
        if self.zero:
            out[ZERO_BUCKET] = self.zero
        for i in sorted(self.counts):
            out[str(i)] = self.counts[i]
        return out


def bucket_counts_of(samples) -> dict[str, int]:
    """Batch-bucket a raw sample list — the emitter's summary path.
    Independent of the aggregator's incremental accumulation, which is
    exactly what makes the live-vs-offline equality a real cross-check."""
    h = FixedLogHistogram()
    for x in samples:
        if x is not None:
            h.add(x)
    return h.bucket_counts()


def quantile_from_buckets(
    buckets: dict[str, int], q: float
) -> float | None:
    """Nearest-rank quantile from wire-format bucket counts: rank
    ``ceil(q/100 * n)`` walked over zero-then-ascending buckets, reported
    at the containing bucket's upper bound.  Shared by the live snapshot
    and the offline report — equality is by construction."""
    total = sum(buckets.values())
    if total == 0:
        return None
    rank = min(max(math.ceil(q / 100.0 * total), 1), total)
    seen = buckets.get(ZERO_BUCKET, 0)
    if rank <= seen:
        return 0.0
    for i in sorted(int(k) for k in buckets if k != ZERO_BUCKET):
        seen += buckets[str(i)]
        if rank <= seen:
            return bucket_upper(i)
    return None  # unreachable for consistent counts


# ---------------------------------------------------------------------- #
# metric-name labels
# ---------------------------------------------------------------------- #

# The spine carries labels in metric NAMES, two spellings:
#   - bracket labels: "ttft_s[tenant=acme]" (scheduler per-tenant views);
#   - the replica suffix: "serve_slots_active_r2" (gauges under a
#     multi-replica router share one emitter).
# parse_metric_name() is the one decoder — the Prometheus exposition
# (obs/http.py) and the healthz liveness keys both use it.
_BRACKET_RE = re.compile(r"^(?P<base>[^\[\]]+)\[(?P<labels>[^\[\]]*)\]$")
_REPLICA_RE = re.compile(r"^(?P<base>.+)_r(?P<k>\d+)$")


def parse_metric_name(name: str) -> tuple[str, dict[str, str]]:
    labels: dict[str, str] = {}
    mo = _BRACKET_RE.match(name)
    if mo:
        name = mo.group("base")
        for part in mo.group("labels").split(","):
            if part and "=" in part:
                k, v = part.split("=", 1)
                labels[k.strip()] = v.strip()
    mo = _REPLICA_RE.match(name)
    if mo:
        name = mo.group("base")
        labels.setdefault("replica", mo.group("k"))
    return name, labels


def labeled(name: str, **labels: Any) -> str:
    """Compose a bracket-labeled metric name (skips None-valued labels):
    ``labeled("ttft_s", tenant="acme") == "ttft_s[tenant=acme]"``."""
    kept = {k: v for k, v in labels.items() if v is not None}
    if not kept:
        return name
    inner = ",".join(f"{k}={kept[k]}" for k in sorted(kept))
    return f"{name}[{inner}]"


# Gauge base names whose writes prove a component alive (/healthz): the
# scheduler writes them every tick, per replica under a router and per
# role under the disaggregated tier.
_LIVENESS_GAUGES = {
    "serve_slots_active": "serve",
    "router_queue_depth": "router",
    "serve_prefill_slots_active": "role:prefill",
    "serve_decode_slots_active": "role:decode",
}

# Of those, the bases the REPLICA's own scheduler writes — only these
# refresh the per-replica heartbeat.  The router's per-replica gauges
# (router_queue_depth_r<k>) are the ROUTER's view of the replica and
# keep flowing for a dead one; counting them as the replica's pulse
# would hide exactly the death the failover controller watches for.
_REPLICA_LIVENESS_BASES = {
    "serve_slots_active", "serve_prefill_slots_active",
    "serve_decode_slots_active",
}

# Span names the live TTFT decomposition needs (obs.spans).
_DECOMP_SPANS = (
    "serve/request", "request/queued", "request/prefill",
    "request/decode", "serve/prefill",
)


class LiveAggregator:
    """The online reduction of one process's telemetry spine.

    Attach to the emitter with ``emitter.attach_sink(agg)``; from then on
    every ``counter_add``/``gauge``/``observe`` and every structured
    event tees here (cumulative state + rolling windows) as it is
    written.  ``clock`` should be the EMITTER's clock so windowed state
    and event timestamps share one timebase (scripted VirtualClock runs
    included); ``resolution_s`` is the window slot width — burn-rate
    windows are merged from whole slots, so transitions land on slot
    boundaries deterministically.
    """

    def __init__(
        self,
        *,
        clock: Callable[[], float] = time.monotonic,
        max_window_s: float = 600.0,
        resolution_s: float = 1.0,
        span_limit: int = 4096,
    ):
        if resolution_s <= 0 or max_window_s < resolution_s:
            raise ValueError(
                f"want 0 < resolution_s <= max_window_s, got "
                f"{resolution_s} / {max_window_s}"
            )
        self.clock = clock
        self.max_window_s = float(max_window_s)
        self.resolution_s = float(resolution_s)
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._counter_slots: dict[str, dict[int, float]] = {}
        self._gauges: dict[str, float] = {}
        self._gauge_t: dict[str, float] = {}
        self._hists: dict[str, FixedLogHistogram] = {}
        self._hist_slots: dict[str, dict[int, FixedLogHistogram]] = {}
        self._alive: dict[str, float] = {}
        self._events_by_kind: dict[str, int] = {}
        self._spans: deque = deque(maxlen=span_limit)
        # Completed-slot window caches: merging W/resolution slots on
        # every burn-rate evaluation would grow the steady-state cost
        # with the window length (600 merges/objective/tick at the 10m
        # window).  Slots BEFORE the current one are immutable (samples
        # land at clock-now), so their merge is computed once per slot
        # advance and only the live slot is merged fresh per query.
        self._hist_win_cache: dict[
            tuple, tuple[tuple[int, int], FixedLogHistogram]
        ] = {}
        self._ctr_win_cache: dict[tuple, tuple[tuple[int, int], float]] = {}

    # ---- sink interface (called by MetricsEmitter) ---------------------

    def counter_add(self, name: str, value: float) -> None:
        now = self.clock()
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value
            slots = self._counter_slots.setdefault(name, {})
            s = self._slot(now)
            fresh = s not in slots
            slots[s] = slots.get(s, 0.0) + value
            if fresh:
                # Prune only on slot advance: scanning the slot dict per
                # SAMPLE would cost O(window/resolution) on every write
                # at steady state; once per slot bounds it to once per
                # resolution interval per metric.
                self._prune(slots, now)

    def gauge(self, name: str, value: float) -> None:
        now = self.clock()
        with self._lock:
            self._gauges[name] = value
            self._gauge_t[name] = now
            base, labels = parse_metric_name(name)
            key = _LIVENESS_GAUGES.get(base)
            if key is not None:
                if "replica" in labels and base in _REPLICA_LIVENESS_BASES:
                    self._alive[f"replica{labels['replica']}"] = now
                self._alive[key] = now

    def observe(self, name: str, value: float) -> None:
        now = self.clock()
        with self._lock:
            self._hists.setdefault(name, FixedLogHistogram()).add(value)
            slots = self._hist_slots.setdefault(name, {})
            s = self._slot(now)
            fresh = s not in slots
            slots.setdefault(s, FixedLogHistogram()).add(value)
            if fresh:  # prune once per slot advance, not per sample
                self._prune(slots, now)

    def event(self, record: dict[str, Any]) -> None:
        with self._lock:
            kind = record.get("kind", "?")
            self._events_by_kind[kind] = (
                self._events_by_kind.get(kind, 0) + 1
            )
            # Any event proves its writer alive; the record's own t is on
            # the emitter clock — the same timebase as ours.
            self._alive[f"rank{record.get('rank', 0)}"] = record.get(
                "t", self.clock()
            )
            if kind == "span" and record.get("span") in _DECOMP_SPANS:
                self._spans.append(record)

    # ---- windows -------------------------------------------------------

    def _slot(self, t: float) -> int:
        return math.floor(t / self.resolution_s)

    def _prune(self, slots: dict[int, Any], now: float) -> None:
        horizon = now - self.max_window_s
        for s in [s for s in slots if (s + 1) * self.resolution_s <= horizon]:
            del slots[s]

    def _window_slots(self, window_s: float, now: float) -> range:
        # Window (now - W, now] at slot granularity: a slot belongs when
        # its END is past the window start, i.e. slots floor((now-W)/res)
        # .. floor(now/res) — deterministic, and with integer script times
        # + resolution 1.0 exactly "the last W seconds of slots".
        return range(self._slot(now - window_s), self._slot(now) + 1)

    def window_counter(
        self, name: str, window_s: float, now: float | None = None
    ) -> float:
        now = self.clock() if now is None else now
        with self._lock:
            slots = self._counter_slots.get(name, {})
            first, cur = self._slot(now - window_s), self._slot(now)
            key = (name, window_s)
            cached = self._ctr_win_cache.get(key)
            if cached is None or cached[0] != (cur, first):
                base = sum(
                    v for s, v in slots.items() if first <= s < cur
                )
                self._ctr_win_cache[key] = ((cur, first), base)
            else:
                base = cached[1]
            return base + slots.get(cur, 0.0)

    def window_hist(
        self, name: str, window_s: float, now: float | None = None
    ) -> FixedLogHistogram:
        now = self.clock() if now is None else now
        out = FixedLogHistogram()
        with self._lock:
            slots = self._hist_slots.get(name, {})
            first, cur = self._slot(now - window_s), self._slot(now)
            key = (name, window_s)
            cached = self._hist_win_cache.get(key)
            if cached is None or cached[0] != (cur, first):
                base = FixedLogHistogram()
                for s, h in slots.items():
                    if first <= s < cur:
                        base.merge(h)
                self._hist_win_cache[key] = ((cur, first), base)
            else:
                base = cached[1]
            out.merge(base)
            live = slots.get(cur)
            if live is not None:
                out.merge(live)
        return out

    # ---- reading -------------------------------------------------------

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def hist(self, name: str) -> FixedLogHistogram | None:
        with self._lock:
            return self._hists.get(name)

    def snapshot(self) -> dict[str, Any]:
        """The full live state as one JSON-able dict — what ``/metrics``
        renders and what the exactness tests pin against the offline
        report's reduction of the same run's JSONL."""
        with self._lock:
            return {
                "t": self.clock(),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    name: {
                        "count": h.count,
                        "sum": h.sum,
                        "max": h.max,
                        "buckets": h.bucket_counts(),
                        "p50": h.quantile(50),
                        "p90": h.quantile(90),
                        "p99": h.quantile(99),
                    }
                    for name, h in self._hists.items()
                },
                "events_by_kind": dict(self._events_by_kind),
            }

    def healthz(self, *, stale_after_s: float = 10.0) -> dict[str, Any]:
        """Per-component liveness from heartbeat staleness: every rank
        that ever emitted an event, plus the serve/router/role/replica
        keys their per-tick gauges prove alive.  ``ok`` is the AND over
        components — the /healthz verdict."""
        now = self.clock()
        with self._lock:
            components = {
                key: {
                    "age_s": round(now - t, 6),
                    "stale": (now - t) > stale_after_s,
                }
                for key, t in sorted(self._alive.items())
            }
        return {
            "ok": bool(components)
            and not any(c["stale"] for c in components.values()),
            "stale_after_s": stale_after_s,
            "components": components,
        }

    def ttft_decomposition(self) -> dict[str, Any] | None:
        """The span-derived TTFT decomposition, live: the same
        ``obs.spans.ttft_decomposition`` reduction the offline report
        runs, over the lifecycle spans teed so far (bounded buffer)."""
        from .spans import ttft_decomposition

        with self._lock:
            spans = list(self._spans)
        return ttft_decomposition(spans) if spans else None
