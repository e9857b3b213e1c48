"""Request-scoped distributed tracing: the span layer on the JSONL spine.

The obs spine (emitter.py) answers *how much* — counters, histograms,
per-step deltas.  Every serving SLO question left is *why*: TTFT p99 says
a request was slow, never whether it sat in the queue, waited for an
interleaved prefill chunk, or burned spec-verify width.  Spans are the
standard answer — causally-linked intervals with a correlation id — and
this module is the low-overhead recorder that emits them as schema-v3
``span`` events through :class:`~.emitter.MetricsEmitter`:

- **monotonic t0/t1** from the emitter's own clock (one timebase for
  spans, step events, and the scheduler's SLO records — the TTFT
  decomposition in ``tools/telemetry_report.py`` cross-checks against
  the histograms *exactly* because nothing is re-clocked);
- **span id + parent id + correlation id**: ``sid`` is unique per
  process, ``parent`` builds the nesting tree, ``corr`` ties every span
  of one request (or one train step) together across scheduler, engine,
  and router — the key the exporter's flow events bind on;
- **deferred serialization**: the hot path appends a :class:`Span` to a
  list; JSON encoding and the file write happen at :meth:`flush`
  (tick/step boundaries and close), so recording a span costs an object
  append, not a syscall;
- **sampling** (``--trace-sample-rate``): per-CORRELATION-ID and
  deterministic (a hash of the id, not a coin flip), so either *every*
  span of a request records or none do — a sampled trace always holds
  complete chains, and two runs over the same ids sample identically.

Spans bracket HOST work — dispatch, device sync, queue wait.  The
phases inside one step (grad-sync tiers, microbatches, pipeline ticks)
stay ``obs.trace.scope`` ranges, which only a ``torch.profiler`` capture
records, and the two layers share one phase vocabulary.  The port's own
copy of the JAX package's ``obs/spans.py``.
"""

from __future__ import annotations

import time
import zlib
from typing import Any, Callable

from .emitter import MetricsEmitter, percentiles

# Canonical span names (the host-side half of the obs.trace vocabulary).
# Request lifecycle (corr = request id):
#   serve/request        arrival -> finish (root; attrs: tenant, replica,
#                        prompt_len, generated, finish_reason)
#   request/queued       arrival -> admitted (or -> finish when shed)
#   request/prefill      admitted -> first token sampled
#   request/decode       first token -> finish
#   router/route         the routing decision (attrs: decision, replica)
# Engine tick anatomy (corr = None; attrs["slots"] attribute the work):
#   serve/prefill        one chunked-prefill program call
#   serve/decode         one decode program call
#   serve/verify         one speculative-verify program call
# Training step anatomy (corr = global step):
#   train/step           one optimizer step's host bracket (attrs carry
#                        the compiled-in anatomy: microbatches, grad-sync
#                        tiers, pipeline ticks — measured per-tier times
#                        live in the profiler capture, not here)
#   train/host_sync      the log-point loss fetch (device wait)
#   train/snapshot       recovery snapshot staging
#   train/checkpoint     step-checkpoint save call
SPAN_NAMES = (
    "serve/request", "request/queued", "request/prefill", "request/decode",
    "router/route",
    "serve/prefill", "serve/decode", "serve/verify",
    "train/step", "train/host_sync", "train/snapshot", "train/checkpoint",
)

def _jsonable(value: Any) -> Any:
    """Correlation ids and attr values must survive ``json.dumps`` — keep
    primitives as-is, stringify everything else (request ids are ``Any``
    by the scheduler's contract)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    return str(value)


class Span:
    """One recorded interval.  Mutable so :meth:`SpanRecorder.end_span`
    can close it in place; ``t1 is None`` means still open."""

    __slots__ = ("name", "sid", "parent", "corr", "t0", "t1", "attrs")

    def __init__(self, name, sid, parent, corr, t0, attrs):
        self.name = name
        self.sid = sid
        self.parent = parent
        self.corr = corr
        self.t0 = t0
        self.t1 = None
        self.attrs = attrs

    @property
    def dur(self) -> float | None:
        return None if self.t1 is None else self.t1 - self.t0

    def __repr__(self) -> str:  # debugging aid only
        return (
            f"Span({self.name!r}, sid={self.sid}, parent={self.parent}, "
            f"corr={self.corr!r}, t0={self.t0}, t1={self.t1})"
        )


class _SpanContext:
    """Context manager for :meth:`SpanRecorder.span` — enters onto the
    recorder's implicit parent stack, closes on exit."""

    __slots__ = ("_rec", "_span")

    def __init__(self, rec, span):
        self._rec = rec
        self._span = span

    def __enter__(self) -> Span | None:
        if self._span is not None:
            self._rec._stack.append(self._span)
        return self._span

    def __exit__(self, *exc) -> None:
        if self._span is not None:
            self._rec._stack.pop()
            self._rec.end_span(self._span)


class SpanRecorder:
    """Low-overhead span recording onto one emitter's event log.

    ``sample_rate`` in [0, 1] gates per correlation id (deterministic —
    see :meth:`sampled`); corr-less spans (engine ticks, train steps
    without an explicit id) always record while the recorder is enabled.
    ``clock`` defaults to the EMITTER's clock so span timestamps share
    the timebase of every other event in the log.  A recorder over a
    disabled emitter (or ``sample_rate <= 0``) is inert: every method
    returns immediately, so call sites thread one object unconditionally.
    """

    def __init__(
        self,
        emitter: MetricsEmitter | None,
        *,
        sample_rate: float = 1.0,
        clock: Callable[[], float] | None = None,
        flush_every: int = 256,
    ):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in [0, 1], got {sample_rate}"
            )
        self.emitter = emitter
        self.sample_rate = float(sample_rate)
        self.enabled = (
            emitter is not None and emitter.enabled and sample_rate > 0.0
        )
        self.clock = clock or (
            emitter.clock if emitter is not None else time.monotonic
        )
        self.flush_every = flush_every
        self.recorded = 0       # spans buffered/emitted
        self.sampled_out = 0    # spans skipped by the sampling decision
        self._next_sid = 1
        self._buffer: list[Span] = []
        self._stack: list[Span] = []

    # ---- sampling -------------------------------------------------------

    def sampled(self, corr: Any) -> bool:
        """The per-correlation-id sampling decision: deterministic (crc32
        of the id's repr mapped to [0, 1)), so every span of one request
        agrees, and two processes tracing the same ids agree too.
        ``corr=None`` (tick/step anatomy spans) always samples."""
        if not self.enabled:
            return False
        if corr is None or self.sample_rate >= 1.0:
            return True
        h = zlib.crc32(repr(corr).encode()) & 0xFFFFFFFF
        return h / 2**32 < self.sample_rate

    # ---- recording ------------------------------------------------------

    def span(self, name: str, *, corr: Any = None, **attrs):
        """Context manager: bracket host work lexically.  Nested ``span``
        calls parent to the enclosing one automatically (the implicit
        stack); yields the :class:`Span` (or None when not recording)."""
        return _SpanContext(self, self.start_span(name, corr=corr, **attrs))

    def start_span(
        self, name: str, *, corr: Any = None, parent: Span | int | None = None,
        t0: float | None = None, **attrs,
    ) -> Span | None:
        """Open a span for non-lexical lifetimes (a queue wait that ends
        several ticks later).  ``parent`` is a Span or a raw sid; when
        omitted, the innermost active :meth:`span` context is the parent."""
        if not self.enabled:
            return None
        if not self.sampled(corr):
            self.sampled_out += 1
            return None
        if parent is None and self._stack:
            parent = self._stack[-1]
        sid = self._next_sid
        self._next_sid += 1
        return Span(
            name, sid,
            parent.sid if isinstance(parent, Span) else parent,
            corr, self.clock() if t0 is None else float(t0), attrs,
        )

    def end_span(
        self, span: Span | None, *, t1: float | None = None, **attrs,
    ) -> None:
        """Close ``span`` and buffer it (serialization is deferred to
        :meth:`flush`).  No-op on None, so the start/end pair needs no
        enabled-checks at the call site."""
        if span is None:
            return
        if span.t1 is not None:
            raise ValueError(f"span {span.name!r} (sid {span.sid}) "
                             "already ended")
        span.t1 = self.clock() if t1 is None else float(t1)
        if attrs:
            span.attrs.update(attrs)
        self._buffer.append(span)
        self.recorded += 1
        if len(self._buffer) >= self.flush_every:
            self.flush()

    def record_span(
        self, name: str, t0: float, t1: float, *, corr: Any = None,
        parent: Span | int | None = None, **attrs,
    ) -> Span | None:
        """Record a completed interval from explicit timestamps — the
        scheduler's request-lifecycle path, which derives its spans from
        the SLO record's own arrival/admitted/first-token/finish stamps
        so span math and histogram math can never disagree."""
        span = self.start_span(name, corr=corr, parent=parent, t0=t0, **attrs)
        if span is not None:
            self.end_span(span, t1=t1)
        return span

    # ---- flushing -------------------------------------------------------

    def flush(self) -> None:
        """Serialize the buffered spans as ``span`` events.  Called from
        tick/step boundaries and :meth:`close`; never on the record path."""
        if not self._buffer:
            return
        buffer, self._buffer = self._buffer, []
        for s in buffer:
            payload = {
                "span": s.name, "sid": s.sid, "t0": s.t0, "t1": s.t1,
                "dur": s.t1 - s.t0,
            }
            if s.parent is not None:
                payload["parent"] = s.parent
            if s.corr is not None:
                payload["corr"] = _jsonable(s.corr)
            if s.attrs:
                payload["attrs"] = _jsonable(s.attrs)
            self.emitter.emit("span", payload)

    def close(self) -> None:
        """Flush the completed spans.  Open spans (still on the stack or
        never ended) are dropped by construction — only :meth:`end_span`
        buffers, so a span without a t1 never reaches the log."""
        self.flush()


# ---------------------------------------------------------------------- #
# span-side TTFT decomposition (tools/telemetry_report.py's section)
# ---------------------------------------------------------------------- #


def span_events(events: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """The ``span`` records of one rank's event list."""
    return [e for e in events if e.get("kind") == "span"]


def ttft_decomposition(spans: list[dict[str, Any]]) -> dict[str, Any] | None:
    """Attribute every traced request's TTFT to its anatomy:

    - **queue_wait**: the ``request/queued`` span (arrival → admitted);
    - **prefill_compute**: the summed durations of the engine's
      ``serve/prefill`` tick spans whose slot attribution includes this
      request — wall time the request's prompt actually occupied the
      compiled prefill program (chunks are batched, so concurrent
      requests each count the full chunk: it is *their* wall time too);
    - **sched_delay**: the rest of the ``request/prefill`` window —
      ticks the admitted request sat between interleaved chunks waiting
      for the scheduler to come back around.

    ``queue_wait + prefill_compute + sched_delay == TTFT`` by
    construction (the lifecycle spans are derived from the same record
    timestamps the TTFT histograms reduce), which is exactly the
    cross-check ``tools/telemetry_report.py`` applies.  Returns None when
    no request chains were traced.  Aggregates overall plus per-tenant
    and per-replica (span attrs)."""
    queued: dict[Any, dict] = {}
    prefill_win: dict[Any, dict] = {}
    meta: dict[Any, dict] = {}
    compute: dict[Any, float] = {}
    for ev in spans:
        name, corr = ev.get("span"), ev.get("corr")
        if name == "request/queued" and corr is not None:
            queued[corr] = ev
        elif name == "request/prefill" and corr is not None:
            prefill_win[corr] = ev
        elif name == "serve/request" and corr is not None:
            meta[corr] = ev.get("attrs", {})
        elif name == "serve/prefill":
            for entry in ev.get("attrs", {}).get("slots", ()):
                # [slot, request_id, tokens]
                rid = entry[1]
                compute[rid] = compute.get(rid, 0.0) + ev["dur"]
    rows = []
    for corr, pf in prefill_win.items():
        if corr not in queued:
            continue  # partial trace (request still in flight at close)
        if meta.get(corr, {}).get("finish_reason") in ("shed", "cancelled"):
            # The histograms exclude these (nobody was waiting); the
            # decomposition matches so the cross-check stays exact.
            continue
        q = queued[corr]["dur"]
        c = min(compute.get(corr, 0.0), pf["dur"])
        rows.append({
            "corr": corr,
            "queue_wait_s": q,
            "prefill_compute_s": c,
            "sched_delay_s": pf["dur"] - c,
            "ttft_s": q + pf["dur"],
            "tenant": meta.get(corr, {}).get("tenant"),
            "replica": meta.get(corr, {}).get("replica"),
        })
    if not rows:
        return None

    def _agg(sub):
        out = {"requests": len(sub)}
        for key in ("queue_wait_s", "prefill_compute_s", "sched_delay_s",
                    "ttft_s"):
            xs = [r[key] for r in sub]
            out[key] = {
                "mean": sum(xs) / len(xs),
                **percentiles(xs, (50,)),
            }
        return out

    report = _agg(rows)
    tenants = sorted({r["tenant"] for r in rows} - {None}, key=str)
    if tenants:
        report["per_tenant"] = {
            str(t): _agg([r for r in rows if r["tenant"] == t])
            for t in tenants
        }
    replicas = sorted({r["replica"] for r in rows} - {None}, key=str)
    if replicas:
        report["per_replica"] = {
            str(k): _agg([r for r in rows if r["replica"] == k])
            for k in replicas
        }
    return report
