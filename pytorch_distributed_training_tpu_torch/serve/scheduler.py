"""Iteration-level continuous batching: admit into freed slots every tick.
The counterpart of the JAX package's ``serve/scheduler.py`` for one
engine, with its telemetry hooks: ``emitter`` (TTFT and TPOT histograms,
the shed, cancelled and rejected counters, the engine's gauges and
counter deltas every tick, a flight recorder for queue saturation),
``spans`` (each request's ``serve/request`` chain, and the engine's
slot-attributed tick spans), ``slo`` (evaluated once a tick) and
``replica`` (stamped on every record, label of the histograms) and
``policy`` (``--serve-priority``'s weighted-deficit pop over the tenants,
``serve/policy.py``, in place of the plain rotation).

- FIFO queue with bounded-queue backpressure (``submit`` refuses past
  ``max_queue``; ``force=True``, the failover requeue, enqueues past it),
  round-robin across tenants, FIFO within one;
- every tick: shed queued requests past their deadline (``brownout_margin``
  seconds early while the failover controller runs the tier under
  capacity), cancel in-flight
  ones past it, admit while ``engine.can_admit`` (a free slot, and for the
  paged pool enough unreserved blocks net of prefix hits; a candidate too
  big for now waits at the head), step the engine once;
- per-request arrival/admission/first-token/finish timestamps, finalized
  into TTFT/TPOT records (serve/metrics.py) and optionally logged as JSONL.

Time is injected (``clock``) so scripted traces run deterministically
(``VirtualClock``) while the CLI uses the wall clock.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np

from ..obs import labeled
from .engine import ServingEngine
from .metrics import finalize_record


@dataclasses.dataclass
class Request:
    id: Any
    prompt: np.ndarray  # (P,) int32 token ids
    max_new_tokens: int
    arrival_time: float = 0.0
    # Absolute admission deadline (scheduler-clock seconds): still queued
    # past it, the request is shed; in flight past it, cancelled.
    deadline: float | None = None
    # Fair-admission class (None = the shared default class).
    tenant: Any = None


# Initial rotation sentinel: distinct from every legal tenant value
# (None included — it is the default tenant class).
_NO_TENANT = object()


class VirtualClock:
    """Deterministic clock for scripted traces: time moves only when the
    caller advances it."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


class ContinuousScheduler:
    def __init__(
        self,
        engine: ServingEngine,
        *,
        max_queue: int = 64,
        clock: Callable[[], float] = time.monotonic,
        request_logger=None,
        emitter=None,
        replica: int | None = None,
        spans=None,
        slo=None,
        policy=None,
    ):
        self.engine = engine
        # The admission policy (serve/policy.py), shared tier-wide; its
        # deficit state for this queue lives on this scheduler.
        self.policy = policy
        self.max_queue = max_queue
        self.clock = clock
        self.request_logger = request_logger
        # Evaluated once a tick, after the tick's records landed.
        self.slo = slo
        # The request chains come from the records' own timestamps, so
        # span math and histogram math cannot disagree; the engine gets
        # the recorder for its tick spans.
        self.spans = spans
        if spans is not None:
            engine.spans = spans
            engine.spans_replica = replica
        self.replica = replica
        self.emitter = emitter
        self.recorder = None
        if emitter is not None:
            from ..obs import FlightRecorder

            self.recorder = FlightRecorder(emitter)
        self._last_stats: dict = {}
        self.queue: deque[Request] = deque()
        # Raised above zero by the failover controller while the tier runs
        # under capacity: queued requests shed this many seconds before
        # their deadline (brown-out).
        self.brownout_margin = 0.0
        self._last_tenant: Any = _NO_TENANT
        # Queued tenants -> queued-request count (the one-tenant fast path).
        self._tenant_counts: dict = {}
        self.records: dict[Any, dict] = {}
        self.completed: list[dict] = []
        self.rejected = 0
        self.shed = 0
        self.cancelled = 0
        self.queue_depth_samples: list[int] = []
        self.active_slot_samples: list[int] = []

    def submit(self, request: Request, *, force: bool = False) -> bool:
        """Enqueue a request; False = refused (queue full — backpressure).
        A request that could never be admitted raises.  ``force=True``
        (the failover requeue, ``serve/router.py``) enqueues past the
        bound: migrated work was admitted once already, and backpressure
        belongs at the tier's edge, not between replicas."""
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        try:
            self.engine.validate_request(prompt.size, request.max_new_tokens)
        except ValueError as e:
            raise ValueError(f"request {request.id}: {e}") from None
        if len(self.queue) >= self.max_queue and not force:
            self.rejected += 1
            if self.emitter is not None:
                self.emitter.counter_add("rejected_requests", 1)
            return False
        self.queue.append(request)
        self._tenant_counts[request.tenant] = (
            self._tenant_counts.get(request.tenant, 0) + 1
        )
        self.records[request.id] = {
            "id": request.id,
            "prompt_len": int(prompt.size),
            "max_new_tokens": int(request.max_new_tokens),
            "arrival": float(request.arrival_time),
            "deadline": (
                float(request.deadline) if request.deadline is not None
                else None
            ),
            "tenant": request.tenant,
            "replica": self.replica,
            "admitted": None,
            "first_token": None,
            "finish": None,
            "finish_reason": None,
            "generated": 0,
            # Failover provenance (serve/failover.py): the re-placements
            # after replica deaths, and every replica that held the
            # request, in order; the controller rewrites both on a requeue.
            "retries": 0,
            "replica_history": (
                [self.replica] if self.replica is not None else []
            ),
        }
        return True

    @property
    def idle(self) -> bool:
        return not self.queue and not self.engine.busy

    def tick(self) -> list:
        """Shed → cancel → admit → step → record.  Returns engine events."""
        return self.finish_tick(self.begin_tick() + self.engine.step())

    def begin_tick(self) -> list:
        """The tick up to the engine's step: shed, cancel, admit.  Returns
        the cancellations' events (a router steps a replica led by another
        process between this and :meth:`finish_tick`)."""
        now = self.clock()
        if any(r.deadline is not None for r in self.queue):
            horizon = now + self.brownout_margin
            alive: deque[Request] = deque()
            for r in self.queue:
                if r.deadline is not None and r.deadline <= horizon:
                    self._shed(r, now)
                else:
                    alive.append(r)
            self.queue = alive
        cancel_events = []
        for rid in self.engine.live_requests():
            deadline = self.records[rid].get("deadline")
            if deadline is not None and deadline <= now:
                cancel_events.append(self.engine.cancel(rid))
        while self.queue:
            r = self._admit_candidate()
            if not self.engine.can_admit(r.prompt, r.max_new_tokens):
                break
            if r is self.queue[0]:
                self.queue.popleft()
            else:
                self.queue.remove(r)
            self._drop_tenant_count(r.tenant)
            self._last_tenant = r.tenant
            if self.policy is not None:
                # Only a successful admission spends credit: a blocked
                # head keeps its turn.
                self.policy.on_admit(self, r)
            self.engine.start(r.id, r.prompt, r.max_new_tokens)
            rec = self.records[r.id]
            if rec["admitted"] is None:
                # A failover requeue keeps the request's original stamp,
                # so admitted never follows the restored first token.
                rec["admitted"] = self.clock()
        self.queue_depth_samples.append(len(self.queue))
        self.active_slot_samples.append(self.engine.pool.num_active)
        if self.recorder is not None:
            self.recorder.check_queue(len(self.queue), self.max_queue)
        return cancel_events

    def finish_tick(self, events: list) -> list:
        """Record a tick's engine ``events`` (the cancellations' first)."""
        if self.emitter is not None:
            self._emit_engine_stats()
        now = self.clock()
        for ev in events:
            rec = self.records[ev.request_id]
            if ev.kind == "token":
                rec["generated"] += 1
                if rec["first_token"] is None:
                    rec["first_token"] = now
                continue
            if ev.reason == "cancelled":
                self.cancelled += 1
            self._finish(rec, now, ev.reason)
        if self.slo is not None:
            self.slo.evaluate(now)
        if self.spans is not None:
            # Deferred serialization drains at the tick boundary.
            self.spans.flush()
        return events

    def _finish(self, rec: dict, now: float, reason: str) -> None:
        rec["finish"] = now
        rec["finish_reason"] = reason
        finalize_record(rec)
        self._record_request_spans(rec)
        self.completed.append(rec)
        if self.request_logger is not None:
            self.request_logger.log(rec)
        if self.emitter is None:
            return
        if reason == "shed":
            self.emitter.counter_add("shed_requests", 1)
            self.emitter.emit("record", {
                "record": "request_shed", "id": rec["id"],
                "queued_s": now - rec["arrival"],
            })
        elif reason == "cancelled":
            # Kept out of the SLO histograms and the goodput tokens.
            self.emitter.counter_add("cancelled_requests", 1)
            self.emitter.emit("record", {
                "record": "request_cancelled", "id": rec["id"],
                "generated": rec["generated"],
                "overdue_s": now - rec["deadline"],
            })
        else:
            # The plain names feed the SLO objectives; the labeled ones
            # are the per-tenant / per-replica views (obs/live.py).
            views = [{}]
            if rec["tenant"] is not None:
                views.append({"tenant": rec["tenant"]})
            if rec["replica"] is not None:
                views.append({"replica": rec["replica"]})
            for view in views:
                if rec.get("ttft") is not None:
                    self.emitter.observe(labeled("ttft_s", **view),
                                         rec["ttft"])
                if rec.get("tpot") is not None:
                    self.emitter.observe(labeled("tpot_s", **view),
                                         rec["tpot"])
                self.emitter.counter_add(
                    labeled("generated_tokens", **view), rec["generated"])
                self.emitter.counter_add(
                    labeled("finished_requests", **view), 1)
            self.emitter.emit("record", {
                "record": "request_finish", "id": rec["id"],
                "finish_reason": rec["finish_reason"],
                "generated": rec["generated"],
            })

    def _record_request_spans(self, rec: dict) -> None:
        """The finished request's chain from the record's timestamps:
        ``serve/request`` (arrival → finish) parenting ``request/queued``
        (arrival → admitted), ``request/prefill`` (admitted → first
        token) and ``request/decode`` (first token → finish).  A shed
        request, or one cancelled before its first token, carries the
        queued leg alone.  Sampled per request id: whole or not at all."""
        if self.spans is None or not self.spans.enabled:
            return
        corr = rec["id"]
        root = self.spans.start_span(
            "serve/request", corr=corr, t0=rec["arrival"],
            tenant=rec["tenant"], replica=rec["replica"],
            prompt_len=rec["prompt_len"],
        )
        if root is None:  # not sampled
            return
        queued_end = (rec["admitted"] if rec["admitted"] is not None
                      else rec["finish"])
        extra = ({"replica": rec["replica"]} if rec["replica"] is not None
                 else {})
        self.spans.record_span("request/queued", rec["arrival"], queued_end,
                               corr=corr, parent=root, **extra)
        if rec["admitted"] is not None and rec["first_token"] is not None:
            self.spans.record_span(
                "request/prefill", rec["admitted"], rec["first_token"],
                corr=corr, parent=root, **extra)
            self.spans.record_span(
                "request/decode", rec["first_token"], rec["finish"],
                corr=corr, parent=root, **extra)
        self.spans.end_span(root, t1=rec["finish"],
                            generated=rec["generated"],
                            finish_reason=rec["finish_reason"])

    def _emit_engine_stats(self) -> None:
        """The engine's accounting every tick: gauges for the slots and
        the paged pool's occupancy, counter deltas for its monotonic
        stats, and the speculation histograms."""
        st = self.engine.stats()
        sfx = f"_r{self.replica}" if self.replica is not None else ""
        self.emitter.gauge(f"serve_slots_active{sfx}", st["slots_active"])
        if "prefill_slots_active" in st:
            # The disaggregated tier's occupancy a role.
            self.emitter.gauge(f"serve_prefill_slots_active{sfx}",
                               st["prefill_slots_active"])
            self.emitter.gauge(f"serve_decode_slots_active{sfx}",
                               st["decode_slots_active"])
        if "blocks_in_use" in st:
            self.emitter.gauge(f"kv_blocks_in_use{sfx}", st["blocks_in_use"])
            self.emitter.gauge(f"kv_blocks_cached{sfx}", st["blocks_cached"])
            self.emitter.gauge(f"kv_block_occupancy{sfx}",
                               st["block_occupancy"])
        if "host_blocks" in st:
            self.emitter.gauge(f"kv_host_blocks{sfx}", st["host_blocks"])
            self.emitter.gauge(f"kv_host_bytes{sfx}", st["host_bytes"])
            if "kv_block_bytes" in st:
                self.emitter.gauge(f"kv_block_bytes{sfx}",
                                   st["kv_block_bytes"])
        for name in (
            "prefill_tokens_computed", "prefill_tokens_offered",
            "prefix_hit_tokens", "prefix_lookup_tokens", "blocks_evicted",
            "cow_copies", "decode_ticks", "decode_slot_ticks",
            "decode_tokens", "spec_drafted_tokens", "spec_accepted_tokens",
            "blocks_spilled", "blocks_restored", "blocks_sibling_fetched",
            "host_dropped_blocks", "handoffs",
        ):
            if name in st:
                delta = st[name] - self._last_stats.get(name, 0)
                if delta:
                    self.emitter.counter_add(name, delta)
        if "spec_drafted_tokens" in st:
            drafted = (st["spec_drafted_tokens"]
                       - self._last_stats.get("spec_drafted_tokens", 0))
            if drafted:
                acc = (st["spec_accepted_tokens"]
                       - self._last_stats.get("spec_accepted_tokens", 0))
                self.emitter.observe("spec_acceptance_rate", acc / drafted)
            slot_ticks = (st["decode_slot_ticks"]
                          - self._last_stats.get("decode_slot_ticks", 0))
            if slot_ticks:
                toks = (st["decode_tokens"]
                        - self._last_stats.get("decode_tokens", 0))
                self.emitter.observe("spec_tokens_per_slot_tick",
                                     toks / slot_ticks)
        self._last_stats = st

    def _drop_tenant_count(self, tenant) -> None:
        n = self._tenant_counts.get(tenant, 0) - 1
        if n > 0:
            self._tenant_counts[tenant] = n
        else:
            self._tenant_counts.pop(tenant, None)

    def _admit_candidate(self) -> Request:
        """Next request to admit: round-robin across queued tenants
        (resuming after the one admitted last), FIFO within a tenant; with
        a policy, its weighted-deficit pop."""
        if len(self._tenant_counts) <= 1:
            return self.queue[0]
        if self.policy is not None:
            return self.policy.admit_candidate(self)
        order: list = []
        seen: set = set()
        for r in self.queue:
            if r.tenant not in seen:
                seen.add(r.tenant)
                order.append(r.tenant)
        if self._last_tenant in seen:
            i = order.index(self._last_tenant)
            order = order[i + 1:] + order[:i + 1]
        tenant = order[0]
        return next(r for r in self.queue if r.tenant == tenant)

    def _shed(self, request: Request, now: float) -> None:
        """Finalize a deadline-expired queued request without admitting it."""
        self._drop_tenant_count(request.tenant)
        self.shed += 1
        self._finish(self.records[request.id], now, "shed")

    def run(
        self,
        requests: list[Request],
        *,
        sleep: Callable[[float], None] | None = None,
    ) -> list[dict]:
        """Drive a full trace: submit each request when the clock reaches
        its ``arrival_time``, ticking until everything submitted finished.
        ``sleep`` bridges idle gaps (``time.sleep`` by default; pass the
        virtual clock's ``advance`` for scripted runs).  Refused
        submissions are counted, not retried.  Returns the records."""
        if sleep is None:
            sleep = time.sleep
        pending = sorted(requests, key=lambda r: r.arrival_time)
        i = 0
        while i < len(pending) or not self.idle:
            now = self.clock()
            while i < len(pending) and pending[i].arrival_time <= now:
                self.submit(pending[i])
                i += 1
            if not self.idle:
                self.tick()
            elif i < len(pending):
                sleep(max(pending[i].arrival_time - now, 0.0))
        return self.completed
