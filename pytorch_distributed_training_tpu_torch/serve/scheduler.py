"""Iteration-level continuous batching: admit into freed slots every tick.
The counterpart of the JAX package's ``serve/scheduler.py`` for one
engine (the admission policy, live SLO, span and telemetry hooks are not
ported yet).

- FIFO queue with bounded-queue backpressure (``submit`` refuses past
  ``max_queue``), round-robin across tenants, FIFO within one;
- every tick: shed queued requests past their deadline, cancel in-flight
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
    ):
        self.engine = engine
        self.max_queue = max_queue
        self.clock = clock
        self.request_logger = request_logger
        self.queue: deque[Request] = deque()
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

    def submit(self, request: Request) -> bool:
        """Enqueue a request; False = refused (queue full — backpressure).
        A request that could never be admitted raises."""
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        try:
            self.engine.validate_request(prompt.size, request.max_new_tokens)
        except ValueError as e:
            raise ValueError(f"request {request.id}: {e}") from None
        if len(self.queue) >= self.max_queue:
            self.rejected += 1
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
            "admitted": None,
            "first_token": None,
            "finish": None,
            "finish_reason": None,
            "generated": 0,
        }
        return True

    @property
    def idle(self) -> bool:
        return not self.queue and not self.engine.busy

    def tick(self) -> list:
        """Shed → cancel → admit → step → record.  Returns engine events."""
        now = self.clock()
        if any(r.deadline is not None for r in self.queue):
            alive: deque[Request] = deque()
            for r in self.queue:
                if r.deadline is not None and r.deadline <= now:
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
            self.engine.start(r.id, r.prompt, r.max_new_tokens)
            self.records[r.id]["admitted"] = self.clock()
        self.queue_depth_samples.append(len(self.queue))
        self.active_slot_samples.append(self.engine.pool.num_active)
        events = cancel_events + self.engine.step()
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
        return events

    def _finish(self, rec: dict, now: float, reason: str) -> None:
        rec["finish"] = now
        rec["finish_reason"] = reason
        finalize_record(rec)
        self.completed.append(rec)
        if self.request_logger is not None:
            self.request_logger.log(rec)

    def _drop_tenant_count(self, tenant) -> None:
        n = self._tenant_counts.get(tenant, 0) - 1
        if n > 0:
            self._tenant_counts[tenant] = n
        else:
            self._tenant_counts.pop(tenant, None)

    def _admit_candidate(self) -> Request:
        """Next request to admit: round-robin across queued tenants
        (resuming after the one admitted last), FIFO within a tenant."""
        if len(self._tenant_counts) <= 1:
            return self.queue[0]
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
