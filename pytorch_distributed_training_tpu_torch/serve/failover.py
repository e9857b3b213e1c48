"""Router-level replica failover: detect, fence, drain, requeue, exactly
once.  The counterpart of the JAX package's ``serve/failover.py``.

- **Detection** reads the tier's own signals, never the chaos plane's
  ground truth: a replica that misses ``miss_threshold`` consecutive
  router ticks is dead; so is one whose heartbeat gauges go stale in the
  live aggregator (``obs/live.py``, the ``/healthz`` signal, when one is
  attached); one completing ticks at under ``1/degrade_skew`` the fleet
  median rate is degraded (a ``straggler_skew`` anomaly, no new work, no
  drain).
- **Fence and drain.**  A dead replica is fenced first (the router never
  ticks it again until the respawn, so a stalled one coming back cannot
  emit twice), then its queued and in-flight requests are requeued onto
  the survivors through the router's own routing.  An in-flight request
  re-prefills ``prompt + the tokens already streamed`` with the budget
  left, so greedy output equals an unkilled run's.
- **Exactly once.**  Every admitted request is tracked; any finish
  retires its id, and a drain or the orphan sweep that meets a retired id
  suppresses the requeue (``duplicates_suppressed``).
- **Degradation.**  A request carries a retry budget (``retries`` and
  ``replica_history`` ride its record); past it the request finishes
  ``"failed"``, out of goodput.  While the tier runs under capacity the
  survivors shed queued requests ``brownout_margin_s`` before their
  deadline.  A dead replica respawns after the training supervisor's
  capped exponential backoff (``utils/backoff.py``).

A disaggregated replica's role death is the finer unit: the stranded
requests requeue into the surviving capacity and the role respawns on
the same backoff.  Everything here is host logic on the router's clock.
A respawn or an autoscale retirement calls ``engine.reset()``: the
pools stay resident on the card, nothing is allocated again.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np

from ..utils.backoff import BackoffPolicy
from .metrics import finalize_record
from .scheduler import Request

# Detection defaults, JAX's: dead after MISS_THRESHOLD consecutive missed
# ticks; degraded under half the fleet-median tick rate over the last
# SKEW_WINDOW ticks once MIN_SKEW_OBS of them are observed.  A replica
# answering once in F ticks misses F - 1 in a row, so any F above the
# threshold reads as dead; the default keeps the death patience above
# the skew detector's warm-up so ordinary stragglers degrade first.
MISS_THRESHOLD = 8
DEGRADE_SKEW = 2.0
SKEW_WINDOW = 16
MIN_SKEW_OBS = 8
DEFAULT_RETRY_BUDGET = 2
# The heartbeat staleness bound (the router's clock), the CLI's
# --healthz-stale-s default: one bound for /healthz and this detector.
STALE_AFTER_S = 60.0


@dataclasses.dataclass
class _Tracked:
    """The router's own replay state for one admitted request (a dead
    replica's state is never read)."""

    request: Request            # the original request
    history: list               # replicas it was placed on, in order
    tokens: list = dataclasses.field(default_factory=list)
    retries: int = 0
    # The original admission and first-token stamps, harvested at drain
    # time: TTFT survives the failover and the span chain stays monotone.
    first_token: float | None = None
    admitted: float | None = None


@dataclasses.dataclass
class ReplicaHealth:
    # "up" | "degraded" | "role_dead" | "dead" | "parked" ("parked": an
    # autoscale retirement, drained, reset and fenced but healthy: no
    # anomaly, no respawn timer, no brown-out, skipped by the detectors).
    state: str = "up"
    deaths: int = 0
    dead_role: str | None = None


class FailoverController:
    """The failover half of the serving chaos plane.  Pass it to
    :class:`~.router.ReplicaRouter` (``failover=``): the router calls
    :meth:`bind`, :meth:`observe_events` after each replica tick and
    :meth:`evaluate` once a router tick."""

    def __init__(
        self,
        *,
        retry_budget: int = DEFAULT_RETRY_BUDGET,
        miss_threshold: int = MISS_THRESHOLD,
        degrade_skew: float = DEGRADE_SKEW,
        skew_window: int = SKEW_WINDOW,
        min_skew_obs: int = MIN_SKEW_OBS,
        brownout_margin_s: float = 0.0,
        respawn: bool = True,
        backoff: BackoffPolicy | None = None,
        aggregator=None,
        stale_after_s: float = STALE_AFTER_S,
    ):
        if retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, got {retry_budget}")
        if miss_threshold < 1:
            raise ValueError(
                f"miss_threshold must be >= 1, got {miss_threshold}"
            )
        if brownout_margin_s < 0:
            raise ValueError(
                f"brownout_margin_s must be >= 0, got {brownout_margin_s}"
            )
        if not 1 <= min_skew_obs <= skew_window:
            raise ValueError(
                f"want 1 <= min_skew_obs <= skew_window, got "
                f"{min_skew_obs} / {skew_window}"
            )
        self.retry_budget = retry_budget
        self.miss_threshold = miss_threshold
        self.degrade_skew = degrade_skew
        self.skew_window = skew_window
        self.min_skew_obs = min_skew_obs
        self.brownout_margin_s = brownout_margin_s
        self.respawn_enabled = respawn
        self.backoff = backoff or BackoffPolicy()
        self.aggregator = aggregator
        self.stale_after_s = stale_after_s
        self.router = None
        self.health: list[ReplicaHealth] = []
        self._tracked: dict[Any, _Tracked] = {}
        self.retired: set = set()
        # Requeues waiting for an eligible replica, flushed in arrival
        # order each evaluate.
        self._pending: list[tuple[_Tracked, Request]] = []
        self._respawn_at: dict[int, float] = {}
        # The latest revival per replica: staleness counts from it too, or
        # a replica fenced longer than stale_after_s would die again in
        # the pass that revived it.
        self._revived_at: dict[int, float] = {}
        # Records finalized here ("failed"), merged into the router's.
        self.completed: list[dict] = []
        self.requeued = 0              # drained while still queued
        self.retried = 0               # drained in flight (work redone)
        self.duplicates_suppressed = 0
        self.failed = 0                # retry budget exhausted
        self.respawns = 0
        self.deaths: list[dict] = []   # {replica, role?, tick, t}
        self._last_emitted: dict = {}

    # ------------------------------------------------------------------ #
    # wiring
    # ------------------------------------------------------------------ #

    def bind(self, router) -> None:
        if self.router is not None and self.router is not router:
            raise ValueError("a FailoverController binds to ONE router")
        self.router = router
        self.health = [ReplicaHealth() for _ in router.replicas]
        # The straggler window is this controller's: size the router's
        # tick logs to it.
        router._tick_log = [deque(log, maxlen=self.skew_window)
                            for log in router._tick_log]

    @property
    def pending(self) -> int:
        """Requeues waiting for capacity: accepted work, so the router is
        not idle while any waits."""
        return len(self._pending)

    def eligible(self) -> list[int]:
        """Replicas new work may go to: ``up`` only (a degraded replica
        keeps its work but takes nothing new)."""
        return [k for k, h in enumerate(self.health) if h.state == "up"]

    def readable(self) -> list[int]:
        """Replicas whose pools may be read (prefix lookups, sibling-fetch
        sources): any but dead or parked ones, whose pools hold nothing."""
        return [k for k, h in enumerate(self.health)
                if h.state not in ("dead", "parked")]

    # ------------------------------------------------------------------ #
    # tracking (router.submit / router.tick)
    # ------------------------------------------------------------------ #

    def track(self, request: Request, replica: int) -> None:
        """A fresh admission: keep everything a replay needs."""
        self._tracked[request.id] = _Tracked(request=request,
                                             history=[replica])

    def observe_events(self, replica: int, events: list) -> None:
        """One replica tick's events: streamed tokens feed the replay log,
        any finish retires the id."""
        for ev in events:
            tr = self._tracked.get(ev.request_id)
            if ev.kind == "token":
                if tr is not None:
                    tr.tokens.append(int(ev.token))
            elif ev.kind == "finish":
                self.retired.add(ev.request_id)
                self._tracked.pop(ev.request_id, None)

    # ------------------------------------------------------------------ #
    # detection
    # ------------------------------------------------------------------ #

    def evaluate(self, tick: int, now: float) -> None:
        """One pass a router tick: due respawns, death detection (missed
        ticks, heartbeat staleness), straggler degradation, the orphan
        sweep, the pending requeues, brown-out margins, telemetry."""
        r = self.router
        for k in [k for k, t in self._respawn_at.items() if t <= now]:
            self._respawn(k, now)
        for k, h in enumerate(self.health):
            if h.state in ("dead", "role_dead", "parked"):
                # A parked replica is silent by design.
                continue
            if r._missed[k] >= self.miss_threshold:
                self.declare_dead(k, tick, now, cause="missed_ticks")
            elif self.aggregator is not None and self._stale(k, now):
                self.declare_dead(k, tick, now, cause="heartbeat_stale")
        self._check_skew(tick, now)
        self._orphan_sweep(now)
        self._flush_pending(now)
        # A parked replica is a smaller healthy tier: brown-out keys off
        # failures only.
        degraded = any(h.state not in ("up", "parked") for h in self.health)
        margin = self.brownout_margin_s if degraded else 0.0
        for k, h in enumerate(self.health):
            if h.state not in ("dead", "parked"):
                r.replicas[k].brownout_margin = margin
        if r.emitter is not None:
            self._emit_stats(r.emitter)

    def _stale(self, k: int, now: float) -> bool:
        alive = self.aggregator._alive.get(f"replica{k}")
        if alive is None:
            return False
        ref = max(alive, self._revived_at.get(k, alive))
        return (now - ref) > self.stale_after_s

    def _check_skew(self, tick: int, now: float) -> None:
        """A replica completing ticks at under ``1/degrade_skew`` the fleet
        median rate (over the router's rolling tick logs) is degraded and
        flagged; back above the bar, it is up again."""
        r = self.router
        rates: dict[int, float] = {}
        for k, h in enumerate(self.health):
            if h.state in ("dead", "role_dead", "parked"):
                continue
            log = r._tick_log[k]
            if len(log) >= self.min_skew_obs:
                rates[k] = sum(log) / len(log)
        if len(rates) < 2:
            return
        med = float(np.median(list(rates.values())))
        if med <= 0:
            return
        for k, rate in rates.items():
            h = self.health[k]
            # A rate of 0 is a silent replica: the death detectors' case.
            slow = 0 < rate < med / self.degrade_skew
            if slow and h.state == "up":
                h.state = "degraded"
                if r.emitter is not None:
                    r.emitter.anomaly(
                        "straggler_skew", replica=k, tick=tick,
                        tick_rate=rate, median_rate=med, skew=med / rate,
                    )
            elif not slow and h.state == "degraded":
                h.state = "up"

    def _orphan_sweep(self, now: float) -> None:
        """A tracked request admitted on a live replica that neither its
        engine nor its queue holds fell through a crack (a dropped
        handoff): requeue it.  A record the scheduler finished (shed, the
        one retirement with no engine event) retires its tracking here."""
        if not self._tracked:
            return
        by_replica: dict[int, list[_Tracked]] = {}
        for tr in self._tracked.values():
            by_replica.setdefault(tr.history[-1], []).append(tr)
        for k, mine in by_replica.items():
            if self.health[k].state == "dead":
                continue
            s = self.router.replicas[k]
            live = None
            for tr in mine:
                rid = tr.request.id
                rec = s.records.get(rid)
                if rec is None:
                    continue
                if rec.get("finish") is not None:
                    self.retired.add(rid)
                    self._tracked.pop(rid, None)
                    continue
                if rec.get("admitted") is None:
                    continue
                if live is None:  # once per replica, when needed
                    live = set(s.engine.live_requests())
                    queued = {q.id for q in s.queue}
                if rid in live or rid in queued:
                    # A requeued retry waits in the queue with its
                    # original admitted stamp.
                    continue
                del s.records[rid]
                self.retried += 1
                self._requeue(tr, now)

    # ------------------------------------------------------------------ #
    # death, drain, requeue
    # ------------------------------------------------------------------ #

    def declare_dead(self, k: int, tick: int, now: float, *,
                     cause: str = "manual") -> None:
        """Fence replica ``k`` and drain it; a second declaration is a
        no-op."""
        h = self.health[k]
        if h.state in ("dead", "parked"):
            # A parked replica runs nothing, and a death would arm a
            # respawn that un-parks it.
            return
        h.state = "dead"
        h.deaths += 1
        self.deaths.append({"replica": k, "tick": tick, "t": now})
        r = self.router
        r._fenced.add(k)
        if r.emitter is not None:
            r.emitter.anomaly("replica_dead", replica=k, tick=tick,
                              cause=cause)
        self.drain(k, now)
        if self.respawn_enabled:
            self._respawn_at[k] = now + self.backoff.delay(h.deaths)

    def drain(self, k: int, now: float, *, charge_retry: bool = True) -> None:
        """Move every queued and in-flight request off replica ``k`` onto
        the survivors (a second call finds nothing).  ``charge_retry=
        False`` is the administrative drain (autoscale): the work
        migrates, it does not fail, so no retry budget is spent."""
        s = self.router.replicas[k]
        queued_ids = [req.id for req in s.queue]
        s.queue.clear()
        s._tenant_counts.clear()
        live_ids = [rid for rid in s.engine.live_requests()
                    if rid not in queued_ids]
        for rid in live_ids:
            # Release the replica's slots and blocks (host bookkeeping).
            try:
                s.engine.cancel(rid)
            except KeyError:
                pass
        self._drain_ids(s, queued_ids + live_ids, now,
                        charge_retry=charge_retry)

    def _drain_ids(self, s, ids: list, now: float, *,
                   charge_retry: bool = True) -> None:
        """The drain shared by replica and role deaths: dedupe against
        retired ids, harvest each record's stamps, classify requeued
        (never admitted) or retried (work redone), and requeue in arrival
        order so the survivors' tenant-fair admission sees the tier's
        order."""
        drained: list[tuple[_Tracked, bool]] = []
        for rid in ids:
            if rid in self.retired:
                self.duplicates_suppressed += 1
                s.records.pop(rid, None)
                continue
            tr = self._tracked.get(rid)
            if tr is None:
                s.records.pop(rid, None)
                continue
            rec = s.records.pop(rid, None)
            admitted = rec is not None and rec.get("admitted") is not None
            if admitted:
                tr.admitted = rec["admitted"]
            if rec is not None and rec.get("first_token") is not None:
                tr.first_token = rec["first_token"]
            drained.append((tr, admitted))
        drained.sort(key=lambda pair: pair[0].request.arrival_time)
        for tr, admitted in drained:
            if admitted:
                self.retried += 1
            else:
                self.requeued += 1
            self._requeue(tr, now, charge_retry=charge_retry)

    def on_role_death(self, k: int, role: str, stranded: list, tick: int,
                      now: float) -> None:
        """A disaggregated replica's role died (``fail_role`` already
        released its slots and returned the stranded ids): the replica
        takes no new work, its stranded and queued requests requeue, and
        the role respawns on the backoff.  A second role dying meanwhile
        is a fresh death, and the respawn revives every dead role."""
        h = self.health[k]
        if h.state == "dead":
            return
        h.state = "role_dead"
        h.dead_role = role
        h.deaths += 1
        self.deaths.append({"replica": k, "role": role, "tick": tick,
                            "t": now})
        r = self.router
        if r.emitter is not None:
            r.emitter.anomaly("replica_dead", replica=k, role=role,
                              tick=tick, cause="role_crash")
        s = r.replicas[k]
        queued_ids = [req.id for req in s.queue]
        s.queue.clear()
        s._tenant_counts.clear()
        self._drain_ids(
            s, queued_ids + [x for x in stranded if x not in queued_ids],
            now)
        if self.respawn_enabled:
            self._respawn_at[k] = now + self.backoff.delay(h.deaths)

    def _requeue(self, tr: _Tracked, now: float, *,
                 charge_retry: bool = True) -> None:
        """Rebuild the request from the replay state (prompt + every token
        streamed so far, the budget left, the original arrival, deadline
        and tenant), charge the retry budget (failure drains only) and
        place it through the router's routing."""
        if charge_retry:
            tr.retries += 1
            if tr.retries > self.retry_budget:
                self._fail(tr, now)
                return
        req = tr.request
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if tr.tokens:
            prompt = np.concatenate([prompt,
                                     np.asarray(tr.tokens, np.int32)])
        retry = Request(
            req.id, prompt, req.max_new_tokens - len(tr.tokens),
            arrival_time=req.arrival_time, deadline=req.deadline,
            tenant=req.tenant,
        )
        self._place(tr, retry, now)

    def _place(self, tr: _Tracked, retry: Request, now: float) -> None:
        k = self.router._submit_requeue(retry)
        if k is None:
            self._pending.append((tr, retry))
            return
        tr.history.append(k)
        rec = self.router.replicas[k].records[retry.id]
        # The record keeps the request's identity, not the retry's: the
        # original prompt length and budget, the original stamps, the
        # tokens generated before the kill.
        rec["prompt_len"] = int(np.asarray(tr.request.prompt).reshape(-1)
                                .size)
        rec["max_new_tokens"] = int(tr.request.max_new_tokens)
        rec["generated"] = len(tr.tokens)
        rec["admitted"] = tr.admitted
        rec["first_token"] = tr.first_token
        rec["retries"] = tr.retries
        rec["replica_history"] = list(tr.history)

    def _flush_pending(self, now: float) -> None:
        if not self._pending or not self.eligible():
            return
        pending, self._pending = self._pending, []
        pending.sort(key=lambda pair: pair[1].arrival_time)
        for tr, retry in pending:
            self._place(tr, retry, now)

    def _fail(self, tr: _Tracked, now: float) -> None:
        """Retry budget exhausted: one terminal ``"failed"`` record, out
        of goodput, a ``failed_requests`` count in the goodput SLO's bad
        set."""
        req = tr.request
        rec = {
            "id": req.id,
            "prompt_len": int(np.asarray(req.prompt).reshape(-1).size),
            "max_new_tokens": int(req.max_new_tokens),
            "arrival": float(req.arrival_time),
            "deadline": req.deadline, "tenant": req.tenant,
            "replica": tr.history[-1] if tr.history else None,
            "admitted": tr.admitted, "first_token": tr.first_token,
            "finish": now, "finish_reason": "failed",
            "generated": len(tr.tokens), "retries": tr.retries - 1,
            "replica_history": list(tr.history),
        }
        finalize_record(rec)
        self.completed.append(rec)
        self.retired.add(req.id)
        self._tracked.pop(req.id, None)
        self.failed += 1
        r = self.router
        if r.request_logger is not None:
            r.request_logger.log(rec)
        if r.emitter is not None:
            r.emitter.counter_add("failed_requests", 1)
            r.emitter.emit("record", {
                "record": "request_failed", "id": req.id,
                "retries": rec["retries"],
            })

    # ------------------------------------------------------------------ #
    # respawn
    # ------------------------------------------------------------------ #

    def _reset_replica(self, k: int) -> None:
        """Reset replica ``k``'s engine in place (its pools stay where they
        are) and forget its unfinished records."""
        r = self.router
        s = r.replicas[k]
        s.engine.reset()
        # The engine's counters restarted at zero: rebase the scheduler's
        # deltas so the emitted counters stay monotone.
        s._last_stats = {}
        for rid in [rid for rid, rec in s.records.items()
                    if rec.get("finish") is None]:
            del s.records[rid]
        r._missed[k] = 0
        r._tick_log[k].clear()

    def _respawn(self, k: int, now: float) -> None:
        """Bring replica ``k`` back: a dead role revives (every dead role),
        a dead replica resets; the fence lifts."""
        self._respawn_at.pop(k, None)
        self._revived_at[k] = now
        h = self.health[k]
        r = self.router
        s = r.replicas[k]
        if h.state == "role_dead":
            for role in list(s.engine.dead_roles):
                s.engine.revive_role(role)
            h.dead_role = None
            r._missed[k] = 0
            r._tick_log[k].clear()
        else:
            self._reset_replica(k)
        h.state = "up"
        r._fenced.discard(k)
        r._faults.pop(k, None)
        self.respawns += 1
        if r.emitter is not None:
            r.emitter.anomaly("replica_respawn", replica=k)

    # ------------------------------------------------------------------ #
    # park and unpark (serve/autoscale.py)
    # ------------------------------------------------------------------ #

    def retire(self, k: int, tick: int, now: float) -> None:
        """Park replica ``k`` (an autoscale scale-down): fence it, migrate
        its queued and in-flight work onto the survivors without charging
        retry budgets, and reset its engine.  Idempotent; a dead or
        role-dead replica belongs to the failure path and is refused."""
        h = self.health[k]
        if h.state == "parked":
            return
        if h.state in ("dead", "role_dead"):
            raise ValueError(
                f"cannot retire replica {k} in state {h.state!r} — "
                "retirement is for healthy replicas (the failure path "
                "owns dead ones)"
            )
        h.state = "parked"
        self.router._fenced.add(k)
        self._respawn_at.pop(k, None)
        self.drain(k, now, charge_retry=False)
        self._reset_replica(k)

    def revive(self, k: int, tick: int, now: float) -> None:
        """Un-park replica ``k`` (an autoscale scale-up): lift the fence.
        It was drained and reset when parked: nothing to rebuild.  No-op
        unless parked."""
        h = self.health[k]
        if h.state != "parked":
            return
        h.state = "up"
        self._revived_at[k] = now
        r = self.router
        r._fenced.discard(k)
        r._faults.pop(k, None)
        r._missed[k] = 0
        r._tick_log[k].clear()

    # ------------------------------------------------------------------ #
    # accounting
    # ------------------------------------------------------------------ #

    def _count(self, *states: str) -> int:
        return sum(1 for h in self.health if h.state in states)

    def stats(self) -> dict:
        """The failover accounting (what the telemetry must equal)."""
        return {
            "requeued": self.requeued,
            "retried": self.retried,
            "duplicates_suppressed": self.duplicates_suppressed,
            "failed": self.failed,
            "respawns": self.respawns,
            "replica_deaths": len(self.deaths),
            "deaths": [dict(d) for d in self.deaths],
            "replicas_dead": self._count("dead", "role_dead"),
            "replicas_degraded": self._count("degraded"),
            "replicas_parked": self._count("parked"),
            "pending_requeues": len(self._pending),
        }

    def _emit_stats(self, emitter) -> None:
        totals = {
            "failover_requeued_requests": self.requeued,
            "failover_retried_requests": self.retried,
            "failover_duplicates_suppressed": self.duplicates_suppressed,
            "failover_respawns": self.respawns,
            "replica_deaths": len(self.deaths),
        }
        for name, total in totals.items():
            delta = total - self._last_emitted.get(name, 0)
            if delta:
                emitter.counter_add(name, delta)
        self._last_emitted = totals
        emitter.gauge("replicas_dead", self._count("dead", "role_dead"))
        emitter.gauge("replicas_degraded", self._count("degraded"))
        emitter.gauge("replicas_parked", self._count("parked"))
        # Accepted work with no eligible home right now: the backlog a
        # scale-up wants to see.
        emitter.gauge("router_pending_depth", len(self._pending))
