"""Data-parallel serving router: N engine replicas behind one admission
point, the counterpart of the JAX package's ``serve/router.py``.

Each replica is an independent engine (``ServingEngine`` or
``DisaggServingEngine``) with its own pool and scheduler, on its own card
when there are enough (``cli/main.py``).  Every request enters through
:meth:`ReplicaRouter.submit`, which picks a replica by

1. **prefix-cache affinity** (paged replicas): the request's chained
   prefix hash is looked up in every replica's block cache without
   claiming, and the replica with the deepest hit serves it, unless that
   replica is saturated (its queue at ``affinity_queue_cap``, or full):
   then the request falls back to rule 2, counted as a rebalance;
2. **least-loaded**: the least queued + live-slot occupancy, ties broken
   by the lowest replica index (scripted traces replay).

When the decision lands a request on a replica with a shallower hit than
the best sibling's, the **sibling fetch** copies the missing prefix
blocks into the chosen replica's host tier first (striped over every
warmer sibling, ``serve/kv_store.py``), so its admission restores them
instead of recomputing.  All replicas' drafters share one
:class:`~.draft.NgramIndex`, and each replica's scheduler stamps
``replica=k`` on its records and spans.  The routing counters go to the
telemetry as gauges and counter deltas every tick.

The controllers bind here.  ``chaos=`` (``resilience/faults.py``'s
``ServeFaultInjector``) fires first in every tick and only sets the
router's fault state: a crashed, stalled or slow replica is simply not
ticked, which is how a dead replica presents.  ``failover=``
(``serve/failover.py``) reads the missed ticks and the rolling tick logs
after the replica sweep, fences and drains the dead and requeues their
work; ``autoscale=`` (``serve/autoscale.py``) runs after it; ``policy=``
(``serve/policy.py``) is handed to every replica's scheduler.  A replica
may be an engine in this process, or a tensor-parallel group led by
another process (``serve/tp.py``'s ``RemoteReplica``): the router reads
and drives both through the same calls.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable

import numpy as np

from .draft import NgramIndex
from .scheduler import ContinuousScheduler, Request

# The rolling window of per-replica tick completions the straggler
# detector reads (resized by the failover controller).
_TICK_LOG_WINDOW = 16


class ReplicaRouter:
    """Admission point over N interchangeable engine replicas (the same
    model, weights and decoding config).  ``affinity_queue_cap`` is the
    queue depth at which an affinity target counts as saturated; it
    defaults to the replica's slot count."""

    def __init__(
        self,
        engines: list,
        *,
        max_queue: int = 64,
        clock: Callable[[], float] = time.monotonic,
        request_logger=None,
        emitter=None,
        affinity: bool = True,
        affinity_queue_cap: int | None = None,
        share_ngram_index: bool = True,
        sibling_fetch: bool = True,
        spans=None,
        slo=None,
        chaos=None,
        failover=None,
        autoscale=None,
        policy=None,
    ):
        if not engines:
            raise ValueError("need at least one engine replica")
        self.affinity = affinity
        self.affinity_queue_cap = affinity_queue_cap
        self.sibling_fetch = sibling_fetch
        self.emitter = emitter
        # One span recorder for the tier; route spans carry the router's
        # clock, the timebase of every replica's records.
        self.spans = spans
        # One SLO policy for the tier, evaluated once a router tick.
        self.slo = slo
        self.clock = clock
        self.replicas = [
            ContinuousScheduler(
                eng, max_queue=max_queue, clock=clock,
                request_logger=request_logger, emitter=emitter, replica=k,
                spans=spans, policy=policy,
            )
            for k, eng in enumerate(engines)
        ]
        # One admission policy for the tier (its deficit state lives on
        # each scheduler).
        self.policy = policy
        # One shared n-gram index: replica 0's becomes everyone's
        # (engine.reset() clears it in place, so sharing survives).
        self.shared_index: NgramIndex | None = None
        if share_ngram_index:
            drafters = [e.drafter for e in engines
                        if e.drafter is not None
                        and e.drafter.index is not None]
            if drafters:
                self.shared_index = drafters[0].index
                for d in drafters[1:]:
                    d.index = self.shared_index
        # Routing accounting: the host-side source of truth the emitted
        # telemetry must equal.
        self.routed = [0] * len(engines)
        self.affinity_hits = 0      # routed to the deepest-prefix replica
        self.rebalanced = 0         # affinity target saturated: fallback
        self.rejected = 0           # chosen replica's queue full
        self.sibling_fetches = 0    # fetch events (requests helped)
        self.sibling_fetch_blocks = 0
        self._last_emitted: dict = {}
        # The chaos and failover plane.  The router owns the fault and
        # fence state either way, so a chaos run without failover still
        # presents a dead replica honestly: not ticked, its work stranded.
        self.tick_index = 0
        self.chaos = chaos
        self.failover = failover
        self.request_logger = request_logger
        n = len(engines)
        self._faults: dict[int, dict] = {}   # k -> {"kind", "until", "period"}
        self._fenced: set[int] = set()       # declared dead by failover
        self._missed = [0] * n               # consecutive unanswered ticks
        self._tick_log = [deque(maxlen=_TICK_LOG_WINDOW) for _ in range(n)]
        if chaos is not None:
            # Refuse an out-of-range replica now: a fault raising when it
            # fires would have written its marker already.
            chaos.validate(n)
        if failover is not None:
            failover.bind(self)
        # Autoscale binds after failover (its actions are failover's park
        # and unpark) and may park the spares here.
        self.autoscale = autoscale
        if autoscale is not None:
            autoscale.bind(self)

    # ------------------------------------------------------------------ #
    # routing
    # ------------------------------------------------------------------ #

    def _load(self, k: int) -> int:
        s = self.replicas[k]
        return len(s.queue) + s.engine.pool.num_active

    def _affinity_cap(self, k: int) -> int:
        if self.affinity_queue_cap is not None:
            return self.affinity_queue_cap
        return self.replicas[k].engine.num_slots

    def _eligible(self) -> list[int]:
        """Replicas new work may land on: all of them without a failover
        controller, its ``up`` set with one."""
        if self.failover is None:
            return list(range(len(self.replicas)))
        return self.failover.eligible()

    def _readable(self) -> set[int]:
        """Replicas whose pools may be read (prefix lookups, sibling-fetch
        sources): a dead replica's bytes are gone."""
        if self.failover is None:
            return set(range(len(self.replicas)))
        return set(self.failover.readable())

    def route(self, request: Request) -> int | None:
        """Replica index for ``request`` (side effects: the routing
        counters and a sibling fetch; :meth:`submit` enqueues); None when
        no replica is eligible."""
        return self._route_decision(request)[0]

    def _route_decision(self, request: Request) -> tuple[int | None, str]:
        """(replica index, "affinity" | "rebalanced" | "least_loaded"), or
        (None, "no_replica") when nothing is eligible."""
        cand = self._eligible()
        if not cand:
            return None, "no_replica"
        decision = "least_loaded"
        hits = None
        if len(self.replicas) > 1 and (self.affinity or self.sibling_fetch):
            # The per-replica prefix depths feed affinity and the sibling
            # fetch alike: with affinity off a warm sibling's blocks still
            # chase the least-loaded placement.  Unreadable replicas score
            # zero.
            prompt = np.asarray(request.prompt, np.int32).reshape(-1)
            readable = self._readable()
            hits = [
                s.engine.pool.lookup(prompt)
                if k in readable and s.engine.paged
                and s.engine.pool.prefix_cache_enabled
                else 0
                for k, s in enumerate(self.replicas)
            ]
            best = max(cand, key=lambda k: (hits[k], -k))
            if self.affinity and hits[best] > 0:
                s_best = self.replicas[best]
                # Saturated at the affinity cap or the hard queue bound,
                # whichever bites first: an affinity hit never lands in a
                # full queue while another replica has room.
                cap = min(self._affinity_cap(best), s_best.max_queue)
                if len(s_best.queue) < cap:
                    self.affinity_hits += 1
                    return best, "affinity"
                self.rebalanced += 1
                decision = "rebalanced"
        chosen = min(cand, key=lambda k: (self._load(k), k))
        if self.sibling_fetch and hits is not None \
                and max(hits) > hits[chosen]:
            self._sibling_fetch(request, chosen, hits)
        return chosen, decision

    def _sibling_fetch(self, request: Request, chosen: int,
                       hits: list[int]) -> None:
        """Copy the warmer siblings' prefix blocks into ``chosen``'s host
        tier, striped deepest sibling first (a no-op without host tiers
        on the pools).  Between tensor-parallel groups each rank's head
        shard travels to its peer (``serve/tp.py``)."""
        from .kv_store import sibling_fetch_striped

        warm = sorted((k for k in range(len(self.replicas))
                       if hits[k] > hits[chosen]),
                      key=lambda k: (-hits[k], k))
        engines = [self.replicas[k].engine for k in [chosen, *warm]]
        if any(hasattr(e, "group_index") for e in engines):
            from .tp import sibling_fetch_groups

            fetched = sibling_fetch_groups(engines[0], engines[1:],
                                           request.prompt)
        else:
            dst = getattr(engines[0].pool, "blocks", None)
            if dst is None or dst.host is None:
                return
            srcs = [src for e in engines[1:]
                    if (src := getattr(e.pool, "blocks", None)) is not None
                    and src is not dst]
            if not srcs:
                return
            fetched = sibling_fetch_striped(dst, srcs, request.prompt)
        if fetched:
            self.sibling_fetches += 1
            self.sibling_fetch_blocks += fetched

    def submit(self, request: Request) -> bool:
        """Route and enqueue; False = the chosen replica's bounded queue
        refused it (backpressure, as the scheduler's ``submit``), or no
        replica is eligible (the whole tier dead or degraded: refusing is
        the graceful degradation)."""
        k, decision = self._route_decision(request)
        if k is None:
            self.rejected += 1
            if self.emitter is not None:
                self.emitter.counter_add("rejected_requests", 1)
            return False
        ok = self.replicas[k].submit(request)
        if ok:
            self.routed[k] += 1
            if self.failover is not None:
                self.failover.track(request, k)
        else:
            self.rejected += 1
        if self.spans is not None and self.spans.enabled:
            # The route decision as a zero-width span on the request's
            # correlation id: the first link of its chain.
            now = self.clock()
            self.spans.record_span(
                "router/route", now, now, corr=request.id,
                decision=decision, replica=k, accepted=ok,
            )
        return ok

    def _submit_requeue(self, request: Request) -> int | None:
        """The failover requeue's placement: the normal decision (affinity
        and sibling fetch against the survivors), enqueued past the
        bounded queue (this work was admitted once; a bounce would lose
        it).  None when nothing is eligible: the controller holds it."""
        k, _ = self._route_decision(request)
        if k is None:
            return None
        self.replicas[k].submit(request, force=True)
        self.routed[k] += 1
        if self.spans is not None and self.spans.enabled:
            now = self.clock()
            self.spans.record_span(
                "router/route", now, now, corr=request.id,
                decision="failover", replica=k, accepted=True,
            )
        return k

    # ------------------------------------------------------------------ #
    # driving
    # ------------------------------------------------------------------ #

    @property
    def idle(self) -> bool:
        return all(s.idle for s in self.replicas) and (
            self.failover is None or self.failover.pending == 0)

    # ---- the chaos plane's surface (resilience/faults.py) ------------- #

    def set_fault(self, k: int, kind: str, *, until_tick: int | None = None,
                  period: int | None = None) -> None:
        """Arm a replica fault: ``"crash"`` (never answers again),
        ``"stall"`` (misses ticks until ``until_tick``), ``"slow"``
        (answers once every ``period`` ticks).  The router only simulates
        the failure; detection and recovery are the failover
        controller's."""
        if not 0 <= k < len(self.replicas):
            raise ValueError(f"no replica {k}")
        if kind not in ("crash", "stall", "slow"):
            raise ValueError(f"unknown replica fault kind {kind!r}")
        self._faults[k] = {"kind": kind, "until": until_tick,
                           "period": period}

    def inject_role_death(self, k: int, role: str) -> None:
        """Kill one role pool of a disaggregated replica: the engine
        releases the role's slots and the failover controller, when there
        is one, requeues the stranded requests (without one they
        strand)."""
        eng = self.replicas[k].engine
        if not hasattr(eng, "fail_role"):
            raise ValueError(
                f"replica {k} is not disaggregated — role faults need a "
                "DisaggServingEngine"
            )
        if role in eng.dead_roles:
            return  # already dead: not a second death
        stranded = eng.fail_role(role)
        if self.failover is not None:
            self.failover.on_role_death(k, role, stranded, self.tick_index,
                                        self.clock())

    def drop_handoff(self) -> Any | None:
        """Drop one parked prefill->decode handoff somewhere in the tier
        (the lost message); returns its request id, None when nothing is
        parked."""
        for s in self.replicas:
            dropper = getattr(s.engine, "drop_handoff", None)
            if dropper is not None:
                rid = dropper()
                if rid is not None:
                    return rid
        return None

    def _tickable(self, k: int) -> bool:
        fault = self._faults.get(k)
        if fault is None:
            return True
        if fault["kind"] == "crash":
            return False
        if fault["kind"] == "stall":
            if self.tick_index < fault["until"]:
                return False
            del self._faults[k]  # the stall is over: it answers again
            return True
        return self.tick_index % fault["period"] == 0  # slow

    def tick(self) -> list:
        """One tick of every responsive replica (an idle one costs next to
        nothing); returns the merged engine events.

        The chaos plane fires first; a crashed, stalled or fenced replica
        then misses its tick, the failover controller's raw signal (the
        ``_missed`` streaks and the ``_tick_log`` the straggler detector
        reads).  The controller evaluates after the sweep, so a death is
        drained and requeued within the tick, then autoscale acts."""
        self.tick_index += 1
        if self.chaos is not None:
            self.chaos.on_tick(self.tick_index, self)
        ticking = []
        for k, s in enumerate(self.replicas):
            fenced = k in self._fenced
            if fenced or not self._tickable(k):
                # A silent replica still contributes its queue depth and
                # occupancy (the samples stay rectangular); only unfenced
                # silence feeds detection.
                if not fenced:
                    self._missed[k] += 1
                    self._tick_log[k].append(0)
                s.queue_depth_samples.append(len(s.queue))
                s.active_slot_samples.append(s.engine.pool.num_active)
                continue
            self._missed[k] = 0
            self._tick_log[k].append(1)
            ticking.append(k)
        by_replica = self._tick_replicas(ticking)
        events: list = []
        for k in ticking:
            ev = by_replica[k]
            if self.failover is not None:
                self.failover.observe_events(k, ev)
            events.extend(ev)
        if self.failover is not None:
            self.failover.evaluate(self.tick_index, self.clock())
        if self.autoscale is not None:
            # After failover's pass and before the telemetry flush, so an
            # action's counters land in the same tick's emission.
            self.autoscale.evaluate(self.tick_index, self.clock())
        if self.emitter is not None:
            self._emit_stats()
        if self.slo is not None:
            self.slo.evaluate(self.clock())
        return events

    def _tick_replicas(self, ticking: list) -> dict:
        """Each replica's tick's events.  A replica led by another process
        (``serve/tp.py``'s ``RemoteReplica``) has its step posted before
        this process's replicas step, and its reply collected after, so
        the groups' forwards overlap; every posted reply is collected
        before an error is raised (an uncollected one would leave the
        pair group out of step)."""
        posted = {}
        for k in ticking:
            s = self.replicas[k]
            if hasattr(s.engine, "post_step"):
                posted[k] = (s.begin_tick(), s.engine.post_step())
        out: dict = {}
        error = None
        try:
            for k in ticking:
                if k not in posted:
                    out[k] = self.replicas[k].tick()
        except BaseException as e:  # noqa: BLE001 - raised after collecting
            error = e
        for k, (cancelled, finish) in posted.items():
            try:
                step = finish()
            except BaseException as e:  # noqa: BLE001 - as above
                error = error or e
                continue
            if error is None:
                out[k] = self.replicas[k].finish_tick(cancelled + step)
        if error is not None:
            raise error
        return out

    def run(self, requests: list[Request], *,
            sleep: Callable[[float], None] | None = None) -> list[dict]:
        """Drive a whole trace: each request is routed at its arrival
        time (affinity sees the cache state a live front end would), the
        replicas tick until idle.  Returns the merged records, each
        stamped with its replica."""
        if sleep is None:
            sleep = time.sleep
        clock = self.replicas[0].clock
        pending = sorted(requests, key=lambda r: r.arrival_time)
        i = 0
        while i < len(pending) or not self.idle:
            now = clock()
            while i < len(pending) and pending[i].arrival_time <= now:
                self.submit(pending[i])
                i += 1
            if not self.idle:
                self.tick()
            elif i < len(pending):
                sleep(max(pending[i].arrival_time - now, 0.0))
        return self.completed

    @property
    def completed(self) -> list[dict]:
        """Every replica's finished records and the failover controller's
        ``"failed"`` retirements, in finish order."""
        out = [r for s in self.replicas for r in s.completed]
        if self.failover is not None:
            out.extend(self.failover.completed)
        out.sort(key=lambda r: (r.get("finish") is None, r.get("finish")))
        return out

    # ------------------------------------------------------------------ #
    # accounting
    # ------------------------------------------------------------------ #

    def stats(self) -> dict:
        """The routing counters and per-replica occupancy: the source of
        truth the emitted telemetry equals."""
        return {
            "replicas": len(self.replicas),
            "routed": list(self.routed),
            "affinity_hits": self.affinity_hits,
            "rebalanced": self.rebalanced,
            "rejected": self.rejected,
            "sibling_fetches": self.sibling_fetches,
            "sibling_fetch_blocks": self.sibling_fetch_blocks,
            "queue_depths": [len(s.queue) for s in self.replicas],
            "slots_active": [s.engine.pool.num_active
                             for s in self.replicas],
            **({"failover": self.failover.stats()}
               if self.failover is not None else {}),
        }

    def queue_depth_samples(self) -> list[int]:
        """Tier-wide queue depth a tick (summed over the replicas)."""
        per = [s.queue_depth_samples for s in self.replicas]
        n = min((len(p) for p in per), default=0)
        return [sum(p[i] for p in per) for i in range(n)]

    def active_slot_samples(self) -> list[int]:
        per = [s.active_slot_samples for s in self.replicas]
        n = min((len(p) for p in per), default=0)
        return [sum(p[i] for p in per) for i in range(n)]

    def engine_stats(self) -> dict:
        """The replicas' engine counters summed (all monotonic counts
        but ``kv_block_bytes``, a per-block price equal on every
        replica)."""
        total: dict = {}
        for s in self.replicas:
            for name, v in s.engine.stats().items():
                if not isinstance(v, (int, np.integer)):
                    continue
                if name == "kv_block_bytes":
                    total[name] = int(v)
                else:
                    total[name] = total.get(name, 0) + int(v)
        return total

    def _emit_stats(self) -> None:
        """Per-replica queue-depth and occupancy gauges, and the deltas of
        the monotonic routing totals as counters."""
        for k, s in enumerate(self.replicas):
            self.emitter.gauge(f"router_queue_depth_r{k}", len(s.queue))
            self.emitter.gauge(f"router_slots_active_r{k}",
                               s.engine.pool.num_active)
        totals = {
            "router_routed_requests": sum(self.routed),
            "router_affinity_hits": self.affinity_hits,
            "router_rebalanced": self.rebalanced,
            "router_rejected": self.rejected,
            "router_sibling_fetches": self.sibling_fetches,
            "router_sibling_fetch_blocks": self.sibling_fetch_blocks,
        }
        for k in range(len(self.replicas)):
            totals[f"router_routed_r{k}"] = self.routed[k]
        for name, total in totals.items():
            delta = total - self._last_emitted.get(name, 0)
            if delta:
                self.emitter.counter_add(name, delta)
        self._last_emitted = totals
