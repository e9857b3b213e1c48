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

The failover, autoscale and admission-policy controllers that bind to
this router (``failover=``, ``autoscale=``, ``policy=``, the chaos plane)
are ``ROADMAP.md`` Queue 1 item 12: the constructor refuses them.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from .draft import NgramIndex
from .scheduler import ContinuousScheduler, Request


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
        for name, value in (("chaos", chaos), ("failover", failover),
                            ("autoscale", autoscale), ("policy", policy)):
            if value is not None:
                raise NotImplementedError(
                    f"ReplicaRouter({name}=...): the chaos plane and the "
                    "failover, autoscale and admission-policy controllers "
                    "are ROADMAP.md Queue 1 item 12, not ported yet"
                )
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
                spans=spans,
            )
            for k, eng in enumerate(engines)
        ]
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

    def route(self, request: Request) -> int:
        """Replica index for ``request`` (side effects: the routing
        counters and a sibling fetch; :meth:`submit` enqueues)."""
        return self._route_decision(request)[0]

    def _route_decision(self, request: Request) -> tuple[int, str]:
        """(replica index, "affinity" | "rebalanced" | "least_loaded")."""
        cand = range(len(self.replicas))
        decision = "least_loaded"
        hits = None
        if len(self.replicas) > 1 and (self.affinity or self.sibling_fetch):
            # The per-replica prefix depths feed affinity and the sibling
            # fetch alike: with affinity off a warm sibling's blocks still
            # chase the least-loaded placement.
            prompt = np.asarray(request.prompt, np.int32).reshape(-1)
            hits = [
                s.engine.pool.lookup(prompt)
                if s.engine.paged and s.engine.pool.prefix_cache_enabled
                else 0
                for s in self.replicas
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
        on the pools)."""
        from .kv_store import sibling_fetch_striped

        dst = getattr(self.replicas[chosen].engine.pool, "blocks", None)
        if dst is None or dst.host is None:
            return
        warm = sorted((k for k in range(len(self.replicas))
                       if hits[k] > hits[chosen]),
                      key=lambda k: (-hits[k], k))
        srcs = [src for k in warm
                if (src := getattr(self.replicas[k].engine.pool, "blocks",
                                   None)) is not None and src is not dst]
        if not srcs:
            return
        fetched = sibling_fetch_striped(dst, srcs, request.prompt)
        if fetched:
            self.sibling_fetches += 1
            self.sibling_fetch_blocks += fetched

    def submit(self, request: Request) -> bool:
        """Route and enqueue; False = the chosen replica's bounded queue
        refused it (backpressure, as the scheduler's ``submit``)."""
        k, decision = self._route_decision(request)
        ok = self.replicas[k].submit(request)
        if ok:
            self.routed[k] += 1
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

    # ------------------------------------------------------------------ #
    # driving
    # ------------------------------------------------------------------ #

    @property
    def idle(self) -> bool:
        return all(s.idle for s in self.replicas)

    def tick(self) -> list:
        """One tick of every replica (an idle one costs next to nothing);
        returns the merged engine events."""
        events: list = []
        for s in self.replicas:
            events.extend(s.tick())
        if self.emitter is not None:
            self._emit_stats()
        if self.slo is not None:
            self.slo.evaluate(self.clock())
        return events

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
        """Every replica's finished records, in finish order."""
        out = [r for s in self.replicas for r in s.completed]
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
