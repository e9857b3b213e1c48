"""Closed-loop serving control: the tier that turns its own knobs, the
counterpart of the JAX package's ``serve/autoscale.py``.

:class:`AutoscaleController` runs on the router's tick (never a thread),
reads the SLO policy's alert transitions and the live aggregator's
windows, and takes at most one action a tick, each rate-limited:

- **Replica scaling.**  The fleet is built at its maximum size up front:
  every replica's weights and KV pools are allocated once on the card.
  The controller walks the active count between ``min_replicas`` and the
  fleet: a scale-up revives a parked replica
  (:meth:`FailoverController.revive`) and rebalances the queued backlog
  onto it, a scale-down retires the highest active one
  (:meth:`FailoverController.retire`: fence, drain onto the survivors
  without charging retry budgets, reset).  A parked replica keeps its
  pools, so no action allocates device memory.  Up on queue depth (the
  failover controller's pending requeues included) or a firing burn
  alert, down after a calm streak.
- **Role re-splitting** (disaggregated tiers).  Queue wait dominating
  the TTFT decomposition walks the split bias toward prefill; TPOT over
  its bound at flat decode occupancy walks it back.  A re-split is
  :meth:`DisaggServingEngine.resplit`: admission caps move, built widths
  stay.
- **Pressure ladder.**  Before the tier sheds work it climbs a monotone
  sequence: the host KV tier sized to zero, then a raised brown-out
  margin.  Escalation needs sustained pressure with no spare replica
  left; recovery walks the rungs down before any replica retires.

Every action is an ``autoscale_action`` record on the telemetry with its
cause (signal, objective, window, burn); the counters equal the emitted
telemetry, and every decision is a pure function of the router's state,
the alert log, the aggregator's windows and the tick, so scripted traces
replay action for action.
"""

from __future__ import annotations

import threading
from typing import Any

__all__ = ["AutoscaleController", "LADDER_RUNGS"]

# The monotone degradation sequence (index == rung); each escalation and
# each recovery moves exactly one rung.
LADDER_RUNGS = ("normal", "host_tier", "brownout")

_NEVER = -(10**9)  # "no prior action" tick: cooldowns pass


class AutoscaleController:
    """The serving tier's closed-loop controller.  Pass it to
    :class:`~.router.ReplicaRouter` (``autoscale=``, which needs
    ``failover=``): the router calls :meth:`bind`, then :meth:`evaluate`
    once a tick, after the failover pass and before the telemetry."""

    def __init__(
        self,
        *,
        min_replicas: int = 1,
        initial_replicas: int | None = None,
        max_replicas: int | None = None,
        up_queue_depth: int = 8,
        down_idle_ticks: int = 32,
        cooldown_ticks: int = 16,
        resplit_cooldown_ticks: int = 32,
        resplit_step: int = 1,
        resplit_queue_wait_frac: float = 0.5,
        resplit_min_requests: int = 8,
        resplit_tpot_s: float | None = None,
        resplit_occupancy_max: float = 0.75,
        resplit_window_s: float = 60.0,
        ladder_patience_ticks: int = 16,
        brownout_margin_s: float = 0.25,
        history: int = 32,
        slo=None,
        aggregator=None,
    ):
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}"
            )
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError(
                f"want min_replicas <= max_replicas, got "
                f"{min_replicas} / {max_replicas}"
            )
        if initial_replicas is not None and initial_replicas < min_replicas:
            raise ValueError(
                f"want initial_replicas >= min_replicas, got "
                f"{initial_replicas} / {min_replicas}"
            )
        for name, value in (("up_queue_depth", up_queue_depth),
                            ("down_idle_ticks", down_idle_ticks),
                            ("cooldown_ticks", cooldown_ticks),
                            ("resplit_step", resplit_step)):
            if value < 1:
                raise ValueError(f"{name} must be >= 1, got {value}")
        if not 0.0 < resplit_queue_wait_frac < 1.0:
            raise ValueError(
                "resplit_queue_wait_frac must be in (0, 1), got "
                f"{resplit_queue_wait_frac}"
            )
        if brownout_margin_s < 0:
            raise ValueError(
                f"brownout_margin_s must be >= 0, got {brownout_margin_s}"
            )
        self.min_replicas = min_replicas
        self.initial_replicas = initial_replicas
        self.max_replicas = max_replicas
        self.up_queue_depth = up_queue_depth
        self.down_idle_ticks = down_idle_ticks
        self.cooldown_ticks = cooldown_ticks
        self.resplit_cooldown_ticks = resplit_cooldown_ticks
        self.resplit_step = resplit_step
        self.resplit_queue_wait_frac = resplit_queue_wait_frac
        self.resplit_min_requests = resplit_min_requests
        self.resplit_tpot_s = resplit_tpot_s
        self.resplit_occupancy_max = resplit_occupancy_max
        self.resplit_window_s = resplit_window_s
        self.ladder_patience_ticks = ladder_patience_ticks
        self.brownout_margin_s = brownout_margin_s
        self.history_limit = history
        self.slo = slo
        self.aggregator = aggregator
        self.router = None
        self.failover = None
        # The SLO policy's alert log is append-only and written on this
        # control loop: an index cursor reads it incrementally.
        self._alert_idx = 0
        self._firing: dict[str, dict] = {}
        self._calm_streak = 0
        self._pressure_streak = 0
        self._last_scale_tick = _NEVER
        self._last_resplit_tick = _NEVER
        self._last_ladder_tick = _NEVER
        # The P:D split bias: > 0 caps decode (favors prefill), < 0 caps
        # prefill; 0 is the built split.
        self.split_bias = 0
        self.ladder_rung = 0
        self._saved_host_capacity: list[tuple[Any, int]] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self.resplits = 0
        self.ladder_moves = 0
        self.history: list[dict] = []
        self._last_emitted: dict = {}
        # The ops endpoint's thread reads snapshot() while the loop acts
        # (taken after the SLO policy's lock, never inside it).
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    # wiring
    # ------------------------------------------------------------------ #

    def bind(self, router) -> None:
        if self.router is not None and self.router is not router:
            raise ValueError("an AutoscaleController binds to ONE router")
        if router.failover is None:
            raise ValueError(
                "autoscale requires a FailoverController on the router — "
                "scale actions are its fence/drain/requeue/park machinery"
            )
        self.router = router
        self.failover = router.failover
        fleet = len(router.replicas)
        if self.max_replicas is None:
            self.max_replicas = fleet
        if self.max_replicas > fleet:
            raise ValueError(
                f"max_replicas {self.max_replicas} exceeds the built "
                f"fleet ({fleet}) — every replica is compiled up front; "
                "the controller cannot conjure one"
            )
        if self.min_replicas > self.max_replicas:
            raise ValueError(
                f"want min_replicas <= max_replicas <= fleet, got "
                f"{self.min_replicas} / {self.max_replicas} / {fleet}"
            )
        initial = (self.initial_replicas if self.initial_replicas is not None
                   else self.min_replicas)
        self.initial_replicas = initial = min(initial, self.max_replicas)
        # The spares park at once: built, fenced out of routing.
        now = router.clock()
        for k in range(initial, fleet):
            self.failover.retire(k, 0, now)

    # ------------------------------------------------------------------ #
    # signals
    # ------------------------------------------------------------------ #

    def _harvest_alerts(self) -> None:
        """Read the SLO policy's new transitions: keep the firing set (burn
        alerts only; promoted anomalies are one-shot)."""
        if self.slo is None:
            return
        log = self.slo.alert_log
        while self._alert_idx < len(log):
            rec = log[self._alert_idx]
            self._alert_idx += 1
            state = rec.get("state")
            if state == "firing":
                self._firing[rec["alert"]] = rec
            elif state == "ok":
                self._firing.pop(rec["alert"], None)

    def _replica_sets(self) -> tuple[list[int], list[int]]:
        """(active, parked): degraded counts as active (it holds work),
        dead or role-dead as neither (the failure path owns it)."""
        active, parked = [], []
        for k, h in enumerate(self.failover.health):
            if h.state in ("up", "degraded"):
                active.append(k)
            elif h.state == "parked":
                parked.append(k)
        return active, parked

    def _queue_depth(self, active: list[int]) -> int:
        r = self.router
        return (sum(len(r.replicas[k].queue) for k in active)
                + self.failover.pending)

    def _burning_cause(self, depth: int) -> dict:
        """The cause of a pressure action: the firing alert with the
        hottest fast burn (ties by name), else the queue depth."""
        if self._firing:
            name = max(sorted(self._firing),
                       key=lambda n: self._firing[n]["burn_fast"])
            rec = self._firing[name]
            return {
                "signal": "slo_burn", "objective": name,
                "window_s": rec["window_fast_s"], "burn": rec["burn_fast"],
                "value": depth, "threshold": self.up_queue_depth,
            }
        return {
            "signal": "queue_depth", "objective": None, "window_s": None,
            "burn": None, "value": depth, "threshold": self.up_queue_depth,
        }

    # ------------------------------------------------------------------ #
    # the control loop
    # ------------------------------------------------------------------ #

    def evaluate(self, tick: int, now: float) -> None:
        """One pass: harvest the alerts, update the streaks, take at most
        one action, re-assert the standing rung's effects, emit."""
        self._harvest_alerts()
        active, parked = self._replica_sets()
        depth = self._queue_depth(active)
        pressured = depth >= self.up_queue_depth or bool(self._firing)
        calm = depth == 0 and not self._firing
        self._calm_streak = self._calm_streak + 1 if calm else 0
        # Ladder pressure counts only while no spare is left: capacity
        # first, degradation after.
        self._pressure_streak = (self._pressure_streak + 1
                                 if pressured and not parked else 0)
        action = self._maybe_scale_up(tick, now, parked, depth, pressured)
        if action is None:
            action = self._maybe_deescalate(tick, now)
        if action is None:
            action = self._maybe_scale_down(tick, now, active, depth)
        if action is None:
            action = self._maybe_resplit(tick, now, active)
        if action is None:
            action = self._maybe_escalate(tick, now, depth)
        if action is not None:
            self._record(action, tick, now)
        self._assert_rung_effects(active)
        emitter = self.router.emitter
        if emitter is not None:
            self._emit_stats(emitter)

    # ---- replica scaling ------------------------------------------------

    def _maybe_scale_up(self, tick: int, now: float, parked: list[int],
                        depth: int, pressured: bool) -> dict | None:
        if not parked or not pressured:
            return None
        if self._firing and depth == 0:
            # A burn with nothing queued is not helped by capacity.
            return None
        if tick - self._last_scale_tick < self.cooldown_ticks:
            return None
        active, _ = self._replica_sets()
        if len(active) >= self.max_replicas:
            return None
        k = parked[0]
        self.failover.revive(k, tick, now)
        self._rebalance_queued(now)
        self._last_scale_tick = tick
        self.scale_ups += 1
        return {
            "action": "scale_up", "replica": k,
            "replicas_active": len(active) + 1,
            "cause": self._burning_cause(depth),
        }

    def _rebalance_queued(self, now: float) -> None:
        """Re-place every active replica's queued (never admitted) work
        through the router so the revived replica shares the backlog.
        Queued requests hold no device state: the move is free, charges
        no retry budget, and in-flight slots stay where they are."""
        fo = self.failover
        active, _ = self._replica_sets()
        for k in active:
            s = self.router.replicas[k]
            if not s.queue:
                continue
            queued_ids = [req.id for req in s.queue]
            s.queue.clear()
            s._tenant_counts.clear()
            fo._drain_ids(s, queued_ids, now, charge_retry=False)

    def _maybe_scale_down(self, tick: int, now: float, active: list[int],
                          depth: int) -> dict | None:
        if len(active) <= self.min_replicas:
            return None
        if self._calm_streak < self.down_idle_ticks:
            return None
        if self.ladder_rung > 0:
            # Walk the ladder back to normal before shrinking the fleet.
            return None
        if tick - self._last_scale_tick < self.cooldown_ticks:
            return None
        k = active[-1]
        self.failover.retire(k, tick, now)
        self._last_scale_tick = tick
        self._calm_streak = 0
        self.scale_downs += 1
        return {
            "action": "scale_down", "replica": k,
            "replicas_active": len(active) - 1,
            "cause": {
                "signal": "idle", "objective": None, "window_s": None,
                "burn": None, "value": self.down_idle_ticks,
                "threshold": self.down_idle_ticks,
            },
        }

    # ---- role re-splitting ----------------------------------------------

    def _disagg_targets(self, active: list[int]) -> list[int]:
        return [k for k in active
                if hasattr(self.router.replicas[k].engine, "resplit")]

    def _bias_bounds(self, targets: list[int]) -> tuple[int, int]:
        engines = [self.router.replicas[k].engine for k in targets]
        lo = -min(e.prefill_slots - 1 for e in engines)
        hi = min(e.decode_slots - 1 for e in engines)
        return lo, hi

    def _apply_bias(self, targets: list[int]) -> None:
        for k in targets:
            e = self.router.replicas[k].engine
            e.resplit(e.prefill_slots - max(0, -self.split_bias),
                      e.decode_slots - max(0, self.split_bias))

    def _resplit_action(self, tick: int, targets: list[int], bias: int,
                        direction: str, cause: dict) -> dict:
        self.split_bias = bias
        self._apply_bias(targets)
        self._last_resplit_tick = tick
        self.resplits += 1
        return {"action": "resplit", "direction": direction,
                "replica": None, "split_bias": self.split_bias,
                "cause": cause}

    def _maybe_resplit(self, tick: int, now: float,
                       active: list[int]) -> dict | None:
        if self.aggregator is None:
            return None
        targets = self._disagg_targets(active)
        if not targets:
            return None
        if tick - self._last_resplit_tick < self.resplit_cooldown_ticks:
            return None
        lo, hi = self._bias_bounds(targets)
        # Grow prefill: queue wait dominates the TTFT decomposition.
        decomp = self.aggregator.ttft_decomposition()
        if (decomp is not None
                and decomp["requests"] >= self.resplit_min_requests
                and self.split_bias < hi):
            ttft = decomp["ttft_s"]["mean"]
            frac = decomp["queue_wait_s"]["mean"] / ttft if ttft > 0 else 0.0
            if frac >= self.resplit_queue_wait_frac:
                return self._resplit_action(
                    tick, targets, min(self.split_bias + self.resplit_step,
                                       hi), "grow_prefill", {
                        "signal": "ttft_queue_wait", "objective": None,
                        "window_s": None, "burn": None, "value": frac,
                        "threshold": self.resplit_queue_wait_frac,
                    })
        # Grow decode: TPOT climbs while decode occupancy stays flat.
        if self.resplit_tpot_s is not None and self.split_bias > lo:
            hist = self.aggregator.window_hist("tpot_s",
                                               self.resplit_window_s, now)
            if hist.count >= self.resplit_min_requests:
                p90 = hist.quantile(90)
                occ = self._decode_occupancy(targets)
                if (p90 is not None and p90 > self.resplit_tpot_s
                        and occ <= self.resplit_occupancy_max):
                    return self._resplit_action(
                        tick, targets,
                        max(self.split_bias - self.resplit_step, lo),
                        "grow_decode", {
                            "signal": "tpot_flat_occupancy",
                            "objective": None,
                            "window_s": self.resplit_window_s,
                            "burn": None, "value": p90,
                            "threshold": self.resplit_tpot_s,
                            "occupancy": occ,
                        })
        return None

    def _decode_occupancy(self, targets: list[int]) -> float:
        fracs = []
        for k in targets:
            st = self.router.replicas[k].engine.stats()
            cap = st["decode_slot_cap"]
            if cap > 0:
                fracs.append(st["decode_slots_active"] / cap)
        return sum(fracs) / len(fracs) if fracs else 0.0

    # ---- pressure ladder ------------------------------------------------

    def _maybe_escalate(self, tick: int, now: float,
                        depth: int) -> dict | None:
        if self.ladder_rung >= len(LADDER_RUNGS) - 1:
            return None
        if self._pressure_streak < self.ladder_patience_ticks:
            return None
        if tick - self._last_ladder_tick < self.cooldown_ticks:
            return None
        self.ladder_rung += 1
        self._last_ladder_tick = tick
        self._pressure_streak = 0
        self.ladder_moves += 1
        if LADDER_RUNGS[self.ladder_rung] == "host_tier":
            self._shrink_host_tier()
        return {
            "action": "escalate", "replica": None,
            "rung": LADDER_RUNGS[self.ladder_rung],
            "ladder_rung": self.ladder_rung,
            "cause": {**self._burning_cause(depth),
                      "sustained_ticks": self.ladder_patience_ticks},
        }

    def _maybe_deescalate(self, tick: int, now: float) -> dict | None:
        if self.ladder_rung == 0:
            return None
        if self._calm_streak < self.ladder_patience_ticks:
            return None
        if tick - self._last_ladder_tick < self.cooldown_ticks:
            return None
        left = LADDER_RUNGS[self.ladder_rung]
        self.ladder_rung -= 1
        self._last_ladder_tick = tick
        self._calm_streak = 0
        self.ladder_moves += 1
        if left == "host_tier":
            self._restore_host_tier()
        return {
            "action": "deescalate", "replica": None,
            "rung": LADDER_RUNGS[self.ladder_rung],
            "ladder_rung": self.ladder_rung,
            "cause": {
                "signal": "calm", "objective": None, "window_s": None,
                "burn": None, "value": self.ladder_patience_ticks,
                "threshold": self.ladder_patience_ticks,
            },
        }

    def _shrink_host_tier(self) -> None:
        """Rung 1: every replica's host KV tier emptied and sized to zero
        (future spills refuse; the entries were a cache)."""
        self._saved_host_capacity = []
        for s in self.router.replicas:
            capacity = s.engine.shrink_host_tier()
            if capacity is not None:
                self._saved_host_capacity.append((s.engine, capacity))

    def _restore_host_tier(self) -> None:
        for engine, capacity in self._saved_host_capacity:
            engine.restore_host_tier(capacity)
        self._saved_host_capacity = []

    def _assert_rung_effects(self, active: list[int]) -> None:
        """The failover pass rewrites brown-out margins every tick, so the
        ladder's margin is max-combined after it, every tick."""
        if (self.ladder_rung >= LADDER_RUNGS.index("brownout")
                and self.brownout_margin_s > 0):
            for k in active:
                s = self.router.replicas[k]
                s.brownout_margin = max(s.brownout_margin,
                                        self.brownout_margin_s)

    # ------------------------------------------------------------------ #
    # accounting
    # ------------------------------------------------------------------ #

    def _record(self, action: dict, tick: int, now: float) -> None:
        entry = {"t": now, "tick": tick, **action}
        with self._lock:
            self.history.append(entry)
            del self.history[: -self.history_limit]
        emitter = self.router.emitter
        if emitter is not None:
            # The emitter stamps its own monotone clock: the entry's "t"
            # (the router's, maybe virtual) stays out of the event.
            payload = {k: v for k, v in entry.items() if k != "t"}
            emitter.emit("record", {"record": "autoscale_action",
                                    **payload})

    @property
    def actions(self) -> int:
        return (self.scale_ups + self.scale_downs + self.resplits
                + self.ladder_moves)

    def stats(self) -> dict:
        """The controller's accounting (what the telemetry must equal)."""
        active, parked = self._replica_sets()
        return {
            "actions": self.actions,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "resplits": self.resplits,
            "ladder_moves": self.ladder_moves,
            "replicas_active": len(active),
            "replicas_parked": len(parked),
            "ladder_rung": self.ladder_rung,
            "rung": LADDER_RUNGS[self.ladder_rung],
            "split_bias": self.split_bias,
        }

    def snapshot(self) -> dict[str, Any]:
        """``/slo``'s ``controller`` block: the fleet, the role split, the
        ladder's rung and the last actions with their causes."""
        active, parked = self._replica_sets()
        role_split = None
        targets = self._disagg_targets(active)
        if targets:
            role_split = {
                "bias": self.split_bias,
                "per_replica": {
                    str(k): list(self.router.replicas[k].engine.role_split)
                    for k in targets
                },
            }
        with self._lock:
            actions = [dict(a) for a in self.history]
            counts = {
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "resplits": self.resplits,
                "ladder_moves": self.ladder_moves,
            }
        return {
            "replicas": {"active": len(active), "parked": len(parked),
                         "min": self.min_replicas,
                         "max": self.max_replicas},
            "role_split": role_split,
            "ladder": {"rung": self.ladder_rung,
                       "name": LADDER_RUNGS[self.ladder_rung]},
            "counts": counts,
            "actions": actions,
        }

    def _emit_stats(self, emitter) -> None:
        totals = {
            "autoscale_actions": self.actions,
            "autoscale_scale_ups": self.scale_ups,
            "autoscale_scale_downs": self.scale_downs,
            "autoscale_resplits": self.resplits,
            "autoscale_ladder_moves": self.ladder_moves,
        }
        for name, total in totals.items():
            delta = total - self._last_emitted.get(name, 0)
            if delta:
                emitter.counter_add(name, delta)
        self._last_emitted = totals
        active, _ = self._replica_sets()
        emitter.gauge("autoscale_replicas_active", len(active))
        emitter.gauge("autoscale_ladder_rung", self.ladder_rung)
        emitter.gauge("autoscale_split_bias", self.split_bias)
