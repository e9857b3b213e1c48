"""The port's serving chaos plane and replica failover against the JAX
package's, case for case the cases of JAX's ``tests/test_serve_failover.py``.

Each case runs one scenario (``tests/torch_fleet.py``) through JAX's
router and controller and through the port's, on JAX's tiny GPT-2 (the
port's carries its weights) under a ``VirtualClock``: the greedy tokens
by request id, every record's finish reason, ``retries``,
``replica_history`` and stamps, the routing counters, the controller's
``stats()`` (each death's tick and time) and the tick of every respawn
are equal.  The grammar accepts and refuses the same specs with the same
messages.  Where JAX pins zero new compiles, the port pins that the
pools' storage is the same before and after (nothing allocated again).
"""

import glob
import json

import numpy as np
import pytest
import torch

from tests.torch_fleet import (
    Side, baseline, converted, drive, observe, streams, watch_respawns,
    workload,
)
from tests.torch_shared import shared, shared_parts

DISAGG = dict(prefill_slots=1, decode_slots=2, max_len=48, prefill_chunk=4,
              temperature=0.0, paged=True, block_size=4, num_blocks=36)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _storage(engines) -> list:
    """Every KV tensor's storage address (a re-allocation changes them)."""
    out = []
    for e in engines:
        pools = ([e.prefill_engine.pool, e.decode_engine.pool]
                 if hasattr(e, "prefill_engine") else [e.pool])
        for pool in pools:
            cache = getattr(getattr(pool, "blocks", None), "cache", None) \
                or pool.cache
            out.append([t.data_ptr() for layer in cache for t in layer])
    return out


def _events(path) -> list:
    return [json.loads(line)
            for p in glob.glob(f"{path}/events.rank*.jsonl")
            for line in open(p)]


# --------------------------------------------------------------------- #
# scenarios: each returns the observation both sides must share
# --------------------------------------------------------------------- #


def _failover_case(x, engines, work, spec, oracle, **ctrl_kw):
    clock = x.VirtualClock()
    toks = streams(engines)
    base = dict(retry_budget=2, miss_threshold=2, backoff=x.backoff(0.5))
    base.update(ctrl_kw)
    ctrl = x.FailoverController(**base)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             chaos=x.chaos(spec), failover=ctrl)
    respawns = watch_respawns(ctrl, router)
    storage = _storage(engines) if x.which == "torch" else None
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(work)])
    if storage is not None:
        assert _storage(engines) == storage, "a pool was re-allocated"
    for rid in range(len(work)):
        assert toks[rid] == oracle[rid], (rid, oracle[rid], toks[rid])
    return router, ctrl, toks, respawns


def s_crash_paged(x, tmp):
    work = workload()
    oracle = baseline(x, work)
    router, ctrl, toks, resp = _failover_case(
        x, [x.engine() for _ in range(2)], work, "replica_crash@3:1", oracle)
    return observe(router, ctrl, toks, resp)


def s_crash_contig(x, tmp):
    work = workload(n=6, seed=3)
    oracle = baseline(x, work, paged=False)
    router, ctrl, toks, resp = _failover_case(
        x, [x.engine(paged=False) for _ in range(2)], work,
        "replica_crash@3:0", oracle)
    return observe(router, ctrl, toks, resp)


def s_crash_spec(x, tmp):
    rng = np.random.default_rng(5)
    work = []
    for _ in range(6):
        core = rng.integers(0, 61, (3,)).astype(np.int32)
        work.append((np.tile(core, 3).astype(np.int32), 6))
    oracle = baseline(x, work, spec_k=2)
    router, ctrl, toks, resp = _failover_case(
        x, [x.engine(spec_k=2) for _ in range(2)], work,
        "replica_crash@4:1", oracle)
    return observe(router, ctrl, toks, resp)


def s_stall(x, tmp):
    work = workload(n=6, seed=1)
    oracle = baseline(x, work)
    router, ctrl, toks, resp = _failover_case(
        x, [x.engine() for _ in range(2)], work, "replica_stall@2:0:4",
        oracle, respawn=False)
    return observe(router, ctrl, toks, resp, fenced=sorted(router._fenced))


def _disagg_oracle(x, work, **kw):
    eng = x.disagg(**{**DISAGG, **kw})
    toks = streams([eng])
    sched = x.ContinuousScheduler(eng, max_queue=64, clock=x.VirtualClock())
    for i, (p, b) in enumerate(work):
        sched.submit(x.Request(i, p, b))
    while not sched.idle:
        sched.tick()
    return toks


def _watch_role_deaths(router) -> list:
    """The shared pool's block counts right after each role death (and
    its audit clean)."""
    after: list = []
    inject = router.inject_role_death

    def logged(k, role):
        inject(k, role)
        eng = router.replicas[k].engine
        eng.check_invariants()
        st = eng.stats()
        after.append((k, role, router.tick_index, st["blocks_in_use"],
                      st["blocks_cached"], st["handoffs_queued"]))

    router.inject_role_death = logged
    return after


def s_role_death(x, tmp):
    work = workload(n=6, seed=2, b_lo=4, b_hi=7)
    oracle = _disagg_oracle(x, work)
    out = {}
    for spec in ("replica_crash@2:0:prefill", "replica_crash@3:0:decode"):
        engines = [x.disagg(**DISAGG) for _ in range(2)]
        clock = x.VirtualClock()
        toks = streams(engines)
        ctrl = x.FailoverController(retry_budget=2, miss_threshold=2,
                                    backoff=x.backoff(0.5), respawn=False)
        router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                                 chaos=x.chaos(spec), failover=ctrl)
        after = _watch_role_deaths(router)
        drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                              enumerate(work)])
        for rid in range(len(work)):
            assert toks[rid] == oracle[rid], (spec, rid)
        for e in engines:
            e.check_invariants()
        out[spec] = observe(router, ctrl, toks, eligible=router._eligible(),
                            after_death=after,
                            end_blocks=[e.stats()["blocks_in_use"]
                                        for e in engines])
    return out


def s_role_respawn(x, tmp):
    work = workload(n=4, seed=2, b_lo=3, b_hi=5)
    engines = [x.disagg(**DISAGG) for _ in range(2)]
    clock = x.VirtualClock()
    toks = streams(engines)
    ctrl = x.FailoverController(miss_threshold=2, backoff=x.backoff(0.05))
    router = x.ReplicaRouter(
        engines, max_queue=64, clock=clock,
        chaos=x.chaos("replica_crash@2:0:prefill"), failover=ctrl)
    respawns = watch_respawns(ctrl, router)
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(work)])
    clock.advance(1.0)
    router.tick()
    mid = (ctrl.health[0].state, list(engines[0].dead_roles), ctrl.respawns)
    router.submit(x.Request("post", np.asarray([5, 6, 7], np.int32), 3))
    router.submit(x.Request("post2", np.asarray([8, 9], np.int32), 3))
    while not router.idle:
        router.tick()
        clock.advance(0.01)
    return observe(router, ctrl, toks, respawns, mid=mid)


def s_both_roles(x, tmp):
    work = workload(n=6, seed=2, b_lo=4, b_hi=7)
    engines = [x.disagg(**DISAGG) for _ in range(2)]
    clock = x.VirtualClock()
    toks = streams(engines)
    ctrl = x.FailoverController(miss_threshold=99, backoff=x.backoff(0.05))
    router = x.ReplicaRouter(
        engines, max_queue=64, clock=clock,
        chaos=x.chaos("replica_crash@2:0:prefill,replica_crash@3:0:decode"),
        failover=ctrl)
    respawns = watch_respawns(ctrl, router)
    after = _watch_role_deaths(router)
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(work)])
    deaths = ctrl.health[0].deaths
    clock.advance(1.0)
    router.tick()
    mid = (ctrl.health[0].state, list(engines[0].dead_roles), deaths)
    router.submit(x.Request("post", np.asarray([5, 6, 7], np.int32), 3))
    while not router.idle:
        router.tick()
        clock.advance(0.01)
    for e in engines:
        e.check_invariants()
    return observe(router, ctrl, toks, respawns, mid=mid, after_death=after)


def s_stale_respawn(x, tmp):
    engines = [x.engine() for _ in range(2)]
    clock = x.VirtualClock()
    emitter = x.obs.MetricsEmitter(str(tmp), clock=clock)
    agg = x.obs.LiveAggregator(clock=clock)
    emitter.attach_sink(agg)
    ctrl = x.FailoverController(miss_threshold=2, aggregator=agg,
                                stale_after_s=0.5, backoff=x.backoff(2.0))
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             emitter=emitter,
                             chaos=x.chaos("replica_crash@2:1"),
                             failover=ctrl)
    respawns = watch_respawns(ctrl, router)
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(workload())], dt=0.1)
    deaths = ctrl.stats()["replica_deaths"]
    clock.advance(3.0)
    router.tick()
    states = [ctrl.health[1].state]
    for _ in range(3):
        router.tick()
        clock.advance(0.1)
        states.append(ctrl.health[1].state)
    emitter.close()
    return observe(router, ctrl, None, respawns, deaths_before=deaths,
                   states=states)


def s_monotone(x, tmp):
    engines = [x.engine() for _ in range(2)]
    clock = x.VirtualClock()
    toks = streams(engines)
    ctrl = x.FailoverController(miss_threshold=2, respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             chaos=x.chaos("replica_crash@4:1"),
                             failover=ctrl)
    drive(router, clock, [x.Request(i, p, 8) for i, (p, _) in
                          enumerate(workload())])
    return observe(router, ctrl, toks)


def s_handoff_drop(x, tmp):
    work = [(np.asarray([i + 1, i + 2, i + 3], np.int32), 5)
            for i in range(4)]
    oracle = _disagg_oracle(x, work)
    engines = [x.disagg(**{**DISAGG, "prefill_slots": 2,
                           "decode_slots": 1})]
    toks = streams(engines)
    clock = x.VirtualClock()
    ctrl = x.FailoverController(miss_threshold=99, respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             chaos=x.chaos("handoff_drop@2"), failover=ctrl)
    drop = router.drop_handoff
    dropped: list = []

    def logged():
        rid = drop()
        eng = engines[0]
        eng.check_invariants()
        st = eng.stats()
        dropped.append((rid, st["blocks_in_use"], st["handoffs_queued"]))
        return rid

    router.drop_handoff = logged
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(work)])
    for rid in range(len(work)):
        assert toks[rid] == oracle[rid], rid
    engines[0].check_invariants()
    return observe(router, ctrl, toks, dropped=dropped,
                   handoffs_dropped=engines[0].handoffs_dropped,
                   end_blocks=engines[0].stats()["blocks_in_use"])


def s_double_drain(x, tmp):
    engines = [x.engine() for _ in range(2)]
    clock = x.VirtualClock()
    toks = streams(engines)
    ctrl = x.FailoverController(miss_threshold=2, respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             failover=ctrl)
    for i, (p, b) in enumerate(workload(n=4)):
        router.submit(x.Request(i, p, b))
    router.tick()
    clock.advance(0.01)
    ctrl.declare_dead(1, router.tick_index, clock())
    fo1 = ctrl.stats()
    ctrl.declare_dead(1, router.tick_index, clock())
    ctrl.drain(1, clock())
    fo2 = ctrl.stats()
    while not router.idle:
        router.tick()
        clock.advance(0.01)
    return observe(router, ctrl, toks, fo1=fo1, fo2=fo2)


def s_retry_budget(x, tmp):
    engines = [x.engine() for _ in range(2)]
    clock = x.VirtualClock()
    log = x.RequestLogger(str(tmp / "req.jsonl"))
    ctrl = x.FailoverController(retry_budget=0, miss_threshold=2,
                                respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             request_logger=log,
                             chaos=x.chaos("replica_crash@3:1"),
                             failover=ctrl)
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(workload())])
    summary = x.summarize_records(router.completed,
                                  failover_stats=ctrl.stats())
    logged = sorted(
        (str(r["id"]), r["finish_reason"], r.get("retries"),
         r.get("replica_history")) for r in log.read())
    return observe(router, ctrl, summary={
        k: summary[k] for k in ("failed", "completed", "failover")},
        logged=logged)


def s_duplicate(x, tmp):
    engines = [x.engine() for _ in range(2)]
    clock = x.VirtualClock()
    ctrl = x.FailoverController(miss_threshold=2, respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             failover=ctrl)
    for i, (p, b) in enumerate(workload(n=4)):
        router.submit(x.Request(i, p, b))
    router.tick()
    victims = list(router.replicas[1].engine.live_requests()) + [
        r.id for r in router.replicas[1].queue]
    ctrl.retired.add(victims[0])
    before = ctrl.stats()["duplicates_suppressed"]
    ctrl.declare_dead(1, router.tick_index, clock())
    return {"victims": [int(v) for v in victims], "before": before,
            "stats": ctrl.stats()}


def s_dedupe(x, tmp):
    rec = x.finalize_record({
        "id": "a", "arrival": 0.0, "admitted": 0.1, "first_token": 0.2,
        "finish": 1.0, "finish_reason": "length", "generated": 4,
        "prompt_len": 3, "retries": 1,
    })
    dup = x.finalize_record(dict(rec, finish=2.0, generated=9))
    return x.summarize_records([rec, dup])


def _slow_router(x, tmp, spec, **ctrl_kw):
    engines = [x.engine() for _ in range(2)]
    clock = x.VirtualClock()
    emitter = x.obs.MetricsEmitter(str(tmp), clock=clock)
    ctrl = x.FailoverController(respawn=False, **ctrl_kw)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             emitter=emitter, chaos=x.chaos(spec),
                             failover=ctrl)
    return router, ctrl, clock, emitter, streams(engines)


def s_heartbeat(x, tmp):
    engines = [x.engine() for _ in range(2)]
    clock = x.VirtualClock()
    emitter = x.obs.MetricsEmitter(str(tmp), clock=clock)
    agg = x.obs.LiveAggregator(clock=clock)
    emitter.attach_sink(agg)
    ctrl = x.FailoverController(miss_threshold=10_000, aggregator=agg,
                                stale_after_s=0.5, respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             emitter=emitter,
                             chaos=x.chaos("replica_crash@2:1"),
                             failover=ctrl)
    toks = streams(engines)
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(workload())], dt=0.1)
    emitter.close()
    dead = [(e["replica"], e["tick"], e["cause"]) for e in _events(tmp)
            if e.get("anomaly") == "replica_dead"]
    return observe(router, ctrl, toks, dead=dead)


def s_slow(x, tmp):
    router, ctrl, clock, emitter, toks = _slow_router(
        x, tmp, "replica_slow@1:1:4", miss_threshold=10_000)
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(workload())])
    mid = (ctrl.health[1].state, router._eligible(), router.route(
        x.Request("x", np.asarray([1, 2, 3], np.int32), 2)))
    del router._faults[1]
    for _ in range(router._tick_log[1].maxlen):
        router.tick()
        clock.advance(0.01)
    emitter.close()
    skew = [(e["replica"], e["tick"]) for e in _events(tmp)
            if e.get("anomaly") == "straggler_skew"]
    return observe(router, ctrl, toks, mid=mid, skew=skew)


def s_default_patience(x, tmp):
    engines = [x.engine() for _ in range(2)]
    clock = x.VirtualClock()
    toks = streams(engines)
    ctrl = x.FailoverController(respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             chaos=x.chaos("replica_slow@1:1:4"),
                             failover=ctrl)
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(workload())])
    return observe(router, ctrl, toks)


def s_promoted(x, tmp):
    engines = [x.engine() for _ in range(2)]
    clock = x.VirtualClock()
    emitter = x.obs.MetricsEmitter(str(tmp), clock=clock)
    agg = x.obs.LiveAggregator(clock=clock)
    pol = x.obs.SLOPolicy(agg, [], emitter=emitter)
    emitter.attach_sink(agg)
    emitter.attach_sink(pol)
    ctrl = x.FailoverController(miss_threshold=2, respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             emitter=emitter,
                             chaos=x.chaos("replica_crash@2:0"),
                             failover=ctrl)
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(workload(n=4))])
    emitter.close()
    return observe(router, ctrl, by_alert=x.slo.reduce_alerts(
        pol.alert_log)["anomaly_alerts"]["by_alert"])


def s_brownout(x, tmp):
    engines = [x.engine(num_slots=1) for _ in range(2)]
    clock = x.VirtualClock()
    ctrl = x.FailoverController(miss_threshold=2, brownout_margin_s=5.0,
                                respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             chaos=x.chaos("replica_crash@4:1"),
                             failover=ctrl, affinity=False,
                             sibling_fetch=False)
    reqs = [x.Request(i, p, 8) for i, (p, _) in enumerate(workload(n=2))]
    tail = x.Request("tail", np.asarray([1, 2, 3], np.int32), 4,
                     deadline=2.0)
    for r in reqs:
        router.submit(r)
    router.tick()
    clock.advance(0.01)
    router.submit(tail)
    for _ in range(2):
        router.tick()
        clock.advance(0.01)
    early = [r["id"] for r in router.completed
             if r["finish_reason"] == "shed"]
    while not router.idle:
        router.tick()
        clock.advance(0.01)
    return observe(router, ctrl, early_shed=early)


def s_fairness(x, tmp):
    engines = [x.engine(num_slots=1) for _ in range(2)]
    clock = x.VirtualClock()
    ctrl = x.FailoverController(miss_threshold=2, respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             failover=ctrl, affinity=False,
                             sibling_fetch=False)
    p = np.asarray([1, 2, 3], np.int32)
    router.submit(x.Request("a", p, 2, tenant="A"))
    router.submit(x.Request("b", p + 1, 2, tenant="B"))
    router.submit(x.Request("a2", p + 2, 2, tenant="A"))
    router.submit(x.Request("b2", p + 3, 2, tenant="B"))
    queued = [r.tenant for r in router.replicas[1].queue]
    ctrl.declare_dead(1, router.tick_index, clock())
    order, seen = [], set()
    while not router.idle:
        router.tick()
        for rec in router.replicas[0].records.values():
            if rec["admitted"] is not None and rec["id"] not in seen:
                seen.add(rec["id"])
                order.append(rec["tenant"])
        clock.advance(0.01)
    return observe(router, ctrl, queued=queued, order=order)


def s_pending(x, tmp):
    engines = [x.engine()]
    clock = x.VirtualClock()
    ctrl = x.FailoverController(miss_threshold=2, backoff=x.backoff(0.05))
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             chaos=x.chaos("replica_crash@2:0"),
                             failover=ctrl)
    toks = streams(engines)
    respawns = watch_respawns(ctrl, router)
    for i, (p, b) in enumerate(workload(n=3, seed=6)):
        router.submit(x.Request(i, p, b))
    for _ in range(4):
        router.tick()
        clock.advance(0.01)
    mid = (ctrl.health[0].state, ctrl.pending, router.idle,
           router.submit(x.Request("new", np.asarray([1, 2], np.int32), 2)),
           router.rejected)
    clock.advance(1.0)
    ticks = 0
    while not router.idle and ticks < 200:
        router.tick()
        clock.advance(0.01)
        ticks += 1
    return observe(router, ctrl, toks, respawns, mid=mid)


def s_shed_tracking(x, tmp):
    engines = [x.engine(num_slots=1) for _ in range(2)]
    clock = x.VirtualClock()
    ctrl = x.FailoverController(miss_threshold=99, respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             failover=ctrl)
    router.submit(x.Request("gone", np.asarray([1, 2, 3], np.int32), 2,
                            deadline=-1.0))
    tracked = "gone" in ctrl._tracked
    router.tick()
    router.tick()
    return observe(router, ctrl, tracked=[tracked, "gone" in ctrl._tracked,
                                          "gone" in ctrl.retired])


def s_force(x, tmp):
    sched = x.ContinuousScheduler(x.engine(), max_queue=1,
                                  clock=x.VirtualClock())
    p = np.asarray([1, 2, 3], np.int32)
    return [sched.submit(x.Request(0, p, 2)), sched.submit(x.Request(1, p, 2)),
            sched.submit(x.Request(2, p, 2), force=True), len(sched.queue)]


def s_telemetry(x, tmp):
    from tools.telemetry_report import build_report

    engines = [x.engine() for _ in range(2)]
    clock = x.VirtualClock()
    emitter = x.obs.MetricsEmitter(str(tmp), clock=clock)
    ctrl = x.FailoverController(miss_threshold=2, respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             emitter=emitter,
                             chaos=x.chaos("replica_crash@3:1"),
                             failover=ctrl)
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(workload())])
    emitter.summary()
    emitter.close()
    totals, gauges = {}, {}
    for ev in _events(tmp):
        if ev.get("kind") == "summary":
            totals = ev.get("counters", {})
            gauges = ev.get("gauges", {})
    rf = build_report(str(tmp))["serving"]["failover"]
    names = ("replica_deaths", "failover_requeued_requests",
             "failover_retried_requests", "failover_duplicates_suppressed",
             "finished_requests")
    return observe(router, ctrl, counters={n: totals.get(n, 0)
                                           for n in names},
                   replicas_dead=gauges.get("replicas_dead"), report=rf)


SCENARIOS = {
    "crash_paged": s_crash_paged, "crash_contig": s_crash_contig,
    "crash_spec": s_crash_spec, "stall": s_stall, "role_death": s_role_death,
    "role_respawn": s_role_respawn, "both_roles": s_both_roles,
    "stale_respawn": s_stale_respawn, "monotone": s_monotone,
    "handoff_drop": s_handoff_drop, "double_drain": s_double_drain,
    "retry_budget": s_retry_budget, "duplicate": s_duplicate,
    "dedupe": s_dedupe, "heartbeat": s_heartbeat, "slow": s_slow,
    "default_patience": s_default_patience, "promoted": s_promoted,
    "brownout": s_brownout, "fairness": s_fairness, "pending": s_pending,
    "shed_tracking": s_shed_tracking, "force": s_force,
    "telemetry": s_telemetry,
}
# The JAX side in parts, so xdist workers compute them side by side.
PARTS = {
    "a": ("crash_paged", "crash_contig", "crash_spec", "stall"),
    "b": ("role_death", "role_respawn", "both_roles", "handoff_drop"),
    "c": ("stale_respawn", "monotone", "double_drain", "retry_budget",
          "duplicate", "dedupe", "heartbeat", "slow"),
    "d": ("default_patience", "promoted", "brownout", "fairness",
          "pending", "shed_tracking", "force", "telemetry"),
}


def _jax_part(names, tmp_path_factory) -> dict:
    side = Side("jax")
    return {n: SCENARIOS[n](side, tmp_path_factory.mktemp(f"jax_{n}"))
            for n in names}


@pytest.fixture(scope="module")
def jax_side(request, tmp_path_factory):
    parts = shared_parts(request, tmp_path_factory, "torch_fleet_failover", {
        p: (lambda names=names: _jax_part(names, tmp_path_factory))
        for p, names in PARTS.items()})
    return {n: v for part in parts.values() for n, v in part.items()}


@pytest.fixture(scope="module")
def port(request, tmp_path_factory):
    named = shared(request, tmp_path_factory, "torch_serve_tiny_params",
                   converted)
    return Side("torch", named)


def _run(port, jax_side, name, tmp_path):
    got = SCENARIOS[name](port, tmp_path)
    assert got == jax_side[name], (name, got, jax_side[name])
    return got


def _exactly_once(obs, n):
    assert len(obs["ids"]) == len(set(obs["ids"])) == n


# --------------------------------------------------------------------- #
# grammar and markers
# --------------------------------------------------------------------- #


def test_parse_serve_faults_grammar():
    from pytorch_distributed_training_tpu.resilience import (
        parse_serve_faults as jax_parse,
    )
    from pytorch_distributed_training_tpu_torch.resilience import (
        ServeFault, parse_serve_faults,
    )

    spec = ("replica_crash@3:1, replica_stall@5:0:6, replica_slow@2:1:4,"
            "handoff_drop@7, replica_crash@9:0:prefill, replica_stall@4:1")
    faults = parse_serve_faults(spec)
    assert faults[0] == ServeFault("replica_crash", 3, 1, None, None)
    assert faults[4] == ServeFault("replica_crash", 9, 0, None, "prefill")
    assert faults[5].arg == 8.0
    assert [(f.kind, f.tick, f.replica, f.arg, f.role, f.name)
            for f in faults] == [(f.kind, f.tick, f.replica, f.arg, f.role,
                                  f.name) for f in jax_parse(spec)]


@pytest.mark.parametrize("bad", [
    "replica_crash@3", "replica_slow@2:1", "replica_slow@2:1:1",
    "replica_crash@3:1:verify", "handoff_drop@3:1", "replica_melt@3:1",
    "replica_crash@x:1", "replica_crash@0:1", "replica_stall@5:0:0",
    "replica_slow@2:1:1.5",
])
def test_parse_serve_faults_rejects_bad_entries(bad):
    """Refused with JAX's message, word for word."""
    from pytorch_distributed_training_tpu.resilience import (
        parse_serve_faults as jax_parse,
    )
    from pytorch_distributed_training_tpu_torch.resilience import (
        parse_serve_faults,
    )

    with pytest.raises(ValueError) as jax_err:
        jax_parse(bad)
    with pytest.raises(ValueError) as err:
        parse_serve_faults(bad)
    assert str(err.value) == str(jax_err.value)


def test_router_rejects_out_of_range_fault_replica(port):
    with pytest.raises(ValueError, match="out of range"):
        port.ReplicaRouter([port.engine()],
                           chaos=port.chaos("replica_crash@3:5"))


def test_failover_skew_window_sizes_router_tick_log(port):
    ctrl = port.FailoverController(skew_window=32, min_skew_obs=20)
    router = port.ReplicaRouter([port.engine() for _ in range(2)],
                                failover=ctrl)
    assert all(log.maxlen == 32 for log in router._tick_log)
    with pytest.raises(ValueError):
        port.FailoverController(skew_window=16, min_skew_obs=32)


class _FakeRouter:
    def __init__(self):
        self.calls = []

    def set_fault(self, k, kind, **kw):
        self.calls.append((k, kind, kw))

    def drop_handoff(self):
        self.calls.append(("drop",))


def test_serve_fault_markers_once_per_run(tmp_path):
    """A fired fault writes its marker; a relaunched injector replaying
    the trace never fires it again."""
    from pytorch_distributed_training_tpu_torch.resilience import (
        ServeFaultInjector,
    )

    state = str(tmp_path / ".fault_state")
    r1 = _FakeRouter()
    inj = ServeFaultInjector.from_spec("replica_crash@3:1,replica_stall@2:0:3"
                                       ",handoff_drop@4", state_dir=state)
    for t in range(1, 5):
        inj.on_tick(t, r1)
    assert r1.calls == [(0, "stall", {"until_tick": 5}), (1, "crash", {}),
                        ("drop",)]
    r2 = _FakeRouter()
    inj2 = ServeFaultInjector.from_spec("replica_crash@3:1", state_dir=state)
    for t in range(1, 5):
        inj2.on_tick(t, r2)
    assert r2.calls == []


# --------------------------------------------------------------------- #
# token-exact failover across engine flavors
# --------------------------------------------------------------------- #


def test_failover_crash_token_exact_paged(port, jax_side, tmp_path):
    got = _run(port, jax_side, "crash_paged", tmp_path)
    _exactly_once(got, 8)
    fo = got["stats"]
    assert fo["replica_deaths"] == 1 and fo["deaths"][0]["replica"] == 1
    assert fo["requeued"] + fo["retried"] >= 1
    assert fo["failed"] == 0 and fo["duplicates_suppressed"] == 0
    retried = [r for r in got["records"].values() if r["retries"]]
    assert retried
    for r in retried:
        assert r["replica_history"][0] == 1
        assert r["replica_history"][-1] == 0


def test_failover_crash_token_exact_contiguous(port, jax_side, tmp_path):
    _exactly_once(_run(port, jax_side, "crash_contig", tmp_path), 6)


def test_failover_crash_token_exact_speculative(port, jax_side, tmp_path):
    _exactly_once(_run(port, jax_side, "crash_spec", tmp_path), 6)


def test_failover_stall_declared_dead_and_fenced(port, jax_side, tmp_path):
    got = _run(port, jax_side, "stall", tmp_path)
    assert got["health"][0][0] == "dead" and got["fenced"] == [0]
    assert got["stats"]["duplicates_suppressed"] == 0


def test_disagg_role_death_token_exact(port, jax_side, tmp_path):
    """Either role dies: the tier's tokens are the oracle's, the shared
    pool gives back exactly the blocks the role held (its counts equal
    JAX's right after the death and at the end, the audit clean)."""
    got = _run(port, jax_side, "role_death", tmp_path)
    for spec, role in (("replica_crash@2:0:prefill", "prefill"),
                       ("replica_crash@3:0:decode", "decode")):
        run = got[spec]
        _exactly_once(run, 6)
        assert run["health"][0] == ["role_dead", 1, role]
        (death,) = run["stats"]["deaths"]
        assert death["role"] == role
        assert run["eligible"] == [1]
        assert run["end_blocks"] == [0, 0]


def test_disagg_role_respawn_revives_role(port, jax_side, tmp_path):
    got = _run(port, jax_side, "role_respawn", tmp_path)
    assert got["mid"] == ["up", [], 1]
    assert any(r["replica"] == 0 for i, r in got["records"].items()
               if i in ("post", "post2"))


def test_both_roles_dead_then_respawn_revives_both(port, jax_side, tmp_path):
    got = _run(port, jax_side, "both_roles", tmp_path)
    assert got["mid"] == ["up", [], 2]
    assert got["records"]["post"]["finish_reason"] in ("eos", "length")


def test_respawn_does_not_redeclare_death_from_stale_heartbeat(
        port, jax_side, tmp_path):
    got = _run(port, jax_side, "stale_respawn", tmp_path)
    assert got["states"] == ["up"] * 4
    assert got["stats"]["replica_deaths"] == 1
    assert got["stats"]["respawns"] == 1


def test_retried_record_keeps_monotone_admission_chain(port, jax_side,
                                                       tmp_path):
    got = _run(port, jax_side, "monotone", tmp_path)
    retried = [r for r in got["records"].values() if r["retries"]]
    assert retried
    for r in retried:
        assert r["arrival"] <= r["admitted"]
        if r["first_token"] is not None:
            assert r["admitted"] <= r["first_token"] <= r["finish"]


def test_handoff_drop_orphan_requeued(port, jax_side, tmp_path):
    """The dropped handoff's export is released at once (the pool's
    counts equal JAX's right after the drop, the audit clean) and the
    orphan sweep requeues it token-exactly."""
    got = _run(port, jax_side, "handoff_drop", tmp_path)
    _exactly_once(got, 4)
    assert got["handoffs_dropped"] == 1 and got["stats"]["retried"] == 1
    assert got["dropped"][0][0] is not None and got["end_blocks"] == 0


# --------------------------------------------------------------------- #
# exactly-once retirement
# --------------------------------------------------------------------- #


def test_double_drain_idempotent(port, jax_side, tmp_path):
    got = _run(port, jax_side, "double_drain", tmp_path)
    for key in ("requeued", "retried", "duplicates_suppressed",
                "replica_deaths"):
        assert got["fo1"][key] == got["fo2"][key], key
    _exactly_once(got, 4)


def test_retry_budget_exhaustion_fails_request(port, jax_side, tmp_path):
    got = _run(port, jax_side, "retry_budget", tmp_path)
    failed = [r for r in got["records"].values()
              if r["finish_reason"] == "failed"]
    assert failed and len(failed) == got["stats"]["failed"]
    assert all(r["retries"] == 0 and r["replica_history"] == [1]
               for r in failed)
    s = got["summary"]
    assert s["failed"] == len(failed) and s["completed"] == 8 - len(failed)
    assert s["failover"]["replica_deaths"] == 1
    assert any(reason == "failed" for _, reason, _, _ in got["logged"])


def test_duplicate_suppression_on_drain(port, jax_side, tmp_path):
    got = _run(port, jax_side, "duplicate", tmp_path)
    assert got["stats"]["duplicates_suppressed"] == got["before"] + 1


def test_summarize_records_dedupes_by_id(port, jax_side, tmp_path):
    got = _run(port, jax_side, "dedupe", tmp_path)
    assert got["completed"] == 1 and got["generated_tokens"] == 4
    assert got["failover"]["duplicate_records_excluded"] == 1


def test_failed_requests_burn_goodput_budget():
    from pytorch_distributed_training_tpu_torch.obs.slo import (
        RATIO_OBJECTIVES,
    )

    assert "failed_requests" in RATIO_OBJECTIVES["goodput"]["bad"]


# --------------------------------------------------------------------- #
# detection from live signals
# --------------------------------------------------------------------- #


def test_detection_via_heartbeat_staleness(port, jax_side, tmp_path):
    got = _run(port, jax_side, "heartbeat", tmp_path)
    assert got["health"][1][0] == "dead"
    _exactly_once(got, 8)
    assert got["dead"][0][2] == "heartbeat_stale"


def test_replica_slow_degrades_and_routing_avoids_it(port, jax_side,
                                                     tmp_path):
    got = _run(port, jax_side, "slow", tmp_path)
    assert got["mid"] == ["degraded", [0], 0]
    assert got["health"][1][0] == "up"
    assert got["skew"] and got["skew"][0][0] == 1


def test_default_patience_degrades_slow_replica_instead_of_killing(
        port, jax_side, tmp_path):
    got = _run(port, jax_side, "default_patience", tmp_path)
    assert got["health"][1][0] == "degraded"
    assert got["stats"]["replica_deaths"] == 0
    _exactly_once(got, 8)


def test_replica_dead_anomaly_promoted_to_alert(port, jax_side, tmp_path):
    got = _run(port, jax_side, "promoted", tmp_path)
    assert got["by_alert"].get("replica_dead") == 1


# --------------------------------------------------------------------- #
# graceful degradation
# --------------------------------------------------------------------- #


def test_brownout_sheds_early_only_under_capacity_loss(port, jax_side,
                                                       tmp_path):
    got = _run(port, jax_side, "brownout", tmp_path)
    assert got["early_shed"] == []
    shed = [i for i, r in got["records"].items()
            if r["finish_reason"] == "shed"]
    assert shed == ["tail"] and got["records"]["tail"]["finish"] < 2.0


def test_requeue_preserves_tenant_fairness(port, jax_side, tmp_path):
    got = _run(port, jax_side, "fairness", tmp_path)
    assert got["queued"] == ["B", "B"]
    assert got["order"] == ["A", "B", "A", "B"]
    _exactly_once(got, 4)


def test_no_eligible_replica_rejects_then_pending_flushes(port, jax_side,
                                                          tmp_path):
    got = _run(port, jax_side, "pending", tmp_path)
    state, pending, idle, accepted, rejected = got["mid"]
    assert state == "dead" and pending > 0 and not idle
    assert accepted is False and rejected >= 1
    assert got["stats"]["respawns"] == 1 and got["stats"][
        "pending_requeues"] == 0
    _exactly_once(got, 3)


def test_shed_requests_release_tracking_state(port, jax_side, tmp_path):
    got = _run(port, jax_side, "shed_tracking", tmp_path)
    assert got["tracked"] == [True, False, True]
    assert got["records"]["gone"]["finish_reason"] == "shed"


def test_scheduler_force_submit_bypasses_queue_bound(port, jax_side,
                                                     tmp_path):
    assert _run(port, jax_side, "force", tmp_path) == [True, False, True, 2]


# --------------------------------------------------------------------- #
# telemetry == host accounting == report
# --------------------------------------------------------------------- #


def test_failover_counters_equal_telemetry_and_report(port, jax_side,
                                                      tmp_path):
    """The port's counters equal its telemetry, and JAX's
    ``tools/telemetry_report.py`` reduces the port's log to JAX's
    failover section."""
    got = _run(port, jax_side, "telemetry", tmp_path)
    fo, c = got["stats"], got["counters"]
    assert c["replica_deaths"] == fo["replica_deaths"] == 1
    assert c["failover_requeued_requests"] == fo["requeued"]
    assert c["failover_retried_requests"] == fo["retried"]
    assert c["finished_requests"] == 8 and got["replicas_dead"] == 1
    rf = got["report"]
    assert rf["death_events"] == [{"replica": 1, "tick": fo["deaths"][0][
        "tick"], "cause": "missed_ticks"}]


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #

CLI = ["--serve", "--use-cpu", "--model", "gpt2", "--seq-len", "32",
       "--model-overrides",
       "num_layers=2,hidden_dim=64,num_heads=2,vocab_size=256,max_seq_len=64",
       "--serve-requests", "6", "--serve-slots", "2", "--serve-max-new", "8",
       "--serve-paged"]
FLAGS = ("serve_inject_faults", "serve_failover", "serve_retry_budget",
         "serve_brownout_s", "serve_autoscale", "serve_autoscale_min",
         "serve_autoscale_max", "serve_autoscale_up_depth",
         "serve_autoscale_down_idle", "serve_autoscale_cooldown",
         "serve_priority")


def test_cli_serving_fleet_flags_have_jax_defaults():
    """The eleven flags of the serving fleet, with the JAX CLI's defaults
    (``--serve-failover`` on)."""
    from pytorch_distributed_training_tpu.cli.main import main as jax_main
    from pytorch_distributed_training_tpu_torch.cli.main import build_parser

    jax_defaults = {p.name: p.default for p in jax_main.params}
    args = build_parser().parse_args([])
    for name in FLAGS:
        assert getattr(args, name) == jax_defaults[name], name


@pytest.mark.parametrize("extra,replicas", [
    (["--serve-replicas", "2", "--serve-kv-host-mb", "1",
      "--serve-inject-faults", "replica_crash@4:1"], [0, 1]),
    (["--serve-inject-faults", "replica_crash@2:0"], [0]),
])
def test_cli_chaos_run_fails_over(extra, replicas, capsys):
    """A fault spec arms the chaos plane and forces the router (even at
    one replica); failover finishes every request exactly once and the
    failover line prints."""
    from pytorch_distributed_training_tpu_torch.cli.main import main

    res = main(CLI + extra)
    assert res["summary"]["completed"] == 6
    assert len(res["tokens"]) == 6
    fo = res["router"]["failover"]
    assert fo["replica_deaths"] == 1
    assert res["router"]["replicas"] == len(replicas)
    assert "failover: deaths=1" in capsys.readouterr().out


def test_cli_fleet_refusals_and_elastic_child_argv():
    """Autoscale without failover and a bad priority spec are refused
    (exit 2), and ``--elastic`` carries ``--no-serve-failover`` (and the
    other fleet flags) to its supervised child."""
    from pytorch_distributed_training_tpu_torch.cli.main import (
        _child_argv, build_parser, main,
    )

    for extra in (["--serve-autoscale", "--no-serve-failover"],
                  ["--serve-priority", "interactive"]):
        with pytest.raises(SystemExit) as err:
            main(CLI + extra)
        assert err.value.code == 2
    parser = build_parser()
    args = parser.parse_args(CLI + [
        "--no-serve-failover", "--serve-inject-faults", "replica_crash@3:0",
        "--serve-retry-budget", "4", "--elastic", "--checkpoint-dir", "d"])
    child = _child_argv(parser, args)
    assert "--no-serve-failover" in child and "--elastic" not in child
    assert child[child.index("--serve-inject-faults") + 1] == \
        "replica_crash@3:0"
    assert child[child.index("--serve-retry-budget") + 1] == "4"
    assert parser.parse_args(child).serve_failover is False
