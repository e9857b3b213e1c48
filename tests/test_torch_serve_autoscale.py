"""The port's closed-loop serving control (``serve/autoscale.py``) and
SLO-weighted priority admission (``serve/policy.py``) against the JAX
package's, case for case the cases of JAX's
``tests/test_serve_autoscale.py``.

The grammars (``--slo``'s per-class brackets, ``--serve-priority``)
accept and refuse alike, with the same messages; the weighted-deficit pop
gives the same admission sequence as JAX's (shares, no starvation, a
blocked head keeping its turn, the SLO boost); and each fleet scenario
(``tests/torch_fleet.py``) runs through JAX's router and controllers and
the port's on JAX's tiny GPT-2 under a ``VirtualClock``: the action
lists equal event for event (tick, cause, values), the tokens, records
and stats equal, scale up and down at JAX's ticks, the re-split walks
and the pressure ladder's order, and ``/slo``'s controller block equal
to ``snapshot()``.  Where JAX pins zero new compiles per action, the
port pins that no pool is allocated again.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from tests.torch_fleet import (
    Side, baseline, converted, drive, observe, streams, workload,
)
from tests.torch_shared import shared, shared_parts

DISAGG = dict(prefill_slots=2, decode_slots=2, max_len=48, prefill_chunk=4,
              temperature=0.0, paged=True, block_size=4, num_blocks=48)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _storage(engines) -> list:
    out = []
    for e in engines:
        pool = e.blocks if hasattr(e, "prefill_engine") else e.pool
        cache = getattr(getattr(pool, "blocks", None), "cache", None) \
            or pool.cache
        out.append([t.data_ptr() for layer in cache for t in layer])
    return out


def _actions(auto) -> list:
    return [(a["tick"], a["action"], a["cause"]["signal"])
            for a in auto.history]


# --------------------------------------------------------------------- #
# policy mechanics (the three attributes the policy reads)
# --------------------------------------------------------------------- #


class _FakeSched:
    def __init__(self, clock):
        self.queue: list = []
        self._tenant_counts: dict = {}
        self.clock = clock

    def push(self, r):
        self.queue.append(r)
        self._tenant_counts[r.tenant] = self._tenant_counts.get(r.tenant,
                                                                0) + 1

    def pop(self, r):
        self.queue.remove(r)
        n = self._tenant_counts[r.tenant] - 1
        if n:
            self._tenant_counts[r.tenant] = n
        else:
            del self._tenant_counts[r.tenant]


def _req(x, i, tenant):
    return x.Request(i, np.zeros(1, np.int32), 1, tenant=tenant)


class _Hist:
    def __init__(self, count, q):
        self.count = count
        self._q = q

    def quantile(self, q):
        return self._q


class _BoostAgg:
    def __init__(self):
        self.breach = False

    def window_hist(self, name, window_s, now):
        return _Hist(10, 1.0 if self.breach else 0.0)


def s_deficit(x, tmp):
    clock = x.VirtualClock()
    pol = x.ServePolicy({"heavy": 4.0, "light": 1.0}, clock=clock)
    sched = _FakeSched(clock)
    uid = itertools.count()
    seq = []

    def refill():
        while sum(1 for r in sched.queue if r.tenant == "heavy") < 6:
            sched.push(_req(x, next(uid), "heavy"))
        if not any(r.tenant == "light" for r in sched.queue):
            sched.push(_req(x, next(uid), "light"))

    refill()
    for _ in range(200):
        cand = pol.admit_candidate(sched)
        sched.pop(cand)
        pol.on_admit(sched, cand)
        seq.append(cand.tenant)
        refill()
    return {"seq": seq, "admitted": pol.admitted_by_class,
            "boosted": pol.boosted_admissions}


def s_blocked(x, tmp):
    clock = x.VirtualClock()
    pol = x.ServePolicy({"a": 2.0, "b": 1.0}, clock=clock)
    sched = _FakeSched(clock)
    for i, t in enumerate(["a", "b", "a"]):
        sched.push(_req(x, i, t))
    first = pol.admit_candidate(sched)
    credits = dict(sched._policy_credits)
    again = pol.admit_candidate(sched)
    return {"first": first.id, "same": again is first,
            "credits": credits, "after": dict(sched._policy_credits)}


def s_boost(x, tmp):
    clock = x.VirtualClock()
    agg = _BoostAgg()
    pol = x.ServePolicy({"interactive": 1.0, "batch": 1.0}, slo_boost=3.0,
                        aggregator=agg, clock=clock)
    pol.bind_objectives(x.slo.parse_slo_spec("ttft_p99[interactive]=250ms"))
    weights = [pol.effective_weight("interactive", clock())]
    agg.breach = True
    weights += [pol.effective_weight("interactive", clock()),
                pol.effective_weight("batch", clock())]
    sched = _FakeSched(clock)
    uid = itertools.count()
    seq = []
    for _ in range(40):
        while sum(1 for r in sched.queue if r.tenant == "interactive") < 2:
            sched.push(_req(x, next(uid), "interactive"))
        while sum(1 for r in sched.queue if r.tenant == "batch") < 2:
            sched.push(_req(x, next(uid), "batch"))
        cand = pol.admit_candidate(sched)
        sched.pop(cand)
        pol.on_admit(sched, cand)
        seq.append(cand.tenant)
    return {"weights": weights, "seq": seq,
            "boosted": pol.boosted_admissions, "snapshot": pol.snapshot()}


# --------------------------------------------------------------------- #
# fleet scenarios
# --------------------------------------------------------------------- #


def s_real_scheduler(x, tmp):
    work = workload(n=6, seed=7)
    oracle = baseline(x, work)
    pol = x.ServePolicy({"interactive": 4.0, "batch": 1.0})
    order = []
    orig = pol.on_admit
    pol.on_admit = lambda s, r: (order.append(r.tenant), orig(s, r))[1]
    eng = x.engine()
    toks = streams([eng])
    sched = x.ContinuousScheduler(eng, max_queue=64, clock=x.VirtualClock(),
                                  policy=pol)
    for i, (p, b) in enumerate(work):
        sched.submit(x.Request(i, p, b,
                               tenant="interactive" if i % 2 else "batch"))
    while not sched.idle:
        sched.tick()
    for rid in range(len(work)):
        assert toks[rid] == oracle[rid]
    return {"order": order, "admitted": pol.admitted_by_class,
            "tokens": {str(k): v for k, v in toks.items()}}


def _scale_run(x, run_dir, work):
    clock = x.VirtualClock()
    emitter = x.obs.MetricsEmitter(str(run_dir), clock=clock)
    agg = x.obs.LiveAggregator(clock=clock)
    emitter.attach_sink(agg)
    engines = [x.engine() for _ in range(2)]
    toks = streams(engines)
    auto = x.AutoscaleController(min_replicas=1, up_queue_depth=4,
                                 down_idle_ticks=6, cooldown_ticks=2)
    ctrl = x.FailoverController(respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             emitter=emitter, failover=ctrl, autoscale=auto)
    storage = _storage(engines) if x.which == "torch" else None
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(work)])
    for _ in range(12):
        router.tick()
        clock.advance(0.01)
    if storage is not None:
        assert _storage(engines) == storage, "a pool was re-allocated"
    emitter.close()
    gauges = agg.snapshot()["gauges"]
    return observe(
        router, ctrl, toks, history=auto.history, auto=auto.stats(),
        counters={n: agg.counter(n) for n in (
            "autoscale_actions", "autoscale_scale_ups",
            "autoscale_scale_downs")},
        gauges={n: gauges.get(n) for n in (
            "autoscale_replicas_active", "autoscale_ladder_rung")},
        pending_gauge="router_pending_depth" in gauges)


def s_scale(x, tmp):
    work = workload(n=10, seed=3)
    oracle = baseline(x, work)
    a = _scale_run(x, tmp / "a", work)
    b = _scale_run(x, tmp / "b", work)
    for rid in range(len(work)):
        assert a["tokens"][str(rid)] == oracle[rid]
    return {"a": a, "b": b}


def s_chaos_spare(x, tmp):
    work = workload(n=12, seed=5)
    oracle = baseline(x, work)
    clock = x.VirtualClock()
    engines = [x.engine() for _ in range(3)]
    toks = streams(engines)
    auto = x.AutoscaleController(min_replicas=1, initial_replicas=2,
                                 up_queue_depth=3, cooldown_ticks=2,
                                 down_idle_ticks=64)
    ctrl = x.FailoverController(respawn=False, retry_budget=2)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             chaos=x.chaos("replica_crash@4:0"),
                             failover=ctrl, autoscale=auto)
    storage = _storage(engines) if x.which == "torch" else None
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(work)])
    if storage is not None:
        assert _storage(engines) == storage
    for rid in range(len(work)):
        assert toks[rid] == oracle[rid]
    return observe(router, ctrl, toks, history=auto.history,
                   auto=auto.stats())


def s_park(x, tmp):
    clock = x.VirtualClock()
    ctrl = x.FailoverController(respawn=False)
    router = x.ReplicaRouter([x.engine() for _ in range(2)], max_queue=64,
                             clock=clock, failover=ctrl)
    seen = []
    ctrl.retire(1, 0, clock())
    seen.append((ctrl.health[1].state, 1 in router._fenced))
    ctrl.retire(1, 0, clock())
    seen.append(ctrl.health[1].state)
    ctrl.revive(1, 1, clock())
    seen.append((ctrl.health[1].state, 1 in router._fenced))
    ctrl.revive(1, 1, clock())
    seen.append(ctrl.health[1].state)
    ctrl.declare_dead(1, 2, clock())
    with pytest.raises(ValueError) as err:
        ctrl.retire(1, 2, clock())
    seen.append(str(err.value))
    return seen


def s_validation(x, tmp):
    msgs = []
    for kw in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
               dict(min_replicas=2, initial_replicas=1),
               dict(up_queue_depth=0), dict(resplit_queue_wait_frac=1.5),
               dict(brownout_margin_s=-0.1)):
        with pytest.raises(ValueError) as err:
            x.AutoscaleController(**kw)
        msgs.append(str(err.value))
    for kw in (dict(autoscale=x.AutoscaleController()),
               dict(failover=x.FailoverController(respawn=False),
                    autoscale=x.AutoscaleController(max_replicas=3))):
        with pytest.raises(ValueError) as err:
            x.ReplicaRouter([x.engine()], **kw)
        msgs.append(str(err.value))
    return msgs


class _ResplitAgg:
    def __init__(self):
        self.decomp = None
        self.tpot = _Hist(0, None)

    def ttft_decomposition(self):
        return self.decomp

    def window_hist(self, name, window_s, now):
        return self.tpot


def s_resplit(x, tmp):
    clock = x.VirtualClock()
    engines = [x.disagg(**DISAGG) for _ in range(2)]
    agg = _ResplitAgg()
    auto = x.AutoscaleController(min_replicas=2, initial_replicas=2,
                                 resplit_cooldown_ticks=1,
                                 resplit_min_requests=4,
                                 resplit_tpot_s=0.05, aggregator=agg)
    ctrl = x.FailoverController(respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             failover=ctrl, autoscale=auto)
    storage = _storage(engines) if x.which == "torch" else None
    splits = [[e.role_split for e in engines]]
    agg.decomp = {"requests": 8, "ttft_s": {"mean": 1.0},
                  "queue_wait_s": {"mean": 0.8}}
    auto.evaluate(1, clock())
    splits.append([e.role_split for e in engines])
    agg.decomp = None
    agg.tpot = _Hist(8, 0.2)
    for t in (2, 3, 4):
        auto.evaluate(t, clock())
        splits.append([e.role_split for e in engines])
    agg.tpot = _Hist(0, None)
    work = workload(n=6, seed=9)
    oracle = baseline(x, work)
    toks = streams(engines)
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(work)])
    if storage is not None:
        assert _storage(engines) == storage
    for rid in range(len(work)):
        assert toks[rid] == oracle[rid]
    return observe(router, ctrl, toks, history=auto.history,
                   auto=auto.stats(), splits=splits,
                   snapshot=auto.snapshot())


def s_ladder(x, tmp):
    clock = x.VirtualClock()
    engines = [x.engine(kv_host_mb=1) for _ in range(2)]
    auto = x.AutoscaleController(min_replicas=1, initial_replicas=2,
                                 up_queue_depth=2, ladder_patience_ticks=2,
                                 cooldown_ticks=1, down_idle_ticks=3,
                                 brownout_margin_s=0.5)
    ctrl = x.FailoverController(respawn=False)
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             failover=ctrl, autoscale=auto)
    stores = [e.pool.blocks.host for e in engines]
    orig = [s.capacity_bytes for s in stores]
    for i, (p, b) in enumerate(workload(n=4, seed=1)):
        router.submit(x.Request(i, p, b))
    for t in range(1, 6):
        auto.evaluate(t, clock())
    up = ([s.capacity_bytes for s in stores],
          [s.brownout_margin for s in router.replicas])
    for s in router.replicas:
        s.queue.clear()
        s._tenant_counts.clear()
    for t in range(6, 13):
        auto.evaluate(t, clock())
    return {"history": auto.history, "stats": auto.stats(), "up": up,
            "restored": [s.capacity_bytes for s in stores] == orig,
            "orig_positive": all(c > 0 for c in orig),
            "health": [h.state for h in ctrl.health]}


def s_endpoint(x, tmp):
    clock = x.VirtualClock()
    agg = x.obs.LiveAggregator(clock=clock)
    auto = x.AutoscaleController(min_replicas=1)
    x.ReplicaRouter([x.engine() for _ in range(2)], max_queue=64,
                    clock=clock, failover=x.FailoverController(
                        respawn=False), autoscale=auto)
    srv = x.obs.OpsServer(agg, None, controller=auto)
    status, ctype, body = srv._respond("/slo")
    payload = json.loads(body)
    return {"status": status, "ctype": ctype,
            "controller": payload["controller"],
            "snapshot": json.loads(json.dumps(auto.snapshot()))}


SCENARIOS = {
    "deficit": s_deficit, "blocked": s_blocked, "boost": s_boost,
    "real_scheduler": s_real_scheduler, "scale": s_scale,
    "chaos_spare": s_chaos_spare, "park": s_park,
    "validation": s_validation, "resplit": s_resplit, "ladder": s_ladder,
    "endpoint": s_endpoint,
}
PARTS = {
    "a": ("deficit", "blocked", "boost", "real_scheduler", "park",
          "validation", "endpoint"),
    "b": ("scale",),
    "c": ("chaos_spare", "resplit", "ladder"),
}


def _jax_part(names, tmp_path_factory) -> dict:
    side = Side("jax")
    return {n: SCENARIOS[n](side, tmp_path_factory.mktemp(f"jax_{n}"))
            for n in names}


@pytest.fixture(scope="module")
def jax_side(request, tmp_path_factory):
    parts = shared_parts(request, tmp_path_factory, "torch_fleet_autoscale",
                         {p: (lambda names=names: _jax_part(
                             names, tmp_path_factory))
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


# --------------------------------------------------------------------- #
# grammar
# --------------------------------------------------------------------- #


def test_parse_slo_per_class_bracket_grammar():
    from pytorch_distributed_training_tpu.obs.slo import (
        parse_slo_spec as jax_parse,
    )
    from pytorch_distributed_training_tpu_torch.obs import labeled
    from pytorch_distributed_training_tpu_torch.obs.slo import (
        parse_slo_spec,
    )

    spec = "ttft_p99[interactive]=250ms, ttft_p95=100ms"
    per_cls, plain = parse_slo_spec(spec)
    assert per_cls.cls == "interactive"
    assert per_cls.metric == labeled("ttft_s", tenant="interactive")
    assert per_cls.threshold == pytest.approx(0.25) and per_cls.q == 99.0
    assert plain.cls is None and plain.metric == "ttft_s"
    assert [(o.name, o.metric, o.cls, o.q, o.threshold)
            for o in (per_cls, plain)] == [
        (o.name, o.metric, o.cls, o.q, o.threshold) for o in jax_parse(spec)]


@pytest.mark.parametrize("bad", [
    "ttft_p99[]=250ms", "ttft_p99[a b]=250ms", "ttft_p99[interactive]=0ms",
    "ttft_p99[x=250ms",
])
def test_parse_slo_rejects_bad_class_clauses(bad):
    from pytorch_distributed_training_tpu.obs.slo import (
        parse_slo_spec as jax_parse,
    )
    from pytorch_distributed_training_tpu_torch.obs.slo import (
        parse_slo_spec,
    )

    with pytest.raises(ValueError) as jax_err:
        jax_parse(bad)
    with pytest.raises(ValueError) as err:
        parse_slo_spec(bad)
    assert str(err.value) == str(jax_err.value)


def test_parse_priority_spec_grammar():
    from pytorch_distributed_training_tpu_torch.serve import (
        parse_priority_spec,
    )

    assert parse_priority_spec("interactive=4, batch=1") == {
        "interactive": 4.0, "batch": 1.0}
    assert parse_priority_spec("a=0.5") == {"a": 0.5}


@pytest.mark.parametrize("bad", [
    "interactive", "=3", "a=zero", "a=0", "a=-1", "a=1,a=2", "", " , ",
])
def test_parse_priority_spec_rejects(bad):
    from pytorch_distributed_training_tpu.serve import (
        parse_priority_spec as jax_parse,
    )
    from pytorch_distributed_training_tpu_torch.serve import (
        parse_priority_spec,
    )

    with pytest.raises(ValueError) as jax_err:
        jax_parse(bad)
    with pytest.raises(ValueError) as err:
        parse_priority_spec(bad)
    assert str(err.value) == str(jax_err.value)


# --------------------------------------------------------------------- #
# weighted-deficit admission
# --------------------------------------------------------------------- #


def test_weighted_deficit_share_and_no_starvation(port, jax_side, tmp_path):
    got = _run(port, jax_side, "deficit", tmp_path)
    seq = got["seq"]
    assert abs(seq.count("heavy") / len(seq) - 0.8) < 0.05
    gaps, last = [], -1
    for i, t in enumerate(seq):
        if t == "light":
            gaps.append(i - last)
            last = i
    assert gaps and max(gaps) <= 5
    assert got["boosted"] == 0


def test_blocked_head_of_line_keeps_its_turn(port, jax_side, tmp_path):
    got = _run(port, jax_side, "blocked", tmp_path)
    assert got["same"] and got["credits"] == got["after"]


def test_slo_boost_biases_burning_class(port, jax_side, tmp_path):
    got = _run(port, jax_side, "boost", tmp_path)
    assert got["weights"] == [1.0, 3.0, 1.0]
    seq = got["seq"]
    assert abs(seq.count("interactive") / len(seq) - 0.75) < 0.1
    assert got["boosted"] == seq.count("interactive")
    assert got["snapshot"]["classes"]["interactive"]["burning"] is True


def test_real_scheduler_weighted_admission_token_exact(port, jax_side,
                                                       tmp_path):
    got = _run(port, jax_side, "real_scheduler", tmp_path)
    assert got["order"][0] == "interactive"
    assert got["admitted"] == {"interactive": 3, "batch": 3}


# --------------------------------------------------------------------- #
# replica autoscaling
# --------------------------------------------------------------------- #


def test_scale_up_and_down_pinned_ticks_token_exact(port, jax_side,
                                                    tmp_path):
    """Scale-up at JAX's tick (queue-depth cause, the backlog rebalanced
    onto the revived replica), scale-down at JAX's tick, tokens exact, no
    retry charged, counters equal the telemetry, and a second fleet
    replays the actions."""
    got = _run(port, jax_side, "scale", tmp_path)
    a, b = got["a"], got["b"]
    assert a["history"] == b["history"] and a["tokens"] == b["tokens"]
    acts = [(h["tick"], h["action"], h["cause"]["signal"])
            for h in a["history"]]
    assert [(x[1], x[2]) for x in acts] == [("scale_up", "queue_depth"),
                                            ("scale_down", "idle")]
    assert all(not r["retries"] for r in a["records"].values())
    assert any(r["replica"] == 1 for r in a["records"].values())
    st = a["auto"]
    assert st["replicas_active"] == 1 and st["replicas_parked"] == 1
    assert a["counters"] == {"autoscale_actions": 2,
                             "autoscale_scale_ups": 1,
                             "autoscale_scale_downs": 1}
    assert a["gauges"]["autoscale_replicas_active"] == 1
    assert a["pending_gauge"]


def test_chaos_crash_with_parked_spare_scales_up(port, jax_side, tmp_path):
    got = _run(port, jax_side, "chaos_spare", tmp_path)
    assert got["stats"]["replica_deaths"] == 1
    assert any(a["action"] == "scale_up" and a["replica"] == 2
               for a in got["history"])
    assert any(r["replica"] == 2 for r in got["records"].values())


def test_retire_revive_park_contract(port, jax_side, tmp_path):
    got = _run(port, jax_side, "park", tmp_path)
    assert got[:4] == [("parked", True), "parked", ("up", False), "up"]
    assert "retire" in got[4]


def test_autoscale_ctor_and_bind_validation(port, jax_side, tmp_path):
    got = _run(port, jax_side, "validation", tmp_path)
    assert "requires a FailoverController" in got[-2]
    assert "exceeds the built fleet" in got[-1]


# --------------------------------------------------------------------- #
# role re-splitting, the pressure ladder, /slo
# --------------------------------------------------------------------- #


def test_resplit_walks_bias_both_ways_token_exact(port, jax_side, tmp_path):
    got = _run(port, jax_side, "resplit", tmp_path)
    assert got["splits"] == [[[2, 2]] * 2, [[2, 1]] * 2, [[2, 2]] * 2,
                             [[1, 2]] * 2, [[1, 2]] * 2]
    assert [(h["action"], h["direction"]) for h in got["history"]] == [
        ("resplit", "grow_prefill"), ("resplit", "grow_decode"),
        ("resplit", "grow_decode")]
    assert got["auto"]["resplits"] == 3


def test_pressure_ladder_escalates_and_recovers_in_order(port, jax_side,
                                                         tmp_path):
    got = _run(port, jax_side, "ladder", tmp_path)
    assert got["orig_positive"] and got["restored"]
    assert [(h["tick"], h["action"]) for h in got["history"]] == [
        (2, "escalate"), (4, "escalate"), (7, "deescalate"),
        (9, "deescalate"), (12, "scale_down")]
    caps, margins = got["up"]
    assert caps == [0, 0] and all(m >= 0.5 for m in margins)
    assert got["health"] == ["up", "parked"]
    assert got["stats"]["ladder_moves"] == 4


def test_slo_endpoint_serves_controller_block(port, jax_side, tmp_path):
    got = _run(port, jax_side, "endpoint", tmp_path)
    assert got["status"] == 200 and got["controller"] == got["snapshot"]
    assert got["controller"]["replicas"] == {"active": 1, "parked": 1,
                                             "min": 1, "max": 2}
