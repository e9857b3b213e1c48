"""The port's replica router and the scheduler's QoS and reset contracts
against the JAX package's on converted weights.

The cases of JAX's ``tests/test_serve_router.py``: affinity routes a
shared prefix to the replica holding its blocks even when it is busier,
a saturated (or full) affinity target falls back to the least-loaded
replica as a rebalance, least-loaded ties break by the lowest index,
backpressure counts refusals, every replica's drafter shares one n-gram
index, the routing counters equal the emitted telemetry (and JAX's
``tools/telemetry_report.py`` reduces them alike), the request log
carries replica and tenant, tenants admit round-robin and FIFO within
one, and ``reset`` makes a reused engine's leg equal a fresh engine's
with the shared index cleared in place.  One scripted trace runs through
JAX's router and the port's: the same routing decisions, counters and
greedy tokens, also when one replica's step is posted and collected as
a group led by another process has it.
"""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models import gpt2_124m as jax_gpt2
from pytorch_distributed_training_tpu.serve import (
    ReplicaRouter as JaxRouter, Request as JaxRequest,
    ServingEngine as JaxEngine, VirtualClock as JaxClock,
)
from pytorch_distributed_training_tpu_torch.models import (
    GPT2, GPT2Config, gpt2_params_from_jax,
)
from pytorch_distributed_training_tpu_torch.obs import MetricsEmitter
from pytorch_distributed_training_tpu_torch.serve import (
    ContinuousScheduler, ReplicaRouter, Request, ServingEngine,
    VirtualClock, summarize_records,
)
from pytorch_distributed_training_tpu_torch.utils.metrics import (
    RequestLogger,
)
from tests.torch_shared import shared

SMALL = dict(num_layers=2, hidden_dim=32, num_heads=2, vocab_size=61,
             max_seq_len=48)
ENGINE = dict(num_slots=2, max_len=48, prefill_chunk=4, temperature=0.0,
              paged=True, block_size=4, num_blocks=24)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_pair():
    m = jax_gpt2(cfg_overrides=SMALL)
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32),
                    train=False)["params"]
    return m, params


def _converted() -> dict:
    """JAX's tiny GPT-2 weights under the port's names (numpy)."""
    _, params = _jax_pair()
    return {k: v.numpy() for k, v in gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}


@pytest.fixture(scope="module")
def tm(request, tmp_path_factory):
    """The port's tiny GPT-2 on JAX's weights (converted once a run)."""
    named = shared(request, tmp_path_factory, "torch_serve_tiny_params",
                   _converted)
    model = GPT2(GPT2Config(**SMALL))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in named.items()})
    return model.eval()


def _mk(tm, **kw):
    return ServingEngine(tm, device="cpu", **{**ENGINE, **kw})


def _shared_prompt(tail_seed=0, tail_len=3):
    shared_ = (np.arange(8, dtype=np.int32) * 5) % 61  # 2 full blocks
    rng = np.random.default_rng(tail_seed)
    return np.concatenate(
        [shared_, rng.integers(0, 61, (tail_len,)).astype(np.int32)])


def _warm_prefix(router, clock, rid=0):
    """Serve one shared-prefix request to completion; returns the replica
    that took it."""
    router.submit(Request(rid, _shared_prompt(99), 2, arrival_time=0.0))
    while not router.idle:
        router.tick()
        clock.advance(0.01)
    return int(np.argmax(router.stats()["routed"]))


def _trace(request_cls):
    return [request_cls(0, _shared_prompt(99), 2, arrival_time=0.0)] + [
        request_cls(i, _shared_prompt(i), 3, arrival_time=1.0 + 0.2 * i)
        for i in range(1, 5)
    ] + [request_cls(9, np.asarray([2, 4, 6, 8], np.int32), 3,
                     arrival_time=1.5)]


def _routed_trace(engines, router_cls, request_cls, clock):
    """The scripted trace through a router of ``engines`` (host tiers,
    affinity cap 1: the hot replica saturates): tokens, router stats."""
    tokens: dict = {}
    for e in engines:
        e.stream_cb = lambda rid, tok: tokens.setdefault(rid, []).append(tok)
    router = router_cls(engines, clock=clock, affinity_queue_cap=1)
    router.run(_trace(request_cls), sleep=clock.advance)
    return tokens, router.stats()


def _jax_routed() -> tuple:
    m, params = _jax_pair()
    engines = [JaxEngine(m, params, kv_host_mb=2.0, **ENGINE)
               for _ in range(2)]
    return _routed_trace(engines, JaxRouter, JaxRequest, JaxClock())


@pytest.fixture(scope="module")
def jax_routed(request, tmp_path_factory):
    return shared(request, tmp_path_factory, "torch_serve_router_jax",
                  _jax_routed)


def test_routed_trace_equal_jax(tm, jax_routed):
    """The same decisions (routed per replica, affinity hits,
    rebalances, sibling fetches and their blocks) and the same greedy
    tokens as JAX's router on one scripted trace."""
    engines = [_mk(tm, kv_host_mb=2.0) for _ in range(2)]
    tokens, st = _routed_trace(engines, ReplicaRouter, Request,
                               VirtualClock())
    ref_tokens, ref = jax_routed
    assert tokens == ref_tokens
    for key in ("routed", "affinity_hits", "rebalanced", "rejected",
                "sibling_fetches", "sibling_fetch_blocks"):
        assert st[key] == ref[key], (key, st, ref)
    assert st["affinity_hits"] > 0
    for e in engines:
        e.pool.check_invariants()


class _Logged:
    """An engine whose steps go into ``log``: ``"step <k>"`` when stepped
    in place, ``"post <k>"`` / ``"collect <k>"`` when ``posted`` (the
    router then posts its step and collects the events later, as it does
    ``serve/tp.py``'s ``RemoteReplica``'s)."""

    def __init__(self, engine, k, log, posted=False, fail=False):
        object.__setattr__(self, "_engine", engine)
        object.__setattr__(self, "_k", k)
        object.__setattr__(self, "_log", log)
        object.__setattr__(self, "_fail", fail)
        if posted:
            object.__setattr__(self, "post_step", self._post_step)

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __setattr__(self, name, value):
        setattr(self._engine, name, value)

    def step(self):
        self._log.append(f"step {self._k}")
        if self._fail:
            raise RuntimeError("step failed")
        return self._engine.step()

    def _post_step(self):
        self._log.append(f"post {self._k}")

        def finish():
            self._log.append(f"collect {self._k}")
            return self._engine.step()

        return finish


def test_posted_steps_overlap_and_keep_the_trace(tm, jax_routed):
    """A replica whose engine has ``post_step`` (a group led by another
    process) is posted before the replicas of this process step and
    collected after, every tick both tick; the trace's tokens and
    routing stay JAX's.  When a local step raises, the posted step's
    reply is still collected before the error leaves the tick."""
    log: list = []
    engines = [_Logged(_mk(tm, kv_host_mb=2.0), 0, log),
               _Logged(_mk(tm, kv_host_mb=2.0), 1, log, posted=True)]
    tokens, st = _routed_trace(engines, ReplicaRouter, Request,
                               VirtualClock())
    ref_tokens, ref = jax_routed
    assert tokens == ref_tokens
    for key in ("routed", "affinity_hits", "rebalanced",
                "sibling_fetches", "sibling_fetch_blocks"):
        assert st[key] == ref[key], (key, st, ref)
    both = [log[i:i + 3] for i in range(len(log) - 2)
            if log[i] == "post 1" and "step 0" in log[i:i + 3]]
    assert both and all(t == ["post 1", "step 0", "collect 1"]
                        for t in both)
    assert log.count("post 1") == log.count("collect 1") > 0

    log.clear()
    engines = [_Logged(_mk(tm), 0, log, fail=True),
               _Logged(_mk(tm), 1, log, posted=True)]
    router = ReplicaRouter(engines, clock=VirtualClock())
    with pytest.raises(RuntimeError, match="step failed"):
        router.tick()
    assert log == ["post 1", "step 0", "collect 1"]


# --------------------------------------------------------------------- #
# routing policy
# --------------------------------------------------------------------- #


def test_affinity_routes_to_hot_replica(tm):
    clock = VirtualClock()
    router = ReplicaRouter([_mk(tm) for _ in range(3)], clock=clock)
    hot = _warm_prefix(router, clock)
    router.replicas[hot].submit(
        Request("busy", np.asarray([1, 2, 3], np.int32), 2))
    before = router.affinity_hits
    assert router.route(Request(1, _shared_prompt(1), 2)) == hot
    assert router.affinity_hits == before + 1
    assert router.route(
        Request(2, np.asarray([7, 9, 11, 13], np.int32), 2)) != hot


def test_affinity_saturated_falls_back_least_loaded(tm):
    clock = VirtualClock()
    router = ReplicaRouter([_mk(tm) for _ in range(2)], clock=clock,
                           affinity_queue_cap=1)
    hot = _warm_prefix(router, clock)
    router.replicas[hot].submit(
        Request("q1", np.asarray([1, 2, 3], np.int32), 2))
    before = router.rebalanced
    assert router.route(Request(1, _shared_prompt(1), 2)) == 1 - hot
    assert router.rebalanced == before + 1


def test_affinity_never_routes_into_full_queue(tm):
    clock = VirtualClock()
    router = ReplicaRouter([_mk(tm) for _ in range(2)], clock=clock,
                           max_queue=1, affinity_queue_cap=10)
    hot = _warm_prefix(router, clock)
    router.replicas[hot].submit(
        Request("fill", np.asarray([1, 2], np.int32), 2))
    assert router.route(Request(1, _shared_prompt(1), 2)) == 1 - hot
    assert router.rebalanced == 1
    assert router.rejected == 0


def test_least_loaded_tie_break_deterministic(tm):
    router = ReplicaRouter([_mk(tm) for _ in range(3)],
                           clock=VirtualClock())
    cold = Request(0, np.asarray([1, 2, 3], np.int32), 2)
    assert router.route(cold) == 0
    assert router.route(cold) == 0
    router.replicas[0].submit(Request("a", np.asarray([4, 5], np.int32), 2))
    assert router.route(cold) == 1
    router.replicas[1].submit(Request("b", np.asarray([4, 5], np.int32), 2))
    assert router.route(cold) == 2


def test_router_backpressure_counts_rejects(tm):
    router = ReplicaRouter([_mk(tm)], clock=VirtualClock(), max_queue=1)
    assert router.submit(Request(0, np.asarray([1, 2], np.int32), 2))
    assert not router.submit(Request(1, np.asarray([3, 4], np.int32), 2))
    assert router.rejected == 1
    assert router.stats()["routed"] == [1]


def test_router_shares_one_ngram_index(tm):
    engines = [_mk(tm, spec_k=3, paged=False) for _ in range(3)]
    router = ReplicaRouter(engines, clock=VirtualClock())
    assert router.shared_index is not None
    for e in engines:
        assert e.drafter.index is router.shared_index
    engines[1].reset()
    for e in engines:
        assert e.drafter.index is router.shared_index


def test_router_refuses_item_12_controllers(tm):
    """The controllers bind (the policy reaches every scheduler, the
    failover controller sizes the tick logs); what JAX's router refuses
    is refused: autoscale without failover, a fault naming a replica the
    tier lacks."""
    from pytorch_distributed_training_tpu_torch.resilience import (
        ServeFaultInjector,
    )
    from pytorch_distributed_training_tpu_torch.serve import (
        AutoscaleController, FailoverController, ServePolicy,
    )

    policy, failover = ServePolicy({"a": 2.0}), FailoverController()
    auto = AutoscaleController(min_replicas=1)
    router = ReplicaRouter([_mk(tm) for _ in range(2)], policy=policy,
                           failover=failover, autoscale=auto,
                           chaos=ServeFaultInjector.from_spec(
                               "replica_crash@3:1"))
    assert all(s.policy is policy for s in router.replicas)
    assert failover.router is router and auto.router is router
    assert [h.state for h in failover.health] == ["up", "parked"]
    with pytest.raises(ValueError, match="requires a FailoverController"):
        ReplicaRouter([_mk(tm)], autoscale=AutoscaleController())
    with pytest.raises(ValueError, match="out of range"):
        ReplicaRouter([_mk(tm)], chaos=ServeFaultInjector.from_spec(
            "replica_crash@3:5"))


# --------------------------------------------------------------------- #
# counters == telemetry, replica attribution
# --------------------------------------------------------------------- #


def test_router_counters_match_emitted_telemetry(tm, tmp_path):
    from tools.telemetry_report import build_report

    clock = VirtualClock()
    emitter = MetricsEmitter(str(tmp_path), rank=0)
    router = ReplicaRouter([_mk(tm) for _ in range(2)], clock=clock,
                           emitter=emitter)
    recs = router.run(_trace(Request), sleep=clock.advance)
    rt = router.stats()
    summary = emitter.summary()
    emitter.close()
    counters = summary["counters"]
    assert counters["router_routed_requests"] == sum(rt["routed"])
    assert counters.get("router_affinity_hits", 0) == rt["affinity_hits"]
    assert counters.get("router_rebalanced", 0) == rt["rebalanced"]
    for k in range(2):
        assert counters.get(f"router_routed_r{k}", 0) == rt["routed"][k]
    assert rt["affinity_hits"] > 0
    assert all(r.get("replica") in (0, 1) for r in recs)
    out = summarize_records(recs, elapsed=clock())
    assert set(out["replicas"]) <= {"0", "1"}
    assert sum(v["completed"] for v in out["replicas"].values()) \
        == out["completed"] == 6
    (path,) = glob.glob(str(tmp_path / "events.rank*.jsonl"))
    gauges = summary["gauges"]
    assert "router_queue_depth_r0" in gauges
    assert "router_slots_active_r1" in gauges
    assert "summary" in [json.loads(line)["kind"] for line in open(path)]
    rep = build_report(str(tmp_path))["serving"]["router"]
    assert rep["routed_requests"] == sum(rt["routed"])
    assert rep["affinity_hits"] == rt["affinity_hits"]
    assert rep["routed_per_replica"]
    assert all(k.isdigit() for k in rep["routed_per_replica"])
    for k, v in rep["routed_per_replica"].items():
        assert v == rt["routed"][int(k)]


def test_request_logger_records_replica_and_tenant(tm, tmp_path):
    clock = VirtualClock()
    logger = RequestLogger(str(tmp_path / "req.jsonl"))
    router = ReplicaRouter([_mk(tm) for _ in range(2)], clock=clock,
                           request_logger=logger)
    router.run([Request(i, np.asarray([3 + i, 7, 11], np.int32), 2,
                        tenant=("a" if i % 2 else "b")) for i in range(4)],
               sleep=clock.advance)
    rows = logger.read()
    assert len(rows) == 4
    assert all(r["replica"] in (0, 1) for r in rows)
    assert {r["tenant"] for r in rows} == {"a", "b"}


# --------------------------------------------------------------------- #
# per-tenant fair admission
# --------------------------------------------------------------------- #


def _one_slot(tm):
    return ServingEngine(tm, device="cpu", num_slots=1, max_len=48,
                         prefill_chunk=8, temperature=0.0)


def _admitted_order(tm, reqs):
    clock = VirtualClock()
    sched = ContinuousScheduler(_one_slot(tm), clock=clock)
    for r in reqs:
        assert sched.submit(r)
    while not sched.idle:
        sched.tick()
        clock.advance(0.01)
    return [r["id"] for r in sorted(sched.completed,
                                    key=lambda r: r["admitted"])]


def test_tenant_round_robin_admission(tm):
    order = _admitted_order(tm, [
        Request(rid, np.asarray([2, 3, 4], np.int32), 2, tenant=tenant)
        for rid, tenant in (("a1", "A"), ("a2", "A"), ("a3", "A"),
                            ("b1", "B"))])
    assert order == ["a1", "b1", "a2", "a3"]


def test_single_tenant_stays_fifo(tm):
    order = _admitted_order(tm, [
        Request(i, np.asarray([5, 6, 7], np.int32), 2) for i in range(4)])
    assert order == [0, 1, 2, 3]


def test_default_tenant_not_skipped_on_first_rotation(tm):
    order = _admitted_order(tm, [
        Request("none1", np.asarray([2, 3], np.int32), 2),
        Request("a1", np.asarray([4, 5], np.int32), 2, tenant="a")])
    assert order == ["none1", "a1"]


def test_tenant_fifo_within_tenant(tm):
    order = _admitted_order(tm, [
        Request(rid, np.asarray([9, 8], np.int32), 2, tenant=tenant)
        for rid, tenant in (("a1", "A"), ("b1", "B"), ("a2", "A"),
                            ("b2", "B"), ("a3", "A"))])
    assert order.index("a1") < order.index("a2") < order.index("a3")
    assert order.index("b1") < order.index("b2")
    assert order[:2] in (["a1", "b1"], ["b1", "a1"])


# --------------------------------------------------------------------- #
# reset order-independence
# --------------------------------------------------------------------- #


def _leg(eng, prompts, budgets):
    out = {i: [] for i in range(len(prompts))}
    eng.stream_cb = lambda rid, tok: out[rid].append(tok)
    try:
        pend = list(range(len(prompts)))
        while pend or eng.busy:
            while pend and eng.has_free_slot and eng.can_admit(
                    prompts[pend[0]], budgets[pend[0]]):
                i = pend.pop(0)
                eng.start(i, prompts[i], budgets[i])
            eng.step()
    finally:
        eng.stream_cb = None
    return out, dict(eng.stats())


def test_reset_makes_legs_order_independent(tm):
    """Leg B on a reused engine (after leg A and a reset) equals leg B on
    a fresh engine, tokens and counters; leg A feeds the shared index,
    arms the drafting backoff and advances the sampling generator."""
    rng = np.random.default_rng(5)
    pat = rng.integers(0, 61, (3,)).astype(np.int32)
    leg_a = ([np.tile(pat, 6)[:14].astype(np.int32),
              rng.integers(0, 61, (8,)).astype(np.int32)], [10, 8])
    leg_b = ([rng.integers(0, 61, (6,)).astype(np.int32),
              np.tile(pat[::-1], 4)[:9].astype(np.int32)], [7, 9])
    kw = dict(device="cpu", num_slots=2, max_len=48, prefill_chunk=4,
              temperature=0.7, seed=11, spec_k=3)
    reused = ServingEngine(tm, **kw)
    _leg(reused, *leg_a)
    reused.reset()
    tokens_reused, stats_reused = _leg(reused, *leg_b)
    tokens_fresh, stats_fresh = _leg(ServingEngine(tm, **kw), *leg_b)
    assert tokens_reused == tokens_fresh
    assert stats_reused == stats_fresh


def test_reset_clears_shared_index_in_place(tm):
    eng = ServingEngine(tm, device="cpu", num_slots=2, max_len=48,
                        prefill_chunk=4, temperature=0.0, spec_k=3)
    idx = eng.drafter.index
    eng.start("r", np.asarray([1, 2, 3, 4, 5, 6], np.int32), 2)
    assert len(idx) > 0
    while eng.busy:
        eng.step()
    eng.reset()
    assert eng.drafter.index is idx
    assert len(idx) == 0


# --------------------------------------------------------------------- #
# the CLI's serving-tier flags, on the host
# --------------------------------------------------------------------- #

CLI = ["--serve", "--use-cpu", "--model", "gpt2", "--model-overrides",
       "num_layers=2,hidden_dim=64,num_heads=2,vocab_size=256,max_seq_len=64",
       "--seq-len", "32", "--serve-requests", "6", "--serve-slots", "2",
       "--serve-max-new", "8"]


@pytest.mark.parametrize("extra,expect", [
    (["--serve-disagg", "1:3"], "disagg: 6 prefill->decode handoff(s)"),
    (["--serve-paged", "--serve-disagg", "1:3", "--serve-kv-host-mb", "1",
      "--serve-spec"], "1+3 prefill+decode slots (paged (16 blocks x 16)"),
    (["--serve-paged", "--serve-replicas", "2", "--serve-kv-host-mb", "1"],
     "tp=1 x 2 replica(s), affinity"),
    (["--serve-paged", "--serve-replicas", "2", "--no-serve-affinity"],
     "router: routed=[3, 3] affinity_hit_rate=0.000"),
], ids=["disagg-contig", "disagg-paged-host-spec", "replicas", "no-affinity"])
def test_cli_serving_tier(extra, expect, capsys):
    from pytorch_distributed_training_tpu_torch.cli.main import main

    res = main(CLI + extra)
    out = capsys.readouterr().out
    assert expect in out, out
    assert res["summary"]["completed"] == 6
    if "--serve-disagg" in extra:
        assert res["engine"]["handoffs"] == 6
    if "--serve-replicas" in extra:
        assert sum(res["router"]["routed"]) == 6
        assert set(res["summary"]["replicas"]) == {"0", "1"}


def test_cli_serve_ttl_and_refusals(capsys):
    """A TTL far below one tick sheds or cancels requests (none of them
    in goodput); the tier flags' refusals exit as JAX's do."""
    from pytorch_distributed_training_tpu_torch.cli.main import main

    s = main(CLI + ["--serve-ttl", "1e-6"])["summary"]
    assert s["shed"] + s["cancelled"] > 0
    assert s["shed"] + s["cancelled"] + s["completed"] == 6
    for extra, match in ((["--serve-disagg", "0:2"], "P:D"),
                         (["--serve-disagg", "1:x"], "P:D"),
                         (["--serve-replicas", "0"], "must be >= 1")):
        with pytest.raises(SystemExit, match=match):
            main(CLI + extra)


@pytest.mark.parametrize("flag", ["--serve-affinity", "--no-serve-affinity"])
def test_cli_affinity_flag_survives_the_supervisor(flag):
    """``--elastic`` relaunches the command from the parsed options: the
    affinity switch goes back as its own flag and parses to the same
    value."""
    from pytorch_distributed_training_tpu_torch.cli.main import (
        _child_argv, build_parser,
    )

    parser = build_parser()
    args = parser.parse_args(CLI + [flag])
    child = _child_argv(parser, args)
    assert flag in child
    assert parser.parse_args(child).serve_affinity == args.serve_affinity
