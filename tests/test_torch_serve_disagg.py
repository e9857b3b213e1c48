"""The port's disaggregated prefill/decode tier and tiered KV store
against the JAX package's on converted weights.

The cases of JAX's ``tests/test_serve_disagg.py``: the tier's greedy
tokens (contiguous, paged, speculative) equal JAX's interleaved engine's
and the port's own, with a handoff for every request and each role
running its half alone; a request cancelled while its export is parked
releases its blocks; an evicted prefix spills to the host tier and
restores bit for bit (its cold tokens JAX's); the host ledger equals
the per-block byte model (the port's and JAX's); the host store's LRU
units; the eviction cascade and the refused orphan; the tier's counters
equal its emitted telemetry and JAX's ``tools/telemetry_report.py``
reads them; the sibling fetch between pools, through a parent the
fetch's own put evicts, and through the router with affinity off and
on a rebalance.  The views over a shared pool refuse a mismatched block
size, storage dtype or host tier as JAX's do.
"""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models import gpt2_124m as jax_gpt2
from pytorch_distributed_training_tpu.obs.cost import (
    kv_block_model_bytes as jax_kv_block_model_bytes,
)
from pytorch_distributed_training_tpu.serve import ServingEngine as JaxEngine
from pytorch_distributed_training_tpu_torch.models import (
    GPT2, GPT2Config, gpt2_params_from_jax,
)
from pytorch_distributed_training_tpu_torch.obs import MetricsEmitter
from pytorch_distributed_training_tpu_torch.obs.cost import (
    kv_block_model_bytes,
)
from pytorch_distributed_training_tpu_torch.serve import (
    BlockPool, ContinuousScheduler, DisaggServingEngine, HostKVStore,
    PagedKVCachePool, ReplicaRouter, Request, ServingEngine, VirtualClock,
    hash_prompt_blocks, sibling_fetch,
)
from tests.torch_shared import shared

SMALL = dict(num_layers=2, hidden_dim=32, num_heads=2, vocab_size=61,
             max_seq_len=48)
KW = dict(max_len=48, prefill_chunk=4, temperature=0.0, block_size=4,
          device="cpu")
SYSP = (np.arange(1, 13) % 61).astype(np.int32)     # 3 full blocks of 4
BIG = (np.arange(20, 59) % 61).astype(np.int32)     # spans 12 with 9 new


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace():
    """JAX's ``_trace``: a ragged mix with one multi-chunk prompt."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 61, (n,)).astype(np.int32)
               for n in [4, 14, 6, 9, 5]]
    return prompts, [6, 5, 8, 4, 7]


def _drive(engine, prompts, budgets):
    """FIFO-admit and run a trace to completion; request id -> tokens."""
    streams: dict = {}
    engine.stream_cb = lambda rid, tok: streams.setdefault(rid, []).append(
        tok)
    queue = list(zip(range(len(prompts)), prompts, budgets))
    while queue or engine.busy:
        while queue and engine.can_admit(queue[0][1], queue[0][2]):
            rid, p, b = queue.pop(0)
            engine.start(rid, p, b)
        engine.step()
    engine.stream_cb = None
    return streams


def _one(engine, rid, prompt, budget):
    out = []
    engine.stream_cb = lambda r, tok: out.append(tok)
    engine.start(rid, prompt, budget)
    while engine.busy:
        engine.step()
    engine.stream_cb = None
    return out


def _jax_pair():
    m = jax_gpt2(cfg_overrides=SMALL)
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32),
                    train=False)["params"]
    return m, params


def _jax_references() -> dict:
    """JAX's interleaved engine on the trace (contiguous, paged), and
    the cold run of the spill/restore test."""
    m, params = _jax_pair()
    prompts, budgets = _trace()
    out = {}
    for paged in (True, False):
        eng = JaxEngine(m, params, num_slots=3, paged=paged,
                        **{k: v for k, v in KW.items() if k != "device"})
        out[paged] = _drive(eng, prompts, budgets)
    eng = JaxEngine(m, params, num_slots=2, paged=True, num_blocks=12,
                    kv_host_mb=4.0,
                    **{k: v for k, v in KW.items() if k != "device"})
    out["cold"] = _one(eng, 0, SYSP, 4)
    return out


@pytest.fixture(scope="module")
def jax_ref(request, tmp_path_factory):
    return shared(request, tmp_path_factory, "torch_serve_disagg_jax",
                  _jax_references)


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


def _paged(tm, **kw):
    return ServingEngine(tm, paged=True, **{**KW, **kw})


# --------------------------------------------------------------------- #
# 1. the handoff contract
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contig"])
def test_disagg_token_exact_vs_interleaved(tm, jax_ref, paged):
    prompts, budgets = _trace()
    ref = _drive(ServingEngine(tm, num_slots=3, paged=paged, **KW),
                 prompts, budgets)
    tier = DisaggServingEngine(tm, prefill_slots=1, decode_slots=3,
                               paged=paged, **KW)
    got = _drive(tier, prompts, budgets)
    assert got == ref == jax_ref[paged]
    assert tier.stats()["handoffs"] == len(prompts)
    tier.check_invariants()
    # The role split is structural: each role ran its own half alone.
    assert tier.decode_engine.prefill_ticks == 0
    assert tier.prefill_engine.decode_ticks == 0
    assert tier.prefill_engine.prefill_ticks > 0


def test_disagg_token_exact_speculative(tm, jax_ref):
    """The decode role owns speculation: the speculative tier's tokens
    equal the interleaved engine's (greedy speculation is exact)."""
    prompts, budgets = _trace()
    tier = DisaggServingEngine(tm, prefill_slots=1, decode_slots=3,
                               paged=True, spec_k=3, spec_ngram=3, **KW)
    got = _drive(tier, prompts, budgets)
    assert got == jax_ref[True]
    assert tier.decode_engine.spec_drafted_tokens > 0
    assert tier.prefill_engine.drafter is None
    tier.check_invariants()


def test_role_gating(tm):
    """Bad roles, a decode role's raw prompt, and views over a shared
    pool that disagree with it are refused, as JAX refuses them."""
    with pytest.raises(ValueError, match="role"):
        ServingEngine(tm, num_slots=1, role="verifier", **KW)
    tier = DisaggServingEngine(tm, prefill_slots=1, decode_slots=1,
                               paged=True, **KW)
    with pytest.raises(RuntimeError, match="adopt"):
        tier.decode_engine.start(0, np.arange(4, dtype=np.int32), 2)
    with pytest.raises(ValueError, match="paged=True"):
        ServingEngine(tm, num_slots=1, block_pool=tier.blocks, **KW)
    with pytest.raises(ValueError, match="host tier belongs to the pool"):
        ServingEngine(tm, num_slots=1, paged=True, block_pool=tier.blocks,
                      kv_host_mb=1.0, **KW)
    with pytest.raises(ValueError, match="disagrees with the shared"):
        ServingEngine(tm, num_slots=1, paged=True, block_pool=tier.blocks,
                      kv_dtype="int8", **KW)
    with pytest.raises(ValueError, match="num_blocks 3 != shared"):
        PagedKVCachePool(tm, num_slots=1, num_blocks=3,
                         blocks=tier.blocks)
    with pytest.raises(ValueError, match="belongs to the shared"):
        PagedKVCachePool(tm, num_slots=1, blocks=tier.blocks,
                         host_store=HostKVStore(1024))
    # The role methods gate their arguments as JAX's do.
    with pytest.raises(ValueError, match="role must be"):
        tier.fail_role("verify")
    with pytest.raises(ValueError, match="prefill_cap must be"):
        tier.resplit(0, 1)
    with pytest.raises(ValueError, match="decode_cap must be"):
        tier.resplit(1, 2)


def test_export_cancel_releases_blocks(tm):
    """A request cancelled while parked in the handoff queue releases its
    blocks and its reservation (exports are part of the audit)."""
    tier = DisaggServingEngine(tm, prefill_slots=1, decode_slots=1,
                               paged=True, **KW)
    tier.start(0, np.arange(1, 5, dtype=np.int32), 8)
    while tier.decode_engine.pool.num_active < 1:
        tier.step()
    tier.start(1, np.arange(5, 9, dtype=np.int32), 8)
    while not tier._handoffs:
        tier.step()
    tier.check_invariants()
    in_use = tier.blocks.blocks_in_use
    ev = tier.cancel(1)
    assert ev.reason == "cancelled"
    assert tier.blocks.blocks_in_use < in_use
    tier.check_invariants()
    while tier.busy:
        tier.step()
    assert tier.blocks.blocks_in_use == 0


# --------------------------------------------------------------------- #
# 2. the tiered KV store
# --------------------------------------------------------------------- #


def test_evict_restore_bit_identical(tm, jax_ref):
    """An evict -> spill -> restore cycle: the host copies are the bytes
    written, the warm tokens equal the cold run's (and JAX's)."""
    eng = _paged(tm, num_slots=2, num_blocks=12, kv_host_mb=4.0)
    pool, blocks = eng.pool, eng.pool.blocks
    cold = _one(eng, 0, SYSP, 4)
    assert cold == jax_ref["cold"]
    hashes = hash_prompt_blocks(SYSP, 4)
    before = {h: [a.copy() for a in blocks.read_device_block(
        blocks.device_block(h))] for h in hashes}
    _one(eng, 1, BIG, 9)
    assert blocks.stats()["blocks_spilled"] >= 3
    assert all(blocks.host_has(h) for h in hashes)
    for h in hashes:
        for a, b in zip(before[h], blocks.host._entries[h].arrays):
            np.testing.assert_array_equal(a, b)
    blocks.check_invariants()
    warm = _one(eng, 2, SYSP, 4)
    assert blocks.stats()["blocks_restored"] >= 2
    assert warm == cold
    for h in hashes:
        bid = blocks.device_block(h)
        if bid is None:
            continue
        for a, b in zip(before[h], blocks.read_device_block(bid)):
            np.testing.assert_array_equal(a, b)
    pool.check_invariants()


def test_host_ledger_pinned_to_block_model(tm):
    eng = _paged(tm, num_slots=1, num_blocks=12, kv_host_mb=4.0)
    _one(eng, 0, SYSP, 4)
    _one(eng, 1, BIG, 9)
    host = eng.pool.blocks.host
    assert len(host) >= 3
    model = dict(num_layers=2, num_heads=2, head_dim=16, block_size=4,
                 itemsize=4)
    per_block = kv_block_model_bytes(**model)
    assert per_block == jax_kv_block_model_bytes(**model)
    assert host.bytes_used == len(host) * per_block
    host.check_accounting()


def test_host_store_lru_capacity_units():
    blk = lambda v: [np.full((2, 4, 16), v, np.float32)]  # noqa: E731
    nbytes = blk(0)[0].nbytes
    store = HostKVStore(3 * nbytes)
    for h in ("a", "b", "c"):
        stored, dropped = store.put(h, blk(1))
        assert stored and not dropped
    assert store.put("a", blk(1)) == (True, [])  # refresh: "b" is the LRU
    stored, dropped = store.put("d", blk(2))
    assert stored and dropped == ["b"]
    assert store.has("a") and not store.has("b")
    stored, dropped = store.put("huge", [np.zeros((2, 400, 16), np.float32)])
    assert not stored and not dropped
    arrays = store.pop("a")
    assert arrays is not None and not store.has("a")
    assert store.bytes_used == 2 * nbytes
    store.check_accounting()
    assert store.stats()["host_dropped_blocks"] == 1
    with pytest.raises(ValueError):
        HostKVStore(-1)


# --------------------------------------------------------------------- #
# 3. the eviction cascade
# --------------------------------------------------------------------- #


def test_cascade_kills_descendants_no_phantom_hit(tm):
    eng = _paged(tm, num_slots=2, num_blocks=12)
    pool, blocks = eng.pool, eng.pool.blocks
    _one(eng, 0, SYSP, 4)
    hashes = hash_prompt_blocks(SYSP, 4)
    assert all(blocks.device_block(h) is not None for h in hashes)
    taken = [blocks.take_block() for _ in range(len(blocks._free_blocks))]
    assert blocks.device_block(hashes[0]) is not None
    taken.append(blocks.take_block())
    assert blocks.device_block(hashes[0]) is None
    assert all(blocks.device_block(h) is None for h in hashes[1:])
    assert blocks.chain_unregistered >= 2
    assert pool.lookup(SYSP) == 0
    blocks._free_blocks.extend(taken)
    blocks.check_invariants()


def test_restore_keeps_parent_resolvable_for_eviction_spill(tm):
    eng = _paged(tm, num_slots=2, block_size=8, num_blocks=8,
                 kv_host_mb=4.0)
    pool, blocks = eng.pool, eng.pool.blocks
    sysp = (np.arange(1, 25) % 61).astype(np.int32)
    _one(eng, 0, sysp, 4)
    ha, hb, hc = hash_prompt_blocks(sysp, 8)
    held = [blocks.take_block() for _ in range(len(blocks._free_blocks))]
    held.append(blocks.take_block())
    assert blocks.host_has(ha) and blocks.device_block(hb) is not None
    prompt = np.concatenate([sysp[:8], [55]]).astype(np.int32)
    assert pool.admissible_for(prompt, 8)
    slot, cached = pool.allocate(prompt, 8)
    assert cached == 8
    assert blocks.device_block(ha) is not None
    assert blocks.resolvable(hb) and blocks.resolvable(hc)
    assert blocks.host_has(hb)
    assert blocks.chain_unregistered == 0
    pool.release(slot)
    blocks._free_blocks.extend(held)
    blocks.check_invariants()


def test_register_refuses_orphan(tm):
    blocks = _paged(tm, num_slots=1, num_blocks=6).pool.blocks
    bid = blocks.take_block()
    assert not blocks.register("child", bid, parent="never-seen")
    blocks._free_blocks.append(bid)
    blocks.check_invariants()


# --------------------------------------------------------------------- #
# 4. counters == telemetry, and JAX's report reads them
# --------------------------------------------------------------------- #


def test_disagg_counters_pinned_and_reported(tm, tmp_path):
    from tools.telemetry_report import build_report

    emitter = MetricsEmitter(str(tmp_path), rank=0)
    tier = DisaggServingEngine(tm, prefill_slots=1, decode_slots=1,
                               paged=True, num_blocks=12, kv_host_mb=4.0,
                               **KW)
    sched = ContinuousScheduler(tier, max_queue=8, clock=VirtualClock(),
                                emitter=emitter)
    for i, (p, b) in enumerate([(SYSP, 4), (BIG, 9), (SYSP, 4)]):
        assert sched.submit(Request(i, p, b))
    while not sched.idle:
        sched.tick()
    st = tier.stats()
    assert st["blocks_spilled"] >= 3 and st["blocks_restored"] >= 2, st
    assert st["handoffs"] == 3
    emitter.summary()
    emitter.close()
    (path,) = glob.glob(str(tmp_path / "events.rank*.jsonl"))
    totals: dict = {}
    gauges = set()
    with open(path) as fh:
        for line in fh:
            ev = json.loads(line)
            if ev.get("kind") == "summary":
                totals = ev.get("counters", {})
            gauges.update((ev.get("gauges") or {}).keys())
    for name in ("blocks_spilled", "blocks_restored", "handoffs",
                 "blocks_evicted"):
        assert totals.get(name) == st[name], (name, totals, st)
    for g in ("serve_prefill_slots_active", "serve_decode_slots_active",
              "kv_host_blocks", "kv_host_bytes"):
        assert g in gauges, (g, gauges)
    srv = build_report(str(tmp_path))["serving"]
    assert srv["disagg"]["handoffs"] == st["handoffs"]
    assert srv["kv_host_tier"]["blocks_spilled"] == st["blocks_spilled"]
    assert srv["kv_host_tier"]["blocks_restored"] == st["blocks_restored"]
    assert srv["kv_host_tier"]["kv_host_blocks_last"] is not None


# --------------------------------------------------------------------- #
# 5. the sibling fetch
# --------------------------------------------------------------------- #


def test_sibling_fetch_between_pools(tm):
    def mk():
        return _paged(tm, num_slots=1, num_blocks=12, kv_host_mb=4.0)

    src_eng, dst_eng = mk(), mk()
    cold = _one(src_eng, 0, SYSP, 4)
    src, dst = src_eng.pool.blocks, dst_eng.pool.blocks
    fetched = sibling_fetch(dst, src, SYSP)
    assert fetched >= 2
    assert dst.sibling_fetched_blocks == fetched
    assert dst.stats()["blocks_sibling_fetched"] == fetched
    dst.check_invariants()
    warm = _one(dst_eng, 1, SYSP, 4)
    assert dst.stats()["blocks_restored"] >= 2
    assert warm == cold
    other = _paged(tm, num_slots=1, block_size=8, num_blocks=6,
                   kv_host_mb=4.0)
    with pytest.raises(ValueError, match="block size"):
        sibling_fetch(other.pool.blocks, src, SYSP)


def test_adopt_host_block_self_evicting_parent(tm):
    def mk():
        return _paged(tm, num_slots=1, num_blocks=12, kv_host_mb=4.0)

    src_eng, dst_eng = mk(), mk()
    _one(src_eng, 0, SYSP, 4)
    src, dst = src_eng.pool.blocks, dst_eng.pool.blocks
    per_block = kv_block_model_bytes(num_layers=2, num_heads=2, head_dim=16,
                                     block_size=4, itemsize=4)
    dst.host = HostKVStore(per_block)
    assert sibling_fetch(dst, src, SYSP) == 1
    h0, h1, _ = hash_prompt_blocks(SYSP, 4)
    assert not dst.resolvable(h0) and not dst.resolvable(h1)
    assert len(dst.host) == 0
    dst.check_invariants()


def _router_pair(tm, **kw):
    engines = [_paged(tm, num_slots=2, num_blocks=24, kv_host_mb=2.0)
               for _ in range(2)]
    clock = VirtualClock()
    return engines, ReplicaRouter(engines, clock=clock, **kw), clock


def _warm_replica0(router, clock):
    router.submit(Request(0, SYSP, 4, arrival_time=clock()))
    while not router.idle:
        router.tick()
    router.replicas[0].submit(Request(90, np.arange(5, 10, dtype=np.int32),
                                      4, arrival_time=clock()))


def test_router_sibling_fetch_without_affinity(tm):
    """With affinity off a warm sibling's prefix still chases the
    least-loaded placement."""
    engines, router, clock = _router_pair(tm, affinity=False)
    _warm_replica0(router, clock)
    assert engines[0].pool.lookup(SYSP) > 0
    router.submit(Request(1, SYSP, 4, arrival_time=clock()))
    assert router.affinity_hits == 0
    assert router.sibling_fetches == 1
    assert engines[1].pool.lookup(SYSP) > 0
    while not router.idle:
        router.tick()
    assert engines[1].pool.blocks.blocks_restored >= 2
    engines[1].pool.check_invariants()


def test_router_sibling_fetch_on_rebalance(tm):
    engines, router, clock = _router_pair(tm, affinity_queue_cap=0)
    _warm_replica0(router, clock)
    router.submit(Request(1, SYSP, 4, arrival_time=clock()))
    assert router.rebalanced == 1
    assert router.sibling_fetches == 1
    assert router.sibling_fetch_blocks >= 2
    assert engines[1].pool.lookup(SYSP) > 0
    while not router.idle:
        router.tick()
    assert engines[1].pool.blocks.blocks_restored >= 2
    assert router.stats()["sibling_fetches"] == router.sibling_fetches
    engines[1].pool.check_invariants()


def test_shared_block_pool_views_hand_off(tm):
    """Two views over one BlockPool: an exported row adopts into the
    other view with its refcounts, reservation and pending registrations,
    a cancelled export releases them, and the audit holds throughout."""
    blocks = BlockPool(tm, num_blocks=12, block_size=4)
    pre = PagedKVCachePool(tm, num_slots=1, blocks=blocks, max_len=48)
    dec = PagedKVCachePool(tm, num_slots=2, blocks=blocks, max_len=48)
    slot, cached = pre.allocate(SYSP, 4)
    pre.ensure_length(slot, 12)
    pre.advance(slot, 12)
    export = pre.export_slot(slot)
    assert not pre.active.any() and blocks.outstanding_handoff > 0
    blocks.check_invariants()
    got = dec.adopt_slot(export)
    assert dec.lengths[got] == 12 and blocks.outstanding_handoff == 0
    blocks.check_invariants()
    slot, _ = pre.allocate(BIG[:8], 4)
    pre.ensure_length(slot, 8)
    pre.advance(slot, 8)
    in_use = blocks.blocks_in_use
    dec.release_export(pre.export_slot(slot))
    assert blocks.blocks_in_use < in_use
    blocks.check_invariants()
