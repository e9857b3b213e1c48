"""The port's paged serving path against the JAX reference on converted
weights.

Pinned here: greedy tokens of the port's paged ``ServingEngine`` equal the
JAX paged engine's exactly (the JAX side takes its gather path on the
CPU, the port the plain versions of its paged kernels), with and without
speculative verify, over native (f32 proxy), int8 and int4 pools; so do
the pool counters, through prefix hits, a whole-prompt hit (copy on
write) and eviction under a small pool with and without the host tier
(spill/restore counters equal).  A scripted ``allocate`` /
``ensure_length`` / ``advance`` / ``rewind`` / ``release`` sequence
drives both ``PagedKVCachePool``s to equal block tables, refcounts,
lengths and stats, with ``check_invariants`` holding throughout.  The
scheduler admits by block budget, the loud errors stay loud, and the
``--use-cpu --serve-paged`` CLI serves every request.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models import gpt2_124m as jax_gpt2
from pytorch_distributed_training_tpu.serve import (
    ContinuousScheduler as JaxScheduler,
    Request as JaxRequest,
    ServingEngine as JaxEngine,
    VirtualClock as JaxClock,
)
from pytorch_distributed_training_tpu.serve.kv_pool import (
    PagedKVCachePool as JaxPagedPool,
)
from pytorch_distributed_training_tpu.serve.kv_store import (
    HostKVStore as JaxHostKVStore,
)
from pytorch_distributed_training_tpu_torch.models import (
    GPT2, GPT2Config, gpt2_params_from_jax, new_kv_blocks,
)
from pytorch_distributed_training_tpu_torch.serve import (
    ContinuousScheduler, HostKVStore, PagedKVCachePool, Request,
    ServingEngine, VirtualClock,
)

SMALL = dict(num_layers=2, hidden_dim=32, num_heads=2, vocab_size=61,
             max_seq_len=48)
PAGED = dict(max_len=48, prefill_chunk=4, temperature=0.0, paged=True,
             block_size=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Counters only the JAX engine keeps: none since the serving tier's port
# (the admission cap and the sibling fetch's count).
JAX_ONLY_STATS: set = set()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the cores are
    shared with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jm = jax_gpt2(cfg_overrides=SMALL)
    params = jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32), train=False
    )["params"]
    tm = GPT2(GPT2Config(**SMALL))
    tm.load_state_dict(
        gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    )
    return jm, params, tm.eval()


def _mixed_requests(seed=11):
    """Repetitive prompts (the drafter fires), random ones, and two pairs
    that share a prefix: one by two full blocks, one entirely (the second
    prompt is the first), over two slots so later requests hit blocks the
    earlier ones registered."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(1, 61, (4,))
    shared = rng.integers(1, 61, (8,))
    prompts = [
        np.tile(pat, 5)[:13],
        np.concatenate([shared, rng.integers(1, 61, (3,))]),
        rng.integers(1, 61, (7,)),
        np.concatenate([shared, rng.integers(1, 61, (6,))]),
        np.tile(pat, 4)[:9],
        np.tile(pat, 4)[:9],
    ]
    return [p.astype(np.int32) for p in prompts], [14, 10, 12, 16, 8, 9]


def _drive(engine, scheduler, request, clock, prompts, budgets):
    streamed = {}
    engine.stream_cb = lambda rid, tok: streamed.setdefault(rid, []).append(tok)
    sched = scheduler(engine, clock=clock())
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        assert sched.submit(request(i, p, b))
    while not sched.idle:
        sched.tick()
    return streamed, sched


def _run_both(pair, prompts, budgets, **kw):
    """The same trace through the JAX paged engine and the port's; returns
    (jax tokens, port tokens, jax stats, port stats, port engine)."""
    jm, params, tm = pair
    kw = {**PAGED, **kw}
    jax_engine = JaxEngine(jm, params, **kw)
    ref, _ = _drive(jax_engine, JaxScheduler, JaxRequest, JaxClock,
                    prompts, budgets)
    engine = ServingEngine(tm, device="cpu", **kw)
    out, sched = _drive(engine, ContinuousScheduler, Request, VirtualClock,
                        prompts, budgets)
    assert len(sched.completed) == len(prompts)
    engine.pool.check_invariants()
    return ref, out, jax_engine.stats(), engine.stats(), engine


def _assert_stats_equal(jax_stats, port_stats):
    assert set(jax_stats) - set(port_stats) <= JAX_ONLY_STATS
    assert port_stats == {k: jax_stats[k] for k in port_stats}


@pytest.mark.parametrize("kw", [
    dict(),
    dict(spec_k=4),
    dict(kv_dtype="int8"),
    dict(kv_dtype="int4", spec_k=4),
    dict(prefill_chunk=65, kv_dtype="int8"),
], ids=["native", "spec", "int8", "int4-spec", "wide-chunk-int8"])
def test_paged_engine_tokens_equal_jax(pair, kw):
    """Chunks of 65 (past MAX_FUSED_PREFILL_CHUNK) take the gather path
    on both sides, with window dequant for the quantized pool."""
    prompts, budgets = _mixed_requests()
    ref, out, jst, pst, _ = _run_both(pair, prompts, budgets, num_slots=2,
                                      num_blocks=24, **kw)
    assert out == ref
    assert [len(out[i]) for i in range(len(prompts))] == budgets
    _assert_stats_equal(jst, pst)
    assert pst["prefix_hit_tokens"] > 0
    assert pst["prefill_tokens_computed"] < pst["prefill_tokens_offered"]
    if "spec_k" in kw:
        assert pst["spec_accepted_tokens"] > 0


def test_shared_prefix_hit_equal_jax(pair):
    """One slot: the second request admits after the first finished and
    hits its two registered prefix blocks."""
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 61, (8,))
    prompts = [np.concatenate([shared, rng.integers(1, 61, (n,))])
               .astype(np.int32) for n in (3, 5)]
    ref, out, jst, pst, _ = _run_both(pair, prompts, [6, 6], num_slots=1,
                                      num_blocks=12)
    assert out == ref
    assert pst["prefix_hit_tokens"] == jst["prefix_hit_tokens"] == 8
    assert pst["prefill_tokens_computed"] == 11 + 13 - 8
    _assert_stats_equal(jst, pst)


def test_whole_prompt_hit_copies_on_write(pair):
    """A prompt entirely covered by cached blocks copies its last block
    and recomputes one token; the greedy continuation is unchanged."""
    prompt = np.arange(1, 13, dtype=np.int32)         # three full blocks
    ref, out, jst, pst, engine = _run_both(
        pair, [prompt, prompt.copy()], [7, 7], num_slots=1, num_blocks=12)
    assert out == ref and out[0] == out[1]
    assert pst["cow_copies"] == jst["cow_copies"] == 1
    assert pst["prefix_hit_tokens"] == 11
    _assert_stats_equal(jst, pst)


def _eviction_trace():
    """Sequential requests over one slot and an 8-block pool: the third
    prompt evicts the first one's cached blocks, the fourth repeats the
    first prompt."""
    rng = np.random.default_rng(9)
    a = rng.integers(1, 61, (12,))
    prompts = [a, rng.integers(1, 61, (12,)), rng.integers(1, 61, (16,)), a]
    return [p.astype(np.int32) for p in prompts], [4, 8, 8, 5]


@pytest.mark.parametrize("host_mb", [None, 0.01], ids=["no-host", "host"])
def test_eviction_equal_jax(pair, host_mb):
    prompts, budgets = _eviction_trace()
    ref, out, jst, pst, engine = _run_both(
        pair, prompts, budgets, num_slots=1, num_blocks=8,
        kv_host_mb=host_mb)
    assert out == ref
    assert out[3][:4] == out[0]            # the same prompt, greedy
    _assert_stats_equal(jst, pst)
    assert pst["blocks_evicted"] > 0
    if host_mb is None:
        assert "blocks_spilled" not in pst
        assert pst["prefix_hit_tokens"] == 0
    else:
        assert pst["blocks_spilled"] > 0 and pst["blocks_restored"] > 0
        assert pst["prefix_hit_tokens"] > 0
        assert pst["host_bytes"] == pst["host_blocks"] * pst["kv_block_bytes"]
        engine.pool.blocks.host.check_accounting()


def test_scripted_pool_sequence_equal_jax(pair):
    """Both PagedKVCachePools through one scripted sequence: prefix hits,
    a COW, speculative growth and rewind, releases and evictions into a
    host tier.  Tables, refcounts, lengths and stats stay equal."""
    jm, _, tm = pair
    jax_pool = JaxPagedPool(
        jm.clone(decode=True), num_slots=3, num_blocks=10, block_size=4,
        max_len=40, host_store=JaxHostKVStore(4 * 2048),
    )
    pool = PagedKVCachePool(tm, num_slots=3, num_blocks=10, block_size=4,
                            max_len=40, host_store=HostKVStore(4 * 2048))
    assert pool.blocks.block_bytes == jax_pool.blocks.block_bytes == 2048
    rng = np.random.default_rng(3)
    a, b = rng.integers(1, 61, (9,)), rng.integers(1, 61, (14,))
    c = np.concatenate([a[:8], rng.integers(1, 61, (2,))])

    def both(fn):
        r1, r2 = fn(jax_pool), fn(pool)
        assert r1 == r2
        np.testing.assert_array_equal(pool.block_tables, jax_pool.block_tables)
        np.testing.assert_array_equal(pool.blocks.refcount,
                                      jax_pool.blocks.refcount)
        np.testing.assert_array_equal(pool.lengths, jax_pool.lengths)
        _assert_stats_equal(jax_pool.stats(), pool.stats())
        jax_pool.check_invariants()
        pool.check_invariants()
        return r2

    def prefill(slot, prompt):
        both(lambda p: p.ensure_length(slot, len(prompt)))
        both(lambda p: p.advance(slot, len(prompt) - int(p.lengths[slot])))

    s0, _ = both(lambda p: p.allocate(a, 6))
    prefill(s0, a)
    both(lambda p: p.ensure_length(s0, 9 + 5))       # a verify tick's room
    both(lambda p: p.advance(s0, 2))
    assert both(lambda p: p.rewind(s0)) == 1         # block 3 was draft-only
    both(lambda p: p.ensure_length(s0, 11 + 3))
    both(lambda p: p.advance(s0, 3))
    assert both(lambda p: p.rewind(s0)) == 0
    assert both(lambda p: p.lookup(c)) == 8
    s1, cached = both(lambda p: p.allocate(c, 4))
    assert cached == 8
    prefill(s1, c)
    both(lambda p: p.release(s0))
    both(lambda p: p.release(s1))
    assert both(lambda p: p.admissible_for(b, 20)) is True
    s2, _ = both(lambda p: p.allocate(b, 20))
    prefill(s2, b)
    both(lambda p: p.ensure_length(s2, 14 + 19))     # evicts and spills
    both(lambda p: p.advance(s2, 19))
    both(lambda p: p.release(s2))
    s3, cached = both(lambda p: p.allocate(a[:8].copy(), 3))  # COW of a host restore
    assert cached == 7
    assert pool.stats()["blocks_spilled"] > 0
    assert pool.stats()["blocks_restored"] > 0 and pool.stats()["cow_copies"] == 1
    both(lambda p: p.release(s3))
    both(lambda p: p.reset())


def test_paged_writes_never_touch_other_blocks(pair):
    """A chunk column past the row's allocated blocks, or past the table
    span, and an idle row at the sentinel position write to the scratch
    block only; every other block keeps its bytes."""
    _, _, tm = pair
    cache = tm.new_block_cache(6, 4)
    gen = torch.Generator().manual_seed(0)
    for layer in cache:
        for t in layer:
            t.copy_(torch.randn(t.shape, generator=gen))
    before = [[t.clone() for t in layer] for layer in cache]
    table = torch.full((2, 12), 6, dtype=torch.int32)
    table[0, :2] = torch.tensor([3, 1])              # row 0: positions 0..7
    tokens = torch.randint(0, 61, (2, 6), generator=gen)
    with torch.no_grad():
        tm(tokens, cache=cache, positions=torch.tensor([6, 48],
           dtype=torch.int32), block_table=table)
    for layer, old in zip(cache, before):
        for t, o in zip(layer, old):
            changed = (t != o).flatten(2).any(-1)    # (blocks + 1, H)
            # Row 0 wrote positions 6, 7 (block 1, offsets 2, 3) and sent
            # 8..11 plus the idle row's whole chunk to scratch block 6.
            assert changed[[1, 6]].all()
            assert not changed[[0, 2, 3, 4, 5]].any()
            torch.testing.assert_close(t[1, :, :2], o[1, :, :2], rtol=0,
                                       atol=0)


def test_rewind_never_frees_a_shared_block(pair):
    _, _, tm = pair
    pool = PagedKVCachePool(tm, num_slots=2, num_blocks=8, block_size=4,
                            max_len=32)
    prompt = np.arange(1, 9, dtype=np.int32)
    s0, _ = pool.allocate(prompt, 4)
    pool.ensure_length(s0, 8)
    pool.advance(s0, 8)
    pool.lengths[s0] = 0          # a corrupted length: a rollback into the prompt
    with pytest.raises(AssertionError, match="shared/registered"):
        pool.rewind(s0)


def test_scheduler_admits_by_block_budget(pair):
    """A free slot is not enough: the second request's worst-case span
    does not fit beside the first's reservation, so it waits at the queue
    head until the first finishes."""
    _, _, tm = pair
    engine = ServingEngine(tm, device="cpu", num_slots=2, num_blocks=6,
                           **PAGED)
    clock = VirtualClock()
    sched = ContinuousScheduler(engine, clock=clock)
    p = np.arange(1, 9, dtype=np.int32)
    assert sched.submit(Request(0, p, 12))            # 5 blocks
    assert sched.submit(Request(1, p[::-1].copy(), 12))
    sched.tick()
    assert engine.pool.num_active == 1 and len(sched.queue) == 1
    assert engine.has_free_slot
    assert not engine.can_admit(sched.queue[0].prompt, 12)
    while not sched.idle:
        clock.advance(0.01)
        sched.tick()
    assert sorted(r["id"] for r in sched.completed) == [0, 1]
    engine.pool.check_invariants()


def test_loud_errors(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="paged=True"):
        ServingEngine(tm, device="cpu", num_slots=1, kv_dtype="int8")
    with pytest.raises(ValueError, match="paged=True"):
        ServingEngine(tm, device="cpu", num_slots=1, kv_host_mb=1.0)
    with pytest.raises(ValueError, match="kv_dtype must be"):
        ServingEngine(tm, device="cpu", num_slots=1, paged=True,
                      kv_dtype="fp8")
    with pytest.raises(ValueError, match="spans more blocks"):
        ServingEngine(tm, device="cpu", num_slots=1, num_blocks=2,
                      **PAGED).validate_request(8, 8)
    with pytest.raises(ValueError, match="even head_dim"):
        new_kv_blocks(2, 2, 4, 7, dtype=torch.float32, device="cpu",
                      kv_quant="int4")
    quantized = new_kv_blocks(2, 2, 4, 16, dtype=torch.float32,
                              device="cpu", kv_quant="int8")
    with pytest.raises(ValueError, match="paged block pool"):
        tm.blocks[0].attn(torch.zeros(1, 1, 32), cache=quantized,
                          positions=torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("extra,expect", [
    ([], "(paged (8 blocks x 16))"),
    (["--serve-kv-dtype", "int8", "--serve-kv-host-mb", "1", "--serve-spec"],
     "kv=int8 + 1 MB host KV tier"),
], ids=["paged", "int8-host-spec"])
def test_cli_use_cpu_serve_paged(extra, expect):
    cmd = [
        sys.executable, "-m", "pytorch_distributed_training_tpu_torch.cli.main",
        "--serve", "--use-cpu", "--model", "gpt2", "--model-overrides",
        "num_layers=2,hidden_dim=64,num_heads=2,vocab_size=256,max_seq_len=64",
        "--seq-len", "32", "--serve-requests", "6", "--serve-slots", "2",
        "--serve-max-new", "8", "--serve-paged", *extra,
    ]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert expect in res.stdout
    assert "mode=serve | completed=6 |" in res.stdout
    assert "paged pool: prefix_hit_rate=" in res.stdout
    assert ("host KV tier: spilled=" in res.stdout) == ("--serve-kv-host-mb"
                                                       in extra)


def test_cli_refuses_quantized_kv_without_paged():
    from pytorch_distributed_training_tpu_torch.cli.main import main

    with pytest.raises(SystemExit, match="add --serve-paged"):
        main(["--serve", "--use-cpu", "--model", "gpt2", "--serve-kv-dtype",
              "int8"])
    with pytest.raises(SystemExit, match="add --serve-paged"):
        main(["--serve", "--use-cpu", "--model", "gpt2", "--serve-kv-host-mb",
              "4"])
