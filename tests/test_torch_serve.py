"""The port's serving path against the JAX reference on converted weights.

Pinned here: greedy tokens of the port's ``ServingEngine`` equal the JAX
engine's exactly, with and without speculative verify (the JAX side runs
its Pallas decode kernels in interpret mode, the port its plain
versions); lockstep ``generate`` equals the JAX ``generate``; the
host-side pieces (drafter, scheduler deadlines and backpressure, SLO
summary) match their JAX twins; and the ``--use-cpu`` CLI serves every
request of its synthetic trace.
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
from pytorch_distributed_training_tpu.models.generate import (
    generate as jax_generate,
)
from pytorch_distributed_training_tpu.serve import (
    ContinuousScheduler as JaxScheduler,
    PromptLookupDrafter as JaxDrafter,
    Request as JaxRequest,
    ServingEngine as JaxEngine,
    VirtualClock as JaxClock,
    summarize_records as jax_summarize,
)
from pytorch_distributed_training_tpu_torch.models import (
    GPT2, GPT2Config, generate, gpt2_params_from_jax,
)
from pytorch_distributed_training_tpu_torch.serve import (
    ContinuousScheduler, PromptLookupDrafter, Request, ServingEngine,
    VirtualClock, summarize_records,
)

SMALL = dict(num_layers=2, hidden_dim=32, num_heads=2, vocab_size=61,
             max_seq_len=48)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _requests(seed=11):
    """Repetitive prompts make the drafter fire; random ones exercise the
    cold-tick fallback; five requests over two slots reuse slots."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(1, 61, (4,)).astype(np.int32)
    prompts = [
        np.tile(pat, 5)[:13],
        rng.integers(1, 61, (7,)).astype(np.int32),
        np.concatenate([rng.integers(1, 61, (3,)), np.tile(pat, 3)]),
        np.tile(pat, 4)[:9],
        rng.integers(1, 61, (5,)).astype(np.int32),
    ]
    return [p.astype(np.int32) for p in prompts], [14, 10, 12, 16, 8]


def _drive(engine, scheduler, request, clock, prompts, budgets):
    streamed = {}
    engine.stream_cb = lambda rid, tok: streamed.setdefault(rid, []).append(tok)
    sched = scheduler(engine, clock=clock())
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        assert sched.submit(request(i, p, b))
    while not sched.idle:
        sched.tick()
    return streamed, sched


@pytest.mark.parametrize("spec_k", [0, 4])
def test_engine_tokens_equal_jax(pair, spec_k, monkeypatch):
    jm, params, tm = pair
    prompts, budgets = _requests()
    kw = dict(num_slots=2, max_len=48, prefill_chunk=4, temperature=0.0,
              spec_k=spec_k)
    monkeypatch.setenv("PDT_DECODE_ATTN", "pallas")
    jax.clear_caches()
    try:
        ref, _ = _drive(JaxEngine(jm, params, **kw), JaxScheduler,
                        JaxRequest, JaxClock, prompts, budgets)
    finally:
        monkeypatch.delenv("PDT_DECODE_ATTN")
        jax.clear_caches()
    engine = ServingEngine(tm, device="cpu", **kw)
    out, sched = _drive(engine, ContinuousScheduler, Request, VirtualClock,
                        prompts, budgets)
    assert out == ref
    assert [len(out[i]) for i in range(5)] == budgets
    assert len(sched.completed) == 5
    if spec_k:
        st = engine.stats()
        assert st["spec_drafted_tokens"] > 0 and st["spec_accepted_tokens"] > 0


def test_generate_matches_jax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 61, (3, 6)).astype(np.int32)
    lengths = np.asarray([6, 3, 5], np.int32)
    ref = np.asarray(jax_generate(
        jm, params, jnp.asarray(prompt), max_new_tokens=9,
        rng=jax.random.PRNGKey(0), prompt_lengths=jnp.asarray(lengths),
        temperature=0.0,
    ))
    out = generate(tm, prompt, max_new_tokens=9, prompt_lengths=lengths,
                   temperature=0.0, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    toks, gen_len = generate(tm, prompt, max_new_tokens=9,
                             prompt_lengths=lengths, temperature=0.0,
                             eos_token_id=int(ref[1, 4]), device="cpu")
    assert int(gen_len[1]) == 2  # row 1 stops at its second sampled token


def test_drafter_matches_jax():
    rng = np.random.default_rng(4)
    pat = rng.integers(0, 9, (3,))
    histories = [np.tile(pat, 4), rng.integers(0, 9, (20,)),
                 np.asarray([5]), np.concatenate([pat, [1, 2], pat])]
    for n in (2, 3, 4):
        jd = JaxDrafter(max_ngram=n, min_ngram=min(2, n))
        td = PromptLookupDrafter(max_ngram=n, min_ngram=min(2, n))
        for h in histories:
            for k in (1, 4):
                np.testing.assert_array_equal(
                    td.draft(h.astype(np.int32), k),
                    jd.draft(h.astype(np.int32), k),
                )


def test_summary_matches_jax():
    recs = [
        dict(id=0, arrival=0.0, first_token=0.5, finish=2.0, generated=4,
             finish_reason="length"),
        dict(id=1, arrival=0.1, first_token=0.4, finish=1.0, generated=1,
             finish_reason="eos"),
        dict(id=2, arrival=0.2, first_token=None, finish=0.3, generated=0,
             finish_reason="shed"),
        dict(id=3, arrival=0.2, first_token=0.6, finish=0.9, generated=3,
             finish_reason="cancelled"),
    ]
    from pytorch_distributed_training_tpu_torch.serve import finalize_record

    recs = [finalize_record(dict(r)) for r in recs]
    kw = dict(queue_depth_samples=[0, 2, 1], active_slot_samples=[1, 2],
              engine_stats=dict(decode_ticks=4, decode_slot_ticks=6,
                                decode_tokens=9, spec_drafted_tokens=5,
                                spec_accepted_tokens=3))
    ours = summarize_records(recs, **kw)
    ref = jax_summarize([dict(r) for r in recs], **kw)
    assert ours == {k: ref[k] for k in ours}


def test_scheduler_backpressure_and_deadlines(pair):
    _, _, tm = pair
    engine = ServingEngine(tm, num_slots=1, max_len=48, device="cpu")
    clock = VirtualClock()
    sched = ContinuousScheduler(engine, max_queue=2, clock=clock)
    p = np.arange(1, 6, dtype=np.int32)
    assert sched.submit(Request(0, p, 20, deadline=1.0))
    assert sched.submit(Request(1, p, 4, deadline=0.5))
    assert not sched.submit(Request(2, p, 4))          # queue full
    with pytest.raises(ValueError, match="exceeds"):
        sched.submit(Request(3, p, 60))
    sched.tick()                                      # request 0 admitted
    clock.advance(0.6)
    sched.tick()                                      # request 1 shed
    clock.advance(0.6)
    sched.tick()                                      # request 0 cancelled
    reasons = {r["id"]: r["finish_reason"] for r in sched.completed}
    assert reasons == {1: "shed", 0: "cancelled"}
    assert (sched.rejected, sched.shed, sched.cancelled) == (1, 1, 1)
    assert sched.idle and engine.pool.num_active == 0


def test_scheduler_admits_tenants_round_robin(pair):
    """A burst from tenant "a" queued ahead of tenant "b" does not starve
    "b": slots fill a, b, a (FIFO within a tenant)."""
    _, _, tm = pair
    engine = ServingEngine(tm, num_slots=3, max_len=48, device="cpu")
    sched = ContinuousScheduler(engine, clock=VirtualClock())
    p = np.arange(1, 4, dtype=np.int32)
    for rid, tenant in (("a1", "a"), ("a2", "a"), ("a3", "a"), ("b1", "b")):
        assert sched.submit(Request(rid, p, 8, tenant=tenant))
    sched.tick()
    assert engine.live_requests() == ["a1", "b1", "a2"]
    assert [r.id for r in sched.queue] == ["a3"]


def test_cli_use_cpu_serves_every_request(tmp_path):
    log = tmp_path / "req.jsonl"
    cmd = [
        sys.executable, "-m", "pytorch_distributed_training_tpu_torch.cli.main",
        "--serve", "--use-cpu", "--model", "gpt2", "--model-overrides",
        "num_layers=2,hidden_dim=64,num_heads=2,vocab_size=256,max_seq_len=64",
        "--seq-len", "32", "--serve-requests", "6", "--serve-slots", "2",
        "--serve-max-new", "8", "--serve-spec", "--metrics-jsonl", str(log),
    ]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "mode=serve | completed=6 |" in res.stdout
    assert "speculation:" in res.stdout
    assert len(log.read_text().splitlines()) == 6


def test_engine_requires_cuda_or_cpu_request(pair, monkeypatch):
    _, _, tm = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tm, num_slots=1)
