"""The serving engine's CUDA graphs on a card (marked ``cuda``; they skip
without one: a graph is captured only on a device).

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda_serve.py -m cuda --noconftest

Pinned, on a small bf16 GPT-2 with weights from a seed: greedy tokens of
an engine that captures its programs equal those of an engine built with
``cuda_graphs=False`` (contiguous, speculative, paged, paged speculative,
int8 paged), through a trace, a ``reset()`` and a second wave, with
every program recorded once in ``PROGRAM_REGISTRY`` at construction and
never again; the kernel launches a replay adds equal what the eager
engine's calls add; sampled tokens equal the eager engine's and come
back the same after ``reset()``'s re-seed; ``draw_categorical`` is
``torch.multinomial``'s draw on the card; a scalar decode index (a host
copy) is refused under capture; a tick after the cache moved raises, and
so does a reset after a parameter was rebound.
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu_torch.analysis.signature import (
    PROGRAM_REGISTRY,
)
from pytorch_distributed_training_tpu_torch.models import GPT2, GPT2Config
from pytorch_distributed_training_tpu_torch.models.generate import (
    draw_categorical,
)
from pytorch_distributed_training_tpu_torch.serve import (
    ContinuousScheduler, Request, ServingEngine, VirtualClock,
)
from pytorch_distributed_training_tpu_torch.serve.engine import (
    KERNEL_WRAPPERS,
)

pytestmark = pytest.mark.cuda
SMALL = dict(num_layers=2, hidden_dim=64, num_heads=2, vocab_size=61,
             max_seq_len=64)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def model(dev):
    m = GPT2(GPT2Config(**SMALL), device=dev, dtype=torch.bfloat16)
    m.init_weights(torch.Generator(device=dev).manual_seed(0))
    return m.eval()


def _requests(seed):
    rng = np.random.default_rng(seed)
    pat = rng.integers(1, 61, (4,)).astype(np.int32)
    prompts = [np.tile(pat, 5)[:13], rng.integers(1, 61, (7,)),
               np.concatenate([rng.integers(1, 61, (3,)), np.tile(pat, 3)]),
               np.tile(pat, 4)[:9], rng.integers(1, 61, (21,))]
    return [p.astype(np.int32) for p in prompts], [14, 10, 12, 16, 8]


def _wave(engine, seed):
    out = {}
    engine.stream_cb = lambda rid, tok: out.setdefault(rid, []).append(tok)
    sched = ContinuousScheduler(engine, clock=VirtualClock())
    for i, (p, b) in enumerate(zip(*_requests(seed))):
        assert sched.submit(Request(i, p, b))
    for _ in range(500):
        if sched.idle:
            break
        sched.tick()
    assert sched.idle
    return out


def _launches():
    return [fn.launches for fn in KERNEL_WRAPPERS]


VARIANTS = {
    "contiguous": dict(),
    "spec": dict(spec_k=4),
    "paged": dict(paged=True, block_size=8),
    "paged-spec": dict(paged=True, block_size=8, spec_k=4),
    "paged-int8": dict(paged=True, block_size=8, kv_dtype="int8"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_graphs_give_the_eager_tokens(dev, model, variant):
    kw = dict(num_slots=3, max_len=64, prefill_chunk=4, temperature=0.0,
              device=dev, **VARIANTS[variant])
    eager = ServingEngine(model, cuda_graphs=False, **kw)
    before = _launches()
    want = [_wave(eager, 1)]
    eager.reset()
    want.append(_wave(eager, 2))
    eager_launches = [a - b for a, b in zip(_launches(), before)]

    engine = ServingEngine(model, **kw)
    assert engine.cuda_graphs
    assert engine.program_signatures == eager.program_signatures
    base = PROGRAM_REGISTRY.snapshot()
    stats = engine.program_stats()
    assert all(p["capture_s"] > 0 for p in stats["programs"].values())
    before = _launches()
    got = [_wave(engine, 1)]
    engine.reset()
    got.append(_wave(engine, 2))
    assert got == want
    # A replay counts the launches its capture recorded.
    assert [a - b for a, b in zip(_launches(), before)] == eager_launches
    assert PROGRAM_REGISTRY.compiles_since(base) == {}
    stats = engine.program_stats()
    assert all(p["replays"] > 0 for p in stats["programs"].values())
    assert stats["graph_pool_bytes"] is None or stats["graph_pool_bytes"] > 0


def test_sampling_replays_draw_as_eager_and_reset_reseeds(dev, model):
    kw = dict(num_slots=3, max_len=64, prefill_chunk=4, temperature=1.0,
              spec_k=3, device=dev, seed=7)
    eager = _wave(ServingEngine(model, cuda_graphs=False, **kw), 3)
    engine = ServingEngine(model, **kw)
    first = _wave(engine, 3)
    engine.reset()
    assert _wave(engine, 3) == first
    assert first == eager


def test_draw_categorical_is_multinomial(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    probs = torch.softmax(torch.randn(16, 50257, device=dev,
                                      generator=gen), -1)
    a = torch.Generator(device=dev).manual_seed(5)
    b = torch.Generator(device=dev).manual_seed(5)
    for _ in range(3):
        assert torch.equal(torch.multinomial(probs, 1, generator=a)[:, 0],
                           draw_categorical(probs, b))


def test_a_scalar_index_is_refused_under_capture(dev):
    from pytorch_distributed_training_tpu_torch.ops import (
        decode_attention as da,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 2, 32, device=dev, generator=gen)
    k = torch.randn(2, 2, 16, 32, device=dev, generator=gen)
    da.decode_attention(q, k, k, 5)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="scalar index"):
        with torch.cuda.graph(graph):
            da.decode_attention(q, k, k, 5)


def test_a_moved_cache_raises(dev, model):
    engine = ServingEngine(model, num_slots=2, max_len=64, prefill_chunk=4,
                           device=dev)
    assert engine.start(0, np.arange(1, 6, dtype=np.int32), 4) == 0
    engine.pool.cache[0] = tuple(t.clone() for t in engine.pool.cache[0])
    with pytest.raises(RuntimeError, match="moved"):
        engine.step()


def test_a_rebound_parameter_raises_at_reset(dev, model):
    engine = ServingEngine(model, num_slots=2, max_len=64, prefill_chunk=4,
                           device=dev)
    engine.reset()
    model.wte = torch.nn.Parameter(model.wte.detach().clone())
    with pytest.raises(RuntimeError, match="moved"):
        engine.reset()
