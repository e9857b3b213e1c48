"""Checkpoints of the port on a card (marked ``cuda``; they skip without
one: the staging under test is CUDA streams and pinned memory).

This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_checkpoint.py -m cuda --noconftest

Pinned: an async save of CUDA tensors stages them into pinned host
buffers on a side stream, and steps taken while the writer is held back
(in-place updates on the compute stream) never reach the committed
bytes; a 2-layer GPT-2 (flash kernels, adamw under warmup-cosine, clip)
preempted by ``sigterm@2`` and resumed on the card ends where the run
that was not interrupted ends: bit for bit, or else no farther from it
than a second uninterrupted run is.
"""

import itertools
import threading

import pytest
import torch

from pytorch_distributed_training_tpu_torch.checkpoint import (
    CheckpointManager,
)
from pytorch_distributed_training_tpu_torch.checkpoint.manager import (
    flatten_state,
)
from pytorch_distributed_training_tpu_torch.cli.main import (
    build_optimizer, build_schedule,
)
from pytorch_distributed_training_tpu_torch.models import create_model
from pytorch_distributed_training_tpu_torch.resilience import (
    FaultInjector, Preempted, PreemptionHandler, parse_faults,
)
from pytorch_distributed_training_tpu_torch.train import (
    Trainer, TrainerConfig, create_train_state, make_policy, make_train_step,
)

pytestmark = pytest.mark.cuda
GPT2 = dict(num_layers=2, hidden_dim=256, num_heads=4, vocab_size=512,
            max_seq_len=256)
SEQ, BATCH, STEPS = 256, 4, 6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staging is CUDA streams")
    return torch.device("cuda")


def _state(dev, seed=0):
    policy = make_policy("bf16")
    model = create_model("gpt2", dtype=policy.param_dtype, device=dev,
                         seed=seed, cfg_overrides=GPT2)
    tx = build_optimizer("adamw", build_schedule(
        "warmup-cosine", 1e-3, total_steps=STEPS, warmup_steps=2),
        weight_decay=0.1, grad_clip=1.0)
    return (create_train_state(model, tx, policy=policy),
            make_train_step(kind="lm", policy=policy, num_microbatches=2))


def _batches():
    """Host batches, as the loader hands them to the trainer."""
    gen = torch.Generator().manual_seed(3)
    return [{"tokens": torch.randint(0, GPT2["vocab_size"], (BATCH, SEQ),
                                     generator=gen).numpy()}
            for _ in range(STEPS)]


def test_async_save_of_cuda_tensors_is_not_torn(dev, tmp_path, monkeypatch):
    state, step = _state(dev)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in _batches()]
    state, _ = step(state, batches[0])
    at_save = {k: v.detach().clone() for k, v in
               flatten_state(state)[0].items()}
    gate = threading.Event()
    real_save = torch.save

    def held(obj, path, *a, **kw):
        assert gate.wait(60)
        return real_save(obj, path, *a, **kw)

    monkeypatch.setattr(torch, "save", held)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state)
    assert all(b.is_pinned() for b in mgr._buffers.values())
    for b in batches[1:3]:
        state, _ = step(state, b)
    gate.set()
    mgr.close()
    monkeypatch.setattr(torch, "save", real_save)
    saved = mgr.load_tensors(1)
    assert saved.keys() == at_save.keys()
    for k, v in at_save.items():
        assert torch.equal(saved[k], v.cpu()), k
    assert not torch.equal(state.params["wte"], at_save["params/wte"])


def _run(dev, tmp_path, *, preempt: bool):
    """The uninterrupted run, or the run preempted before step 2 and
    resumed from its synchronous checkpoint; returns the final state."""
    config = TrainerConfig(log_every=100)
    state, step = _state(dev)
    batches = _batches()
    if not preempt:
        trainer = Trainer(state, step, dev, config)
        trainer.run_epoch(batches)
        return trainer.state
    ck = CheckpointManager(str(tmp_path))
    with PreemptionHandler() as handler:
        t1 = Trainer(state, step, dev, config,
                     faults=FaultInjector(parse_faults("sigterm@2")),
                     preemption=handler,
                     checkpoint_fn=lambda s, wait=False: ck.save(s,
                                                                 wait=wait))
        with pytest.raises(Preempted):
            t1.run_epoch(batches)
    ck.close()
    other, step = _state(dev, seed=1)
    resumed = CheckpointManager(str(tmp_path)).restore_latest(other)
    assert resumed.step == 3
    t2 = Trainer(resumed, step, dev, config)
    t2.run_epoch(itertools.islice(batches, resumed.step, None))
    return t2.state


def _distance(a, b) -> float:
    ta, tb = flatten_state(a)[0], flatten_state(b)[0]
    return max(float((ta[k].detach().double() - tb[k].detach().double())
                     .abs().max())
               for k in ta)


def test_gpt2_preempted_and_resumed_on_the_card(dev, tmp_path):
    ref = _run(dev, tmp_path / "a", preempt=False)
    got = _run(dev, tmp_path / "b", preempt=True)
    assert got.step == ref.step == STEPS
    d1 = _distance(got, ref)
    if d1:
        d0 = _distance(_run(dev, tmp_path / "c", preempt=False), ref)
        assert d1 <= d0, (d1, d0)
