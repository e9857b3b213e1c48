"""The device caches and the skip gate of the port on a card (marked
``cuda``; they skip without one: what they pin is the card's side of
the draws, the gathers and the gated update).

This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_resilience.py -m cuda --noconftest

Pinned: the image cache's batches on the card are bit-equal to the pure
``assemble`` on the host given the card's own draws (both crop modes and
eval), and the token cache's windows to ``gather_windows`` on the host;
no batch after the upload copies anything from the host; the gated step
on the card (GPT-2 through the flash kernels under adamw with
warmup-cosine and a clip, f32 master weights in the bf16 policy; a
ResNet under sgd with momentum) is bitwise the ungated one when nothing
fires, and a NaN step leaves every learned tensor as it was; after its
first step (which uploads the device counts and the optimizer's tables)
a gated step makes no host sync.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu_torch.checkpoint.manager import (
    flatten_state,
)
from pytorch_distributed_training_tpu_torch.cli.main import (
    build_optimizer, build_schedule,
)
from pytorch_distributed_training_tpu_torch.data import (
    DeviceCachedImages, DeviceCachedTokens,
)
from pytorch_distributed_training_tpu_torch.data.device_cache import (
    _STEP, assemble, device_generator,
)
from pytorch_distributed_training_tpu_torch.data.token_cache import (
    gather_windows,
)
from pytorch_distributed_training_tpu_torch.models import create_model
from pytorch_distributed_training_tpu_torch.resilience import (
    AnomalyPolicy, init_resilience_state,
)
from pytorch_distributed_training_tpu_torch.train import (
    create_train_state, make_policy, make_train_step,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the draws and gathers under test "
                    "run on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["per-batch", "per-sample", "eval"])
def test_image_cache_on_the_card_is_assemble_on_the_host(dev, mode):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (40, 20, 18, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 40).astype(np.int32)
    train, per_sample = mode != "eval", mode == "per-sample"
    cache = DeviceCachedImages((images, labels), crop_size=16, device=dev,
                               train=train, seed=7)
    perm = cache.permutation(2).cpu()
    for step, batch in enumerate(cache.batches(
            2, 8, per_sample_crop=per_sample)):
        assert batch["image"].is_cuda
        draws = ([t.cpu() for t in cache.draws(2, step, 8, per_sample)]
                 if train else (None, None, None))
        want = assemble(torch.from_numpy(images), torch.from_numpy(labels),
                        perm[step * 8:(step + 1) * 8], *draws, 16, train)
        assert torch.equal(batch["image"].cpu(), want["image"])
        assert torch.equal(batch["label"].cpu(), want["label"])


def test_token_cache_on_the_card_is_the_host_gather(dev):
    """The card's windows are ``gather_windows`` on the host at the
    starts the card drew (redrawn here from the same seeds)."""
    stream = np.random.default_rng(1).integers(0, 50257, 20_000)
    cache = DeviceCachedTokens(stream, device=dev, seed=3,
                               default_seq_len=128)
    host = torch.from_numpy(stream.astype(np.uint16).view(np.int16))
    for step, batch in enumerate(cache.batches(0, 8, steps=3)):
        gen = device_generator(dev, 3, 0, _STEP, step)
        starts = torch.randint(0, stream.size - 128 + 1, (8,),
                               generator=gen, device=dev)
        want = gather_windows(host, starts.cpu(), 128)
        assert torch.equal(batch["tokens"].cpu(), want)
        assert int(want.max()) >= 2**15     # ids past int16's sign


def test_cache_batches_copy_nothing_from_the_host(dev):
    rng = np.random.default_rng(2)
    cache = DeviceCachedImages(
        (rng.integers(0, 256, (64, 36, 36, 3), dtype=np.uint8),
         rng.integers(0, 10, 64).astype(np.int32)), crop_size=32,
        device=dev)
    tokens = DeviceCachedTokens(rng.integers(0, 50257, 10_000), device=dev,
                                default_seq_len=64)
    batches, windows = cache.batches(0, 16), tokens.batches(0, 4, steps=4)
    next(batches), next(windows)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            next(batches), next(windows)
        torch.cuda.synchronize()
    h2d = [e.name for e in prof.events() if "HtoD" in e.name]
    assert not h2d, h2d


def _gpt2(dev, guard):
    policy = make_policy("bf16")
    model = create_model("gpt2", dtype=policy.param_dtype, device=dev,
                         seed=0, cfg_overrides=dict(
                             num_layers=2, hidden_dim=256, num_heads=4,
                             vocab_size=512, max_seq_len=256))
    tx = build_optimizer("adamw", build_schedule(
        "warmup-cosine", 1e-3, total_steps=4, warmup_steps=2),
        weight_decay=0.1, grad_clip=1.0)
    state = create_train_state(model, tx, policy=policy)
    if guard:
        state = dataclasses.replace(state,
                                    resilience=init_resilience_state(dev))
    step = make_train_step(kind="lm", policy=policy, num_microbatches=2,
                           anomaly_policy=AnomalyPolicy() if guard else None)
    gen = torch.Generator().manual_seed(3)
    batches = [{"tokens": torch.randint(0, 512, (4, 256), generator=gen
                                        ).to(dev)} for _ in range(6)]
    return state, step, batches


def _resnet(dev, guard):
    model = create_model("resnet18", num_classes=10, device=dev, seed=0,
                         cfg_overrides={"stage_sizes": (1, 1),
                                        "num_filters": 16,
                                        "small_stem": True})
    state = create_train_state(model, build_optimizer("sgd", 0.05,
                                                      weight_decay=1e-3))
    if guard:
        state = dataclasses.replace(state,
                                    resilience=init_resilience_state(dev))
    step = make_train_step(kind="image_classifier",
                           anomaly_policy=AnomalyPolicy() if guard else None)
    gen = torch.Generator().manual_seed(4)
    batches = [{"image": torch.rand(8, 16, 16, 3, generator=gen).to(dev),
                "label": torch.randint(0, 10, (8,), generator=gen).int(
                ).to(dev)} for _ in range(6)]
    return state, step, batches


def _learned(state):
    return {n: t.detach().clone() for n, t in flatten_state(state)[0].items()
            if not n.startswith("resilience/") and t.is_floating_point()}


@pytest.mark.parametrize("make", [_gpt2, _resnet], ids=["gpt2", "resnet"])
def test_gated_step_on_the_card_is_bitwise_the_plain_one(dev, make):
    (off, off_step, batches), (on, on_step, _) = make(dev, False), \
        make(dev, True)
    for b in batches:
        off, mo = off_step(off, b)
        on, mn = on_step(on, b)
        assert torch.equal(mo["loss"], mn["loss"])
        assert int(mn["skipped"]) == 0
    want, got = _learned(off), _learned(on)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    # a NaN step: every learned tensor stays, the step advances
    if make is _resnet:
        bad = dict(batches[0], image=torch.full_like(batches[0]["image"],
                                                     float("nan")))
        on2, m = on_step(on, bad)
        assert int(m["skipped"]) == 1 and on2.step == on.step + 1
        after = _learned(on2)
        for name in got:
            assert torch.equal(after[name], got[name]), name


@pytest.mark.parametrize("make", [_gpt2, _resnet], ids=["gpt2", "resnet"])
def test_gated_step_on_the_card_makes_no_host_sync(dev, make):
    """Under the sync debug mode "error" any host sync raises; the warm
    gated steps (the lr and bias-correction tables read on the device,
    the counts and the streaks advanced there) run through."""
    state, step, batches = make(dev, True)
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches[1:]:
            state, m = step(state, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(m["skipped_total"]) == 0
