#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on one GPU.

    python3 -m pytorch_distributed_training_tpu_torch.tools.train_profile \
        [--model gpt2|resnet18|resnet50|...] [--dataset D] [--image-size N] \
        [--steps 3] [--warmup 2] [--remat] [--ce-chunk 256] [--rows 25]

Builds one of ``chip_smoke.py``'s training configurations:

- ``gpt2`` (default), T1: GPT-2 124M, bf16 policy, sequence 1024, batch
  16 in 2 microbatches, adamw with the warmup-cosine schedule and a
  global-norm clip of 1.0, synthetic tokens;
- ``resnet18``, R1: the reference's run, CIFAR-10-shaped synthetic images
  (``--dataset cifar10``), batch 32, adam lr 0.1 with weight decay 1e-3
  (coupled), f32;
- any other ResNet, R2: ``--dataset synthetic-images``, 1000 classes,
  bf16 policy, batch 128, sgd lr 0.1 with momentum 0.9 and weight decay
  1e-3 (``--image-size 224`` for ImageNet width).

It fetches ``--steps`` batches to the device first (the tool times the
step, not the loader), runs ``--warmup`` steps, times ``--steps`` steady
steps without the profiler (host clock around work ending in a
synchronize), then profiles ``--steps`` more under ``torch.profiler`` and
prints:

- the operators with the most device time, and those with the most host
  time (``key_averages()``);
- one JSON line: the unprofiled step time and tokens (or images) per
  second, the profiled wall time and device-busy share (the union of
  kernel intervals over that wall time), device launches and host
  operator time per step, the ten operators with the most device time
  per step, the flash kernels' device time per step, and the peak memory.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEQ, BATCH, ACCUM = 1024, 16, 2


def busy_seconds(events) -> float:
    """Union of the device-kernel intervals (overlaps counted once)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type.name == "CUDA"
    )
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    return busy_us / 1e6


def _lm_setup(args, device, total):
    """T1: (state, step, loader, items per example, label)."""
    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer, build_schedule,
    )
    from pytorch_distributed_training_tpu_torch.data import (
        DataLoader, DataLoaderConfig, SyntheticTokens,
    )
    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, make_train_step,
    )

    policy = make_policy("bf16")
    model = create_model(args.model, dtype=policy.param_dtype, device=device,
                         seed=0, cfg_overrides={"remat": args.remat})
    lr = build_schedule("warmup-cosine", 6e-4, total_steps=total,
                        warmup_steps=2)
    state = create_train_state(
        model, build_optimizer("adamw", lr, weight_decay=0.1, grad_clip=1.0),
        policy=policy)
    step = make_train_step(kind="lm", policy=policy, num_microbatches=ACCUM,
                           seed=1, lm_loss_chunk=args.ce_chunk)
    loader = DataLoader(SyntheticTokens(seq_len=SEQ),
                        DataLoaderConfig(batch_size=BATCH))
    return state, step, loader, SEQ, "tokens_per_s"


def _image_setup(args, device, total):
    """R1 (resnet18) or R2 (other ResNets): (state, step, loader, items per
    example, label)."""
    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer,
    )
    from pytorch_distributed_training_tpu_torch.data import (
        DataLoader, DataLoaderConfig, ShapeImages, SyntheticImages, cifar10,
    )
    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, make_train_step,
    )

    r1 = args.model == "resnet18"
    dataset = args.dataset or ("cifar10" if r1 else "synthetic-images")
    if dataset == "cifar10":
        ds = cifar10("", synthetic=True)
    elif dataset == "synthetic-images":
        ds = SyntheticImages(image_size=args.image_size, num_classes=1000)
    elif dataset == "shapes":
        ds = ShapeImages()
    else:
        raise SystemExit(f"--dataset {dataset}: cifar10, synthetic-images "
                         "or shapes")
    policy = make_policy("f32" if r1 else "bf16")
    model = create_model(args.model, num_classes=len(ds.classes),
                         dtype=policy.param_dtype, device=device, seed=0)
    tx = (build_optimizer("adam", 0.1, weight_decay=1e-3) if r1
          else build_optimizer("sgd", 0.1, weight_decay=1e-3))
    state = create_train_state(model, tx, policy=policy)
    step = make_train_step(kind="image_classifier", policy=policy)
    loader = DataLoader(ds, DataLoaderConfig(batch_size=32 if r1 else 128))
    return state, step, loader, 1, "images_per_s"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gpt2")
    ap.add_argument("--dataset", default=None,
                    help="ResNets: cifar10 | synthetic-images | shapes")
    ap.add_argument("--image-size", type=int, default=32,
                    help="synthetic-images side")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ce-chunk", type=int, default=None)
    ap.add_argument("--rows", type=int, default=25)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pytorch_distributed_training_tpu_torch.data.loader import to_device

    device = torch.device("cuda", torch.cuda.current_device())
    total = args.warmup + 2 * args.steps
    setup = _lm_setup if args.model.startswith("gpt2") else _image_setup
    state, step, loader, per_example, rate_key = setup(args, device, total)
    batches = [to_device(b, device)
               for b in itertools.islice(iter(loader), args.steps)]
    loader.close()
    examples = next(iter(batches[0].values())).shape[0]
    cycle = itertools.cycle(batches)

    def run(n):
        nonlocal state
        for _ in range(n):
            state, metrics = step(state, next(cycle))
        return float(metrics["loss"])  # waits for the device

    run(args.warmup)
    t0 = time.perf_counter()
    loss = run(args.steps)
    step_s = (time.perf_counter() - t0) / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    avg = prof.key_averages()
    print(avg.table(sort_by="self_cuda_time_total", row_limit=args.rows))
    print(avg.table(sort_by="self_cpu_time_total", row_limit=args.rows))
    events = prof.events()
    busy_s = busy_seconds(events)
    device_events = [e for e in events if e.device_type.name == "CUDA"]
    by_name: dict = {}
    for e in device_events:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    flash_us = sum(us for name, us in by_name.items() if "flash_" in name)
    host_us = sum(a.self_cpu_time_total for a in avg)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "model": args.model,
        "remat": args.remat, "ce_chunk": args.ce_chunk, "steps": args.steps,
        "batch": examples, "loss": loss, "step_ms": step_s * 1e3,
        rate_key: examples * per_example / step_s,
        "profiled_wall_s": wall_s, "device_busy_s": busy_s,
        "device_busy_share": busy_s / wall_s,
        "device_launches_per_step": len(device_events) / args.steps,
        "host_op_ms_per_step": host_us / 1e3 / args.steps,
        "top_device_ms_per_step": [[name[:80], us / 1e3 / args.steps]
                                   for name, us in top],
        "flash_kernels_ms_per_step": flash_us / 1e3 / args.steps,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
