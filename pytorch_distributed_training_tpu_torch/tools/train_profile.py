#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on one GPU.

    python3 -m pytorch_distributed_training_tpu_torch.tools.train_profile \
        [--steps 3] [--warmup 2] [--remat] [--ce-chunk 256] [--rows 25]

Builds the main training configuration of ``chip_smoke.py`` (GPT-2 124M,
bf16 policy, sequence 1024, batch 16 in 2 microbatches, adamw with the
warmup-cosine schedule and a global-norm clip of 1.0, synthetic tokens),
runs ``--warmup`` steps, times ``--steps`` steady steps without the
profiler (host clock around work ending in a synchronize), then profiles
``--steps`` more under ``torch.profiler`` and prints:

- the operators with the most device time, and those with the most host
  time (``key_averages()``);
- one JSON line: the unprofiled step time and tokens per second, the
  profiled wall time and device-busy share (the union of kernel intervals
  over that wall time), device launches and host operator time per step,
  and the flash kernels' device time per step.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer, build_schedule,
    )
    from pytorch_distributed_training_tpu_torch.data import (
        DataLoader, DataLoaderConfig, SyntheticTokens,
    )
    from pytorch_distributed_training_tpu_torch.data.loader import to_device
    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, make_train_step,
    )

    device = torch.device("cuda", torch.cuda.current_device())
    policy = make_policy("bf16")
    total = args.warmup + 2 * args.steps
    model = create_model("gpt2", dtype=policy.param_dtype, device=device,
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
    batches = iter(loader)

    def run(n):
        nonlocal state
        for _ in range(n):
            state, metrics = step(state, to_device(next(batches), device))
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
    flash_us = sum(e.time_range.end - e.time_range.start
                   for e in device_events if "flash_" in e.name)
    host_us = sum(a.self_cpu_time_total for a in avg)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "remat": args.remat,
        "ce_chunk": args.ce_chunk, "steps": args.steps, "loss": loss,
        "step_ms": step_s * 1e3,
        "tokens_per_s": BATCH * SEQ / step_s,
        "profiled_wall_s": wall_s, "device_busy_s": busy_s,
        "device_busy_share": busy_s / wall_s,
        "device_launches_per_step": len(device_events) / args.steps,
        "host_op_ms_per_step": host_us / 1e3 / args.steps,
        "flash_kernels_ms_per_step": flash_us / 1e3 / args.steps,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
