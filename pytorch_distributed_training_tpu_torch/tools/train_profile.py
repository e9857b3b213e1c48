#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on one GPU.

    python3 -m pytorch_distributed_training_tpu_torch.tools.train_profile \
        [--model gpt2|resnet18|resnet50|vit_b16|...] [--dataset D] \
        [--image-size N] [--steps 3] [--warmup 2] [--remat] \
        [--ce-chunk 256] [--rows 25]
    python3 -m torch.distributed.run --standalone --nproc_per_node 1 \
        -m pytorch_distributed_training_tpu_torch.tools.train_profile \
        --distributed [--model ...]

Builds one of ``chip_smoke.py``'s training configurations:

- ``gpt2`` (default), T1: GPT-2 124M, bf16 policy, sequence 1024, batch
  16 in 2 microbatches, adamw with the warmup-cosine schedule and a
  global-norm clip of 1.0, synthetic tokens;
- ``resnet18``, R1: the reference's run, CIFAR-10-shaped synthetic images
  (``--dataset cifar10``), batch 32, adam lr 0.1 with weight decay 1e-3
  (coupled), f32;
- any other ResNet, R2: ``--dataset synthetic-images``, 1000 classes,
  bf16 policy, batch 128, sgd lr 0.1 with momentum 0.9 and weight decay
  1e-3 (``--image-size 224`` for ImageNet width);
- ``vit_s16``/``vit_b16``/``vit_l16``, V1: uint8 batches from a packed
  file of random records it writes under ``build/train_profile/``
  (``--image-size``, default 224, cropped from 232 px records), 1000
  classes, bf16 policy, batch 128, adamw lr 5e-4, weight decay 0.05,
  clip 1.0, the images scaled and normalized in the step.  Before the
  profile it times the three attention variants of ``chip_smoke.py``'s V3
  in turns (bhld2, flash, xla, xla, flash, bhld2; ``--steps`` steps
  each): the default ``bhld2`` layout, ``auto`` under
  ``PDT_FORCE_ATTN=flash`` and ``auto`` under ``PDT_FORCE_ATTN=xla``;
  the profile is of the default layout, then one profile of each other
  variant adds its device time and top operators to the JSON line.

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

``--distributed`` (under torchrun) joins the process group and profiles
the data-parallel step (``make_train_step(process_group=...)``) instead.
It first times the plain and the data-parallel step in turns on the same
state (two rounds of plain, DP, DP, plain; ``--steps`` steps each), one
small all-reduce back to back (500 calls), and, outside the step, the
gradient ``pmean`` on f32 tensors shaped like the parameters against one
``psum`` of a buffer of their size (the difference is its flatten/copy
time).  The profiled steps record the collectives' shapes; each
backend all-reduce row (``nccl:all_reduce``) is the gradient ``pmean``'s
when it is the step's largest and sync-BN's otherwise, and its
``c10d::allreduce_`` row (the same call, in the same order) gives its
host time.  The JSON line then adds, per step: the NCCL kernels' device
time and count, each kind's all-reduce count, host time and device time,
and the host time of all collectives.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEQ, BATCH, ACCUM = 1024, 16, 2
TURNS = 2   # --distributed: rounds of plain, DP, DP, plain


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


def _lm_setup(args, device, total, group=None):
    """T1: (state, step factory, loader, items per example, label); the
    factory takes the process group (or None)."""
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
        policy=policy, process_group=group)

    def make_step(process_group):
        return make_train_step(kind="lm", policy=policy,
                               num_microbatches=ACCUM, seed=1,
                               lm_loss_chunk=args.ce_chunk,
                               process_group=process_group)

    loader = DataLoader(SyntheticTokens(seq_len=SEQ),
                        DataLoaderConfig(batch_size=BATCH))
    return state, make_step, loader, SEQ, "tokens_per_s"


def _image_setup(args, device, total, group=None):
    """R1 (resnet18) or R2 (other ResNets): (state, step factory, loader,
    items per example, label)."""
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
        ds = SyntheticImages(image_size=args.image_size or 32,
                             num_classes=1000)
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
    state = create_train_state(model, tx, policy=policy,
                               process_group=group)

    def make_step(process_group):
        return make_train_step(kind="image_classifier", policy=policy,
                               process_group=process_group)

    loader = DataLoader(ds, DataLoaderConfig(batch_size=32 if r1 else 128))
    return state, make_step, loader, 1, "images_per_s"


def _vit_setup(args, device, total, group=None):
    """V1 (a ViT): (state, step factory, loader, items per example,
    label)."""
    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer,
    )
    from pytorch_distributed_training_tpu_torch.data import (
        DataLoader, DataLoaderConfig, PackedImages, synthesize_packed_images,
    )
    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, make_train_step,
    )

    size = args.image_size or 224
    out_dir = os.path.join(REPO, "build", "train_profile")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "vit.pck")
    synthesize_packed_images(path, n=128 * args.steps,
                             size=size + size // 28, num_classes=1000)
    ds = PackedImages(path, crop_size=size, output_dtype="uint8")
    policy = make_policy("bf16")
    model = create_model(args.model, num_classes=1000, image_size=size,
                         dtype=policy.param_dtype, device=device, seed=0,
                         cfg_overrides={"remat": args.remat,
                                        "attn_layout": "auto"})
    state = create_train_state(
        model, build_optimizer("adamw", 5e-4, weight_decay=0.05,
                               grad_clip=1.0),
        policy=policy, process_group=group)

    def make_step(process_group):
        return make_train_step(kind="image_classifier", policy=policy,
                               input_normalize=(ds.mean, ds.std),
                               process_group=process_group)

    loader = DataLoader(ds, DataLoaderConfig(batch_size=128))
    return state, make_step, loader, 1, "images_per_s"


# The attention variants of a ViT: (layout, PDT_FORCE_ATTN).
VIT_ATTN = {"bhld2": ("bhld2", ""), "flash": ("auto", "flash"),
            "xla": ("auto", "xla")}


def set_attn(model, variant: str) -> None:
    """Switch every attention of ``model`` to ``VIT_ATTN[variant]``: its
    layout and the ``PDT_FORCE_ATTN`` dispatch override."""
    layout, forced = VIT_ATTN[variant]
    for m in model.modules():
        if hasattr(m, "attn_layout"):
            m.attn_layout = layout
    os.environ["PDT_FORCE_ATTN"] = forced


def _device_rows(events) -> dict:
    """Device time (us) by kernel name."""
    by_name: dict = {}
    for e in events:
        if e.device_type.name == "CUDA":
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.end - e.time_range.start)
    return by_name


def _time_calls(torch, fn, n: int) -> tuple[float, float]:
    """``fn`` back to back ``n`` times after a warm-up: (host ms a call,
    stream ms a call between CUDA events around the calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    end.synchronize()
    return host_ms, start.elapsed_time(end) / n


def _all_reduce_rows(events) -> list[tuple]:
    """(elements, host us, device us) of each all-reduce in the profile,
    in call order: the backend's row (``nccl:all_reduce``, recorded with
    its tensor's shape) paired with the ``c10d::allreduce_`` row of the
    same call, whose host time includes the dispatch and whose device
    time the kernel it launched."""
    def ordered(rows):
        return sorted(rows, key=lambda e: e.time_range.start)

    c10d = ordered(e for e in events if e.name == "c10d::allreduce_")
    backend = ordered(e for e in events if e.name.endswith(":all_reduce")
                      and e.device_type.name == "CPU")
    if len(c10d) != len(backend):
        raise RuntimeError(f"{len(c10d)} c10d::allreduce_ rows against "
                           f"{len(backend)} backend all-reduce rows")
    rows = []
    for call, row in zip(c10d, backend):
        numel = 1
        for d in row.input_shapes[0]:
            numel *= d
        rows.append((numel, call.cpu_time_total, _device_us(call)))
    return rows


def _device_us(event) -> float:
    """A profiler row's device time with its children's (the attribute's
    name moved across torch versions)."""
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gpt2")
    ap.add_argument("--dataset", default=None,
                    help="ResNets: cifar10 | synthetic-images | shapes")
    ap.add_argument("--image-size", type=int, default=None,
                    help="synthetic-images side (default 32), or a ViT's "
                         "crop side (default 224)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ce-chunk", type=int, default=None)
    ap.add_argument("--rows", type=int, default=25)
    ap.add_argument("--distributed", action="store_true",
                    help="profile the data-parallel step (under torchrun)")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pytorch_distributed_training_tpu_torch.comm import (
        collectives, init as comm_init,
    )
    from pytorch_distributed_training_tpu_torch.data.loader import to_device
    from pytorch_distributed_training_tpu_torch.utils.device import (
        resolve_device,
    )

    device = resolve_device(None)
    group = comm_init.initialize(device) if args.distributed else None
    if args.distributed and group is None:
        print("train_profile: --distributed needs torchrun's env",
              file=sys.stderr)
        return 1
    try:
        return _profile(args, torch, profile, ProfilerActivity, to_device,
                        collectives, device, group)
    finally:
        comm_init.shutdown()


def _profile(args, torch, profile, ProfilerActivity, to_device, collectives,
             device, group) -> int:
    total = args.warmup + 2 * args.steps
    vit = args.model.startswith("vit")
    setup = (_lm_setup if args.model.startswith("gpt2")
             else _vit_setup if vit else _image_setup)
    if args.distributed:
        total += (4 * TURNS + 1) * args.steps
    state, make_step, loader, per_example, rate_key = setup(
        args, device, total, group)
    step = make_step(group)
    batches = [to_device(b, device)
               for b in itertools.islice(iter(loader), args.steps)]
    loader.close()
    examples = next(iter(batches[0].values())).shape[0]
    cycle = itertools.cycle(batches)

    def run(n, fn=step):
        nonlocal state
        for _ in range(n):
            state, metrics = fn(state, next(cycle))
        return float(metrics["loss"])  # waits for the device

    extra: dict = {}
    if vit:
        turns: dict = {k: [] for k in VIT_ATTN}
        for name in VIT_ATTN:
            set_attn(state.model, name)
            run(args.warmup)
        for name in ("bhld2", "flash", "xla", "xla", "flash", "bhld2"):
            set_attn(state.model, name)
            run(1)
            t0 = time.perf_counter()
            run(args.steps)
            turns[name].append((time.perf_counter() - t0) / args.steps * 1e3)
        extra = {"attn_step_ms_turns": turns,
                 "attn_step_ms_median": {k: statistics.median(v)
                                         for k, v in turns.items()}}
        for name in ("flash", "xla"):
            set_attn(state.model, name)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run(args.steps)
            rows = _device_rows(prof.events())
            top = sorted(rows.items(), key=lambda kv: -kv[1])[:8]
            extra[f"{name}_device_ms_per_step"] = (
                sum(rows.values()) / 1e3 / args.steps)
            extra[f"{name}_flash_kernels_ms_per_step"] = sum(
                us for n, us in rows.items() if "flash_" in n
            ) / 1e3 / args.steps
            extra[f"{name}_top_device_ms_per_step"] = [
                [n[:80], us / 1e3 / args.steps] for n, us in top]
        set_attn(state.model, "bhld2")
    run(args.warmup)
    if args.distributed:
        plain = make_step(None)
        run(1, plain)
        turns: dict = {"plain": [], "dp": []}
        for name in ("plain", "dp", "dp", "plain") * TURNS:
            t0 = time.perf_counter()
            run(args.steps, plain if name == "plain" else step)
            turns[name].append((time.perf_counter() - t0) / args.steps * 1e3)
        small = torch.zeros(129, device=device)
        small_ms, _ = _time_calls(
            torch, lambda: collectives.psum(small, group), 500)
        grads = [torch.zeros_like(p, dtype=torch.float32)
                 for p in state.params.values()]
        flat = torch.zeros(sum(g.numel() for g in grads), device=device)
        pmean_host, pmean_ms = _time_calls(
            torch, lambda: collectives.pmean(grads, group), 20)
        _, psum_ms = _time_calls(
            torch, lambda: collectives.psum(flat, group), 20)
        extra = {"step_ms_plain_turns": turns["plain"],
                 "step_ms_dp_turns": turns["dp"],
                 "step_ms_plain_median": statistics.median(turns["plain"]),
                 "step_ms_dp_median": statistics.median(turns["dp"]),
                 "small_all_reduce_us": small_ms * 1e3,
                 "grad_mb": flat.numel() * 4 / 1e6,
                 "pmean_alone_host_ms": pmean_host,
                 "pmean_alone_ms": pmean_ms,
                 "psum_flat_alone_ms": psum_ms,
                 "flatten_copy_ms": pmean_ms - psum_ms}
        del grads, flat
    t0 = time.perf_counter()
    loss = run(args.steps)
    step_s = (time.perf_counter() - t0) / args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=args.distributed) as prof:
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
    by_name = _device_rows(events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    flash_us = sum(us for name, us in by_name.items() if "flash_" in name)
    host_us = sum(a.self_cpu_time_total for a in avg)
    per = 1e3 * args.steps
    if args.distributed:
        nccl = [e for e in device_events if "nccl" in e.name.lower()]
        nccl_us = sum(e.time_range.end - e.time_range.start for e in nccl)
        rows = _all_reduce_rows(events)
        largest = max(n for n, _, _ in rows)
        kinds = {"grad_all_reduce": [r for r in rows if r[0] == largest],
                 "sync_bn": [r for r in rows if r[0] != largest]}
        extra.update({
            "world": torch.distributed.get_world_size(),
            "backend": torch.distributed.get_backend(),
            "nccl_kernels_per_step": len(nccl) / args.steps,
            "nccl_kernels_ms_per_step": nccl_us / per,
            "collectives_host_ms_per_step": sum(r[1] for r in rows) / per,
        })
        for kind, rs in kinds.items():
            extra.update({
                f"{kind}s_per_step": len(rs) / args.steps,
                f"{kind}_host_ms_per_step": sum(r[1] for r in rs) / per,
                f"{kind}_device_ms_per_step": sum(r[2] for r in rs) / per,
            })
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "model": args.model,
        "remat": args.remat, "ce_chunk": args.ce_chunk, "steps": args.steps,
        "device_ms_per_step": sum(by_name.values()) / 1e3 / args.steps,
        "distributed": args.distributed,
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
        **extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
