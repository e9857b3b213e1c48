#!/usr/bin/env python3
"""Data-parallel parity check: three train steps (two microbatches each)
of a small ResNet, ViT or GPT-2 on this rank's rows of seeded global
batches.

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m pytorch_distributed_training_tpu_torch.tools.dp_check \\
        --model resnet|vit|gpt2 --out OUT [--device cpu] [--backend gloo] \\
        [--init weights.npz] [--batch 8] [--precision f32|bf16] \\
        [--steps 3] [--checkpoint-dir D [--save-at K] [--resume]]

Each rank runs on its card (``LOCAL_RANK``'s) unless ``--device cpu``
asks for the host.

Each rank joins the group (``comm.init.initialize``), takes its rows of
each global batch as the loader deals them (``data.loader.rank_rows``:
JAX's microbatches split over the ranks), runs ``make_train_step`` with
the group (sync-BN, one gradient all-reduce a step) and writes
``OUT/rank<r>.json``: the losses and, after every step (and a restore),
a SHA-256 of every parameter and running statistic (ranks must agree bit
for bit),
plus ``OUT/rank<r>.npz`` with the final parameters and statistics.
``run_steps`` with no group is the one-process run on the whole global
batch that the ranks are held to.

Checkpoints (``checkpoint.CheckpointManager``, rank 0 writes):
``--save-at K`` commits the state after global step K into
``--checkpoint-dir``; ``--resume`` restores the newest step there first
and takes the remaining steps of the same ``--steps`` batches, so a run
saved at one world size continues at another.  Each rank prints its
torchrun identity (``RANK``, ``LOCAL_RANK``, ``GROUP_RANK``: the global
rank, the rank on its node, the node).

Models (the ``--precision`` policy, f32 by default; weights from
``--seed`` unless ``--init`` gives a state dict): ``resnet``, the shallow
ResNet (stage sizes (1, 1), BasicBlock, ``--filters`` 8, 10 classes;
``--small-stem`` for the CIFAR stem), sgd lr 0.05 momentum 0.9 wd 1e-3;
``vit``, a ViT-B/16 cut to 2 layers of width 64 (4 heads, MLP 128, 10
classes) at ``--image-size`` (32 gives 2 x 2 patches), adamw lr 3e-4 wd
0.05; ``gpt2``, 2 layers of width 64, 2 heads, vocab 256, sequence 32,
dropout 0, adamw lr 3e-4 wd 0.1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

GPT2 = dict(num_layers=2, hidden_dim=64, num_heads=2, vocab_size=256,
            max_seq_len=64)
VIT = dict(depth=2, hidden_dim=64, num_heads=4, mlp_dim=128)
SEQ = 32
STEPS, ACCUM = 3, 2       # train steps; microbatches a step


def global_batches(kind: str, steps: int, batch: int, image_size: int,
                   seed: int) -> list[dict]:
    """The seeded global batches, as numpy."""
    rng = np.random.default_rng(seed)
    if kind in ("resnet", "vit"):
        return [{"image": rng.random((batch, image_size, image_size, 3),
                                     np.float32),
                 "label": rng.integers(0, 10, batch).astype(np.int32)}
                for _ in range(steps)]
    return [{"tokens": rng.integers(0, GPT2["vocab_size"],
                                    (batch, SEQ)).astype(np.int32)}
            for _ in range(steps)]


def build_model(kind: str, device, *, seed: int = 0, init: dict | None = None,
                small_stem: bool = False, filters: int = 8,
                image_size: int = 32):
    import torch

    from pytorch_distributed_training_tpu_torch.models import create_model

    if kind == "resnet":
        overrides = {"stage_sizes": (1, 1), "num_filters": filters,
                     "small_stem": small_stem}
        model = create_model("resnet18", num_classes=10, device=device,
                             seed=seed, cfg_overrides=overrides)
    elif kind == "vit":
        model = create_model("vit_b16", num_classes=10, device=device,
                             seed=seed, cfg_overrides=VIT,
                             image_size=image_size)
    else:
        model = create_model("gpt2", device=device, seed=seed,
                             cfg_overrides=GPT2)
    if init is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in init.items()})
    return model


def checksum(state) -> str:
    """SHA-256 over every parameter and running statistic, in order."""
    h = hashlib.sha256()
    for t in [*state.params.values(), *state.batch_stats.values()]:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def run_steps(kind: str, model, batches: list[dict], *, accum: int,
              device, group=None, rank: int = 0, world: int = 1,
              precision: str = "f32", checkpoint=None,
              save_at: int | None = None, resume: bool = False):
    """Train ``model`` on rank ``rank``'s rows of ``batches`` on
    ``device``; returns
    (losses, checksums after each step, final state).  ``checkpoint`` (a
    ``CheckpointManager``): with ``resume`` the state restores from it
    first, the batches before its step are skipped and the checksums
    start with the restored state's; the state after global step
    ``save_at`` is committed to it."""
    import torch

    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer,
    )
    from pytorch_distributed_training_tpu_torch.data.loader import rank_rows
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, make_train_step,
    )

    policy = make_policy(precision)
    tx = {"resnet": build_optimizer("sgd", 0.05, weight_decay=1e-3),
          "vit": build_optimizer("adamw", 3e-4, weight_decay=0.05),
          "gpt2": build_optimizer("adamw", 3e-4, weight_decay=0.1)}[kind]
    state = create_train_state(model, tx, policy=policy, process_group=group)
    if resume:
        restored = checkpoint.restore_latest(state)
        if restored is None:
            raise SystemExit(f"--resume: no committed step under "
                             f"{checkpoint.directory}")
        state = restored
    sums = [checksum(state)] if resume else []
    step = make_train_step(
        kind="lm" if kind == "gpt2" else "image_classifier",
        policy=policy, num_microbatches=accum, process_group=group)
    losses = []
    for b in batches[state.step:]:
        n = len(next(iter(b.values())))
        rows = rank_rows(np.arange(n), rank, world, accum)
        local = {k: torch.from_numpy(v[rows]).to(device)
                 for k, v in b.items()}
        state, metrics = step(state, local)
        losses.append(float(metrics["loss"]))
        sums.append(checksum(state))
        if checkpoint is not None and state.step == save_at:
            checkpoint.save(state, wait=True)
    return losses, sums, state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("resnet", "vit", "gpt2"),
                    required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="default: this rank's card")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--init", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--small-stem", action="store_true")
    ap.add_argument("--filters", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", default="f32", help="f32|bf16")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--save-at", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args()
    import torch

    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from pytorch_distributed_training_tpu_torch.comm import init as comm_init
    from pytorch_distributed_training_tpu_torch.utils.device import (
        resolve_device,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    device = resolve_device("cpu" if args.device == "cpu" else None)
    group = comm_init.initialize(device, backend=args.backend)
    try:
        rank, world = comm_init.process_index(), comm_init.process_count()
        print(" ".join(f"{k} {os.environ.get(k)}" for k in (
            "RANK", "LOCAL_RANK", "GROUP_RANK")), flush=True)
        init = dict(np.load(args.init)) if args.init else None
        model = build_model(args.model, device, seed=args.seed, init=init,
                            small_stem=args.small_stem, filters=args.filters,
                            image_size=args.image_size)
        batches = global_batches(args.model, args.steps, args.batch,
                                 args.image_size, args.seed + 1)
        checkpoint = (CheckpointManager(args.checkpoint_dir,
                                        process_group=group)
                      if args.checkpoint_dir else None)
        losses, sums, state = run_steps(
            args.model, model, batches, accum=ACCUM, group=group,
            rank=rank, world=world, device=device,
            precision=args.precision, checkpoint=checkpoint,
            save_at=args.save_at, resume=args.resume)
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, f"rank{rank}.npz"), **{
            k: v.detach().cpu().numpy()
            for k, v in {**state.params, **state.batch_stats}.items()})
        with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "world": world, "losses": losses,
                       "checksums": sums}, f)
    finally:
        comm_init.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
