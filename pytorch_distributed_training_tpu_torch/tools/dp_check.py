#!/usr/bin/env python3
"""Data-parallel parity check: three train steps (two microbatches each)
of a small ResNet, ViT or GPT-2, or of GPT-2 124M, on this rank's rows of
seeded global batches.

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m pytorch_distributed_training_tpu_torch.tools.dp_check \\
        --model resnet|vit|gpt2|gpt2_124m --out OUT [--device cpu] \\
        [--backend gloo] [--init weights.npz] [--batch 8] \\
        [--precision f32|bf16] [--steps 3] [--accum 2] \\
        [--checkpoint-dir D [--save-at K] [--resume]] \\
        [--grad-sync hier|hier-bf16|hier-int8|hier-int4|hier-topk \\
         [--grad-sync-slices S] [--grad-sync-bucket-mb auto|MB] \\
         [--grad-sync-topk-frac F] [--grad-sync-stripe off|auto|N] \\
         [--grad-sync-overlap on|off]] \\
        [--fsdp N] [--tensor-parallel N] [--zero1] \\
        [--sequence-parallel N [--sequence-parallel-mode ring|ulysses]]

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
dropout 0, adamw lr 3e-4 wd 0.1; ``gpt2_124m``, GPT-2 124M at sequence
1024 with ``chip_smoke.py``'s T1 recipe (adamw lr 6e-4 wd 0.1, global
norm clip 1.0, warmup-cosine over 8 steps with 2 of warmup, the bf16
policy unless ``--precision`` says otherwise).

``gpt2_tiny4`` is the JAX package's tiny GPT-2 of its parallel tests (2
layers, width 64, 4 heads, vocab 128, sequence 32), adamw lr 1e-3 wd
0.1: four heads, which tensor parallelism of 4 can split.

The sharding flags are the CLI's (``--fsdp``, ``--tensor-parallel``,
``--zero1``, ``--sequence-parallel``, ``--sequence-parallel-mode``): the
state is sharded over the mesh they give (``data`` takes the rest of
the world), each rank takes its batch group's rows (``BATCH_AXES``), the
checksums hash the gathered whole state, and the JSON adds the mesh
and each rank's bytes of parameters and optimizer slots.  ``probe`` (a
function: ``run_steps``'s ``probe_out``) gives the first batch's loss,
logits and mean gradients before any update, gathered whole.

``--grad-sync`` and its companions are the CLI's flags: the step syncs
through ``comm.hierarchical.GradSync`` instead of the one all-reduce,
and the JSON adds the sync's layout and byte model, each step's time
and the time each sync held the host (its issue and its wait, the card
synchronized around each, the overlapped microbatch not counted), the
residual's largest magnitude, the peak memory and the flash kernels'
launches.
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
SEQ_124M, VOCAB_124M = 1024, 50257
STEPS, ACCUM = 3, 2       # train steps; microbatches a step
GPT2_TINY4 = dict(num_layers=2, hidden_dim=64, num_heads=4, vocab_size=128,
                  max_seq_len=32)
MODELS = ("resnet", "vit", "gpt2", "gpt2_124m", "gpt2_tiny4")


def global_batches(kind: str, steps: int, batch: int, image_size: int,
                   seed: int) -> list[dict]:
    """The seeded global batches, as numpy."""
    rng = np.random.default_rng(seed)
    if kind in ("resnet", "vit"):
        return [{"image": rng.random((batch, image_size, image_size, 3),
                                     np.float32),
                 "label": rng.integers(0, 10, batch).astype(np.int32)}
                for _ in range(steps)]
    vocab, seq = {"gpt2_124m": (VOCAB_124M, SEQ_124M),
                  "gpt2_tiny4": (GPT2_TINY4["vocab_size"], SEQ)}.get(
        kind, (GPT2["vocab_size"], SEQ))
    return [{"tokens": rng.integers(0, vocab, (batch, seq)).astype(np.int32)}
            for _ in range(steps)]


def optimizer(kind: str):
    """Each model's optimizer (the module docstring's)."""
    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer, build_schedule,
    )

    if kind == "gpt2_124m":
        return build_optimizer(
            "adamw", build_schedule("warmup-cosine", 6e-4, total_steps=8,
                                    warmup_steps=2),
            weight_decay=0.1, grad_clip=1.0)
    return {"resnet": lambda: build_optimizer("sgd", 0.05,
                                              weight_decay=1e-3),
            "vit": lambda: build_optimizer("adamw", 3e-4, weight_decay=0.05),
            "gpt2": lambda: build_optimizer("adamw", 3e-4,
                                            weight_decay=0.1),
            "gpt2_tiny4": lambda: build_optimizer("adamw", 1e-3,
                                                  weight_decay=0.1)}[kind]()


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
    elif kind == "gpt2_124m":
        model = create_model("gpt2", device=device, seed=seed)
    elif kind == "gpt2_tiny4":
        model = create_model("gpt2", device=device, seed=seed,
                             cfg_overrides=GPT2_TINY4)
    else:
        model = create_model("gpt2", device=device, seed=seed,
                             cfg_overrides=GPT2)
    if init is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in init.items()})
    return model


def whole(state) -> dict:
    """Every parameter and running statistic, whole (a sharded state's
    gathered: collective)."""
    layout = state.shardings
    out = {}
    for n, t in state.params.items():
        out[n] = t if layout is None else layout.gather_full(f"params/{n}", t)
    return {**out, **state.batch_stats}


def checksum(state) -> str:
    """SHA-256 over every parameter and running statistic, in order."""
    h = hashlib.sha256()
    for t in whole(state).values():
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def sharding_config(fsdp: int = 1, tensor: int = 1, sequence: int = 1,
                    mode: str = "ring", zero1: bool = False,
                    min_size: int | None = None) -> dict | None:
    """The sharding flags as ``run_steps``'s ``sharding`` (None: plain
    data parallelism); ``min_size`` replaces the rules' ``MIN_FSDP_SIZE``
    (1, as JAX's own parity tests set it, shards a small model's every
    leaf)."""
    if fsdp == tensor == sequence == 1 and not zero1:
        return None
    return dict(fsdp=fsdp, tensor=tensor, sequence=sequence, mode=mode,
                zero1=zero1, min_size=min_size)


def probe(kind: str, state, batch: dict, *, policy, accum: int = 1) -> dict:
    """The loss, the logits and the mean gradients of ``batch`` (this
    rank's part) at ``state``, before any update, whole: the sharded
    step's loss and sync without its update (collective)."""
    import torch

    from pytorch_distributed_training_tpu_torch.parallel.grad_accum import (
        accumulate_gradients,
    )
    from pytorch_distributed_training_tpu_torch.train import step as step_lib

    layout, model = state.shardings, state.model.train()
    names = list(state.params)

    def fn(params, mb):
        return step_lib._lm_loss(model, params, mb["tokens"], policy=policy,
                                 generator=None, lm_loss_chunk=None,
                                 label_smoothing=0.0, layout=layout)

    sync = layout.sync_fn(names) if layout is not None else None
    loss, grads = accumulate_gradients(fn, state.params, batch, 1,
                                       sync_fn=sync)
    out = {"loss": loss.detach().float().cpu().numpy()}
    for n, g in grads.items():
        if layout is not None:
            g = layout.gather_full(f"opt_state/grad/{n}", g)
        out[f"grad/{n}"] = g.detach().float().cpu().numpy()
    with torch.no_grad():
        tokens = batch["tokens"]
        if layout is not None and layout.sp_size > 1:
            ll = tokens.shape[1] // layout.sp_size
            tokens = tokens[:, layout.sp_index * ll:
                            (layout.sp_index + 1) * ll]
        logits = torch.func.functional_call(
            model, policy.cast_to_compute(state.params), (tokens,))
        if layout is not None:
            from pytorch_distributed_training_tpu_torch.comm import (
                collectives,
            )
            from pytorch_distributed_training_tpu_torch.comm.mesh import (
                AXIS_SEQUENCE, BATCH_AXES,
            )

            for axes, dim in (((AXIS_SEQUENCE,), 1), (BATCH_AXES, 0)):
                group = layout.mesh.group(axes)
                if group is not None:
                    logits = collectives.all_gather(logits.contiguous(),
                                                    group, gather_axis=dim)
            # The ranks' rows back in the global order (rank_rows dealt
            # each microbatch's rows over the batch group).
            n = layout.mesh.axes_size(BATCH_AXES)
            rest = logits.shape[1:]
            logits = logits.reshape(n, accum, -1, *rest).transpose(
                0, 1).reshape(-1, *rest)
    out["logits"] = logits.float().cpu().numpy()
    return out


def run_steps(kind: str, model, batches: list[dict], *, accum: int,
              device, group=None, rank: int = 0, world: int = 1,
              precision: str = "f32", checkpoint=None,
              save_at: int | None = None, resume: bool = False,
              grad_sync=None, figures: dict | None = None,
              sharding: dict | None = None, probe_out: dict | None = None):
    """Train ``model`` on rank ``rank``'s rows of ``batches`` on
    ``device``; returns
    (losses, checksums after each step, final state).  ``checkpoint`` (a
    ``CheckpointManager``): with ``resume`` the state restores from it
    first, the batches before its step are skipped and the checksums
    start with the restored state's; the state after global step
    ``save_at`` is committed to it.  ``grad_sync`` (a
    ``GradSyncConfig``) syncs through the two-tier sync; ``figures``
    then receives its layout, the step and sync times and the residual's
    largest magnitude after each step.  ``sharding``
    (``sharding_config``) shards the state over the mesh it gives;
    ``figures`` then receives the mesh and this rank's state bytes, and
    ``probe_out`` (a dict) the first batch's ``probe``.  The batch rows
    are dealt over the batch axes (the one-process run: ``rank`` 0 of
    ``world`` 1)."""
    import dataclasses
    import time

    import torch

    from pytorch_distributed_training_tpu_torch.data.loader import rank_rows
    from pytorch_distributed_training_tpu_torch.parallel.sharded import (
        state_bytes,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, make_train_step,
    )

    policy = make_policy(precision)
    figures = {} if figures is None else figures
    mesh = None
    if sharding is not None:
        from pytorch_distributed_training_tpu_torch.comm.mesh import (
            BATCH_AXES, MeshConfig, make_mesh,
        )
        from pytorch_distributed_training_tpu_torch.parallel.sharding import (
            DDP_RULES, ZERO1_OPT_RULES, tp_rules_for,
        )

        mesh = make_mesh(MeshConfig(
            data=-1, fsdp=sharding["fsdp"], tensor=sharding["tensor"],
            sequence=sharding["sequence"]), world=world, rank=rank)
        rules = (tp_rules_for("gpt2" if kind.startswith("gpt2") else kind)
                 if sharding["fsdp"] > 1 or sharding["tensor"] > 1
                 else DDP_RULES)
        opt_rules = ZERO1_OPT_RULES if sharding["zero1"] else None
        if sharding.get("min_size") is not None:
            rules = dataclasses.replace(rules,
                                        min_fsdp_size=sharding["min_size"])
            if opt_rules is not None:
                opt_rules = dataclasses.replace(
                    opt_rules, min_fsdp_size=sharding["min_size"])
        state = create_train_state(
            model, optimizer(kind), policy=policy, mesh=mesh, rules=rules,
            opt_rules=opt_rules, sp_mode=sharding["mode"])
        rank, world = mesh.batch_index, mesh.axes_size(BATCH_AXES)
    else:
        state = create_train_state(model, optimizer(kind), policy=policy,
                                   process_group=group)
    figures.update(mesh=None if mesh is None else mesh.shape,
                   state_bytes=state_bytes(state))
    sync = None
    if grad_sync is not None:
        from pytorch_distributed_training_tpu_torch.comm import GradSync

        if sharding is not None and sharding["zero1"]:
            grad_sync = dataclasses.replace(grad_sync, zero1=True)
        sync = GradSync(group, state.params, grad_sync)
        state = dataclasses.replace(state,
                                    grad_sync_residual=sync.init_residual())
        figures.update(
            n_slices=sync.n_slices, ici_size=sync.ici_size,
            n_buckets=sync.layout.n_buckets, bucket_mb=sync.bucket_mb,
            bucket_policy=sync.bucket_policy, stripe=sync.stripe,
            dcn_bytes_per_sync=sync.dcn_bytes_per_sync(),
            ici_bytes_per_sync=sync.ici_bytes_per_sync(),
            syncs_per_step=sync.syncs_per_step(accum), sync_s=[],
            residual_max=[])
        sync._sync_tree = _timed(sync._sync_tree, figures["sync_s"], device)
    if resume:
        restored = checkpoint.restore_latest(state)
        if restored is None:
            raise SystemExit(f"--resume: no committed step under "
                             f"{checkpoint.directory}")
        state = restored
    sums = [checksum(state)] if resume else []
    step = make_train_step(
        kind="lm" if kind.startswith("gpt2") else "image_classifier",
        policy=policy, num_microbatches=accum,
        process_group=group if mesh is None else None,
        grad_sync=sync, state_shardings=state.shardings)
    losses, figures["step_s"] = [], []
    for b in batches[state.step:]:
        n = len(next(iter(b.values())))
        rows = rank_rows(np.arange(n), rank, world, accum)
        local = {k: torch.from_numpy(v[rows]).to(device)
                 for k, v in b.items()}
        if probe_out is not None and not probe_out:
            probe_out.update(probe(kind, state, local, policy=policy,
                                   accum=accum))
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = step(state, local)
        losses.append(float(metrics["loss"]))
        figures["step_s"].append(time.perf_counter() - t0)
        sums.append(checksum(state))
        if sync is not None and sync.has_residual:
            figures["residual_max"].append(
                float(state.grad_sync_residual.abs().max()))
        if checkpoint is not None and state.step == save_at:
            checkpoint.save(state, wait=True)
    return losses, sums, state


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, seconds: list, device):
    """The sync ``fn`` with the time each call keeps the host appended to
    ``seconds``: its issue plus, when ``async_op`` defers the rest, its
    wait (the next microbatch's compute between them is not counted);
    the card is synchronized around each part."""
    import time

    def clock(part):
        _sync(device)
        t0 = time.perf_counter()
        out = part()
        _sync(device)
        return out, time.perf_counter() - t0

    class Timed:
        def __init__(self, handle, issued):
            self.handle, self.issued = handle, issued

        def wait(self):
            out, waited = clock(self.handle.wait)
            seconds.append(self.issued + waited)
            return out

    def timed(*a, async_op=False):
        out, issued = clock(lambda: fn(*a, async_op=async_op))
        if async_op:
            return Timed(out, issued)
        seconds.append(issued)
        return out

    return timed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=MODELS, required=True)
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
    ap.add_argument("--precision", default=None,
                    help="f32|bf16 (default: bf16 for gpt2_124m, else f32)")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--accum", type=int, default=ACCUM)
    ap.add_argument("--grad-sync", default="flat",
                    choices=("flat", "hier", "hier-bf16", "hier-int8",
                             "hier-int4", "hier-topk"))
    ap.add_argument("--grad-sync-slices", type=int, default=None)
    ap.add_argument("--grad-sync-bucket-mb", default="auto")
    ap.add_argument("--grad-sync-topk-frac", type=float, default=0.1)
    ap.add_argument("--grad-sync-stripe", default="off")
    ap.add_argument("--grad-sync-overlap", default="off",
                    choices=("on", "off"))
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--tensor-parallel", type=int, default=1)
    ap.add_argument("--sequence-parallel", type=int, default=1)
    ap.add_argument("--sequence-parallel-mode", default="ring",
                    choices=("ring", "ulysses"))
    ap.add_argument("--zero1", action="store_true")
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
    from pytorch_distributed_training_tpu_torch.comm import GradSyncConfig

    grad_sync = None
    if args.grad_sync != "flat":
        bucket = args.grad_sync_bucket_mb
        grad_sync = GradSyncConfig(
            mode=args.grad_sync, n_slices=args.grad_sync_slices,
            bucket_mb=bucket if bucket == "auto" else float(bucket),
            topk_frac=args.grad_sync_topk_frac, stripe=args.grad_sync_stripe,
            phase_overlap=args.grad_sync_overlap == "on")
    precision = args.precision or (
        "bf16" if args.model == "gpt2_124m" else "f32")
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
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        figures: dict = {}
        losses, sums, state = run_steps(
            args.model, model, batches, accum=args.accum, group=group,
            rank=rank, world=world, device=device,
            precision=precision, checkpoint=checkpoint,
            save_at=args.save_at, resume=args.resume, grad_sync=grad_sync,
            figures=figures, sharding=sharding_config(
                args.fsdp, args.tensor_parallel, args.sequence_parallel,
                args.sequence_parallel_mode, args.zero1))
        params = whole(state)
        if device.type == "cuda":
            from pytorch_distributed_training_tpu_torch.ops import (
                flash_attention as fa,
            )

            figures["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            figures["flash"] = {"fwd": fa.flash_fwd.launches,
                                "dq": fa.flash_bwd_dq.launches,
                                "dkv": fa.flash_bwd_dkv.launches}
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, f"rank{rank}.npz"), **{
            k: v.detach().cpu().numpy() for k, v in params.items()})
        with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "world": world, "losses": losses,
                       "checksums": sums, **figures}, f)
    finally:
        comm_init.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
