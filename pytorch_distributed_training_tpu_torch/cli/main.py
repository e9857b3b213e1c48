"""Command line of the port: the image-classifier and LM training and
``--serve`` subsets of the JAX package's ``cli/main.py``, same flag names
and defaults, same printed milestones and summary lines.

    python -m pytorch_distributed_training_tpu_torch.cli.main --synthetic-data

runs the reference's own command (ResNet-18 on CIFAR-10-shaped data,
batch 32, adam, lr 0.1) on CUDA; ``--use-cpu`` runs on the host;

    python -m pytorch_distributed_training_tpu_torch.cli.main \\
        --model gpt2 --dataset synthetic-tokens --precision bf16 \\
        --batch-size 16 --accum-steps 2 --optimizer adamw

trains GPT-2; ``--serve`` serves instead (add ``--serve-paged
[--serve-kv-dtype int8] [--serve-kv-host-mb 64]`` for the paged KV pool);

    python -m pytorch_distributed_training_tpu_torch.cli.main \
        --model vit_b16 --dataset packed-images:train.pck --image-size 224 \
        --precision bf16 --batch-size 128 --optimizer adamw \
        --learning-rate 5e-4 --weight-decay 0.05 --grad-clip 1.0

trains ViT-B/16 on packed ImageNet-format records (``imagefolder:<root>``
reads a class-folder tree instead).

    python -m torch.distributed.run --nproc_per_node 2 \
        -m pytorch_distributed_training_tpu_torch.cli.main --distributed ...

trains data-parallel, one process per GPU (``--use-cpu``: gloo on the
host); ``--batch-size`` stays global.  Checkpoints are not ported yet, so
the server runs fresh-init weights drawn from ``--seed``.  Not ported
yet: tensor, pipeline and sequence parallelism, the MoE GPT-2,
``--device-cache``, checkpoint and resume, telemetry and resilience.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _parse_overrides(text: str | None) -> dict:
    """``"num_layers=2,hidden_dim=64"`` → dict of int/float/bool values."""
    overrides: dict = {}
    for item in (text or "").split(","):
        if not item.strip():
            continue  # tolerate trailing commas
        k, sep, v = item.partition("=")
        k, v = k.strip(), v.strip()
        if not sep or not k or not v:
            raise ValueError(f"--model-overrides entry {item!r} is not key=value")
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
            continue
        try:
            overrides[k] = int(v)
        except ValueError:
            try:
                overrides[k] = float(v)
            except ValueError:
                raise ValueError(
                    f"--model-overrides value for {k!r} must be "
                    f"int/float/bool, got {v!r}"
                ) from None
    return overrides


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pytorch_distributed_training_tpu_torch.cli.main",
        description="ResNet, ViT and GPT-2 training and "
                    "continuous-batching serving on CUDA (PyTorch port).",
    )
    p.add_argument("--use-cpu", action="store_true",
                   help="Run on the host instead of the CUDA device.")
    p.add_argument("--distributed", action="store_true",
                   help="Data-parallel run over the process group that "
                        "torchrun's env describes (NCCL on CUDA, gloo on "
                        "the host).")
    p.add_argument("--data-dir", default="./data", help="Dataset root.")
    p.add_argument("--model", default="resnet18",
                   help="resnet18|resnet50|vit_b16|gpt2|... (the registry's "
                        "names)")
    p.add_argument("--model-overrides", default=None,
                   help="Comma-separated config overrides, e.g. "
                        "'num_layers=2,hidden_dim=64,vocab_size=512'.")
    p.add_argument("--precision", default="f32", help="f32|bf16|bf16_full")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq-len", type=int, default=1024,
                   help="LM sequence length (bounds the synthetic prompts).")
    p.add_argument("--metrics-jsonl", default=None,
                   help="Append per-epoch metrics (training) or one record "
                        "per finished request (--serve) here.")
    # --- training (the JAX CLI's flags and defaults) ---
    p.add_argument("--dataset", default="cifar10",
                   help="cifar10|shapes|synthetic-images|"
                        "imagefolder:<root>|packed-images:<path>|"
                        "synthetic-tokens|token-file:<path>")
    p.add_argument("--synthetic-data", action="store_true",
                   help="Use synthetic data (no dataset files needed).")
    p.add_argument("--image-size", type=int, default=32,
                   help="Synthetic image side, and the crop side of "
                        "imagefolder:/packed-images: (224 for ImageNet).")
    p.add_argument("--batch-size", type=int, default=32,
                   help="Global batch size.")
    p.add_argument("--num-workers", type=int, default=2,
                   help="Decode worker processes.")
    p.add_argument("--learning-rate", type=float, default=0.1)
    p.add_argument("--weight-decay", type=float, default=0.001)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="Cap steps per epoch (smoke runs).")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="Gradient-accumulation microbatches per step.")
    p.add_argument("--optimizer", default="adam",
                   help="adam (coupled L2, torch Adam(weight_decay=) "
                        "semantics) | adamw (decoupled) | sgd (momentum, "
                        "coupled L2).")
    p.add_argument("--momentum", type=float, default=0.9,
                   help="SGD momentum (--optimizer sgd only).")
    p.add_argument("--grad-clip", type=float, default=None,
                   help="Global-norm gradient clipping before the optimizer.")
    p.add_argument("--label-smoothing", type=float, default=0.0,
                   help="CE label smoothing.")
    p.add_argument("--lr-schedule", default="constant",
                   help="constant|cosine|warmup-cosine")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="Linear warmup steps (warmup-cosine schedule).")
    p.add_argument("--total-steps", type=int, default=None,
                   help="Decay horizon for cosine schedules (defaults to "
                        "epochs x steps per epoch).")
    p.add_argument("--ce-chunk", type=int, default=None,
                   help="LM loss: head matmul + softmax-CE in sequence "
                        "chunks of this size instead of the full (batch, "
                        "seq, vocab) logits.")
    p.add_argument("--remat", action="store_true",
                   help="Rematerialize transformer blocks in the backward.")
    p.add_argument("--eval", dest="do_eval", action="store_true",
                   help="Evaluate on a held-out split after each epoch.")
    p.add_argument("--eval-steps", type=int, default=None,
                   help="Cap eval batches per pass (smoke runs).")
    p.add_argument("--serve", action="store_true",
                   help="Serve the model on a synthetic mixed-length "
                        "request trace instead of training.")
    p.add_argument("--serve-requests", type=int, default=16)
    p.add_argument("--serve-rate", type=float, default=0.0,
                   help="Offered load in requests/sec, Poisson arrivals "
                        "(0 = all requests arrive at t=0).")
    p.add_argument("--serve-slots", type=int, default=4,
                   help="Concurrent decode slots (KV-cache pool rows).")
    p.add_argument("--serve-max-new", type=int, default=32,
                   help="Per-request generation budget cap.")
    p.add_argument("--serve-prefill-chunk", type=int, default=16,
                   help="Prompt tokens written per prefill tick.")
    p.add_argument("--serve-paged", action="store_true",
                   help="Paged KV cache: fixed-size blocks and per-slot "
                        "block tables instead of contiguous rows; shared "
                        "prompt prefixes skip prefill via the block cache.")
    p.add_argument("--serve-block-size", type=int, default=16,
                   help="KV positions per block (--serve-paged); also the "
                        "prefix-cache sharing granularity.")
    p.add_argument("--serve-num-blocks", type=int, default=0,
                   help="Blocks in the pool (--serve-paged); 0 sizes it "
                        "like the contiguous pool (slots x ceil(max_len / "
                        "block_size)).")
    p.add_argument("--serve-kv-dtype", default="bf16",
                   choices=("bf16", "int8", "int4"),
                   help="KV storage (--serve-paged): bf16 keeps the model's "
                        "dtype; int8/int4 quantize the blocks with a bf16 "
                        "scale per position and head.")
    p.add_argument("--serve-kv-host-mb", type=float, default=0.0,
                   help="Host-RAM KV tier in MB (--serve-paged): evicted "
                        "prefix blocks spill there and are restored on a "
                        "hit; 0 = no host tier.")
    p.add_argument("--serve-spec", action="store_true",
                   help="Speculative decoding with the prompt-lookup drafter.")
    p.add_argument("--serve-spec-k", type=int, default=4,
                   help="Max draft tokens verified per slot per tick.")
    p.add_argument("--serve-spec-ngram", type=int, default=4,
                   help="Longest suffix n-gram the drafter matches.")
    return p


def run_serve(*, model, overrides, precision, seed, seq_len, metrics_jsonl,
              n_requests, rate, num_slots, max_new, prefill_chunk, spec_k=0,
              spec_ngram=4, device=None, paged=False, block_size=16,
              num_blocks=0, kv_dtype="bf16", kv_host_mb=0.0) -> dict:
    """Serve ``model`` over the synthetic trace and print the summary.

    Returns ``{"summary", "engine", "tokens"}``: the SLO summary, the
    engine's counters, and every request's generated tokens by id."""
    from ..models import create_model
    from ..serve import (
        ContinuousScheduler, Request, ServingEngine, summarize_records,
    )
    from ..train import make_policy
    from ..utils import metrics as metrics_lib
    from ..utils.device import resolve_device

    if kv_host_mb and not paged:
        raise SystemExit(
            "--serve-kv-host-mb spills paged blocks — add --serve-paged"
        )
    if kv_dtype != "bf16" and not paged:
        raise SystemExit(
            "--serve-kv-dtype quantizes paged blocks — add --serve-paged"
        )
    device = resolve_device(device)
    policy = make_policy(precision)
    # Serving casts every parameter (LayerNorm and embeddings included) to
    # the compute dtype, as the JAX CLI does.
    print("warning: serving FRESH-INIT weights (pass --checkpoint-dir "
          "with a trained run for real outputs)")
    net = create_model(
        model, dtype=policy.compute_dtype, device=device, seed=seed,
        cfg_overrides=overrides,
    )
    if max_new > net.cfg.max_seq_len - 2:
        raise ValueError(
            f"--serve-max-new {max_new} leaves no room for a prompt in the "
            f"model's {net.cfg.max_seq_len}-position cache"
        )
    max_len = net.cfg.max_seq_len
    tokens: dict = {}
    engine = ServingEngine(
        net, num_slots=num_slots, max_len=max_len,
        prefill_chunk=prefill_chunk, temperature=0.0, seed=seed,
        spec_k=spec_k, spec_ngram=spec_ngram, device=device,
        stream_cb=lambda rid, tok: tokens.setdefault(rid, []).append(tok),
        paged=paged, block_size=block_size, num_blocks=num_blocks or None,
        kv_dtype=kv_dtype, kv_host_mb=kv_host_mb or None,
    )
    rng = np.random.default_rng(seed)
    p_hi = max(min(seq_len, max_len - max_new) // 2, 2)
    prompts = [
        rng.integers(0, net.cfg.vocab_size,
                     (int(rng.integers(2, p_hi + 1)),)).astype(np.int32)
        for _ in range(n_requests)
    ]
    budgets = rng.integers(max(max_new // 4, 1), max_new + 1, n_requests)
    if rate and rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    else:
        arrivals = np.zeros(n_requests)
    t0 = time.monotonic()
    requests = [
        Request(i, prompts[i], int(budgets[i]), float(t0 + arrivals[i]))
        for i in range(n_requests)
    ]
    req_log = (
        metrics_lib.RequestLogger(metrics_jsonl) if metrics_jsonl else None
    )
    # The whole trace is this tool's own workload: queue all of it.
    scheduler = ContinuousScheduler(
        engine, max_queue=n_requests, request_logger=req_log,
    )
    layout = (
        f"paged ({engine.pool.num_blocks} blocks x {block_size})" if paged
        else "contiguous"
    )
    if kv_dtype != "bf16":
        layout += f", kv={kv_dtype}"
    if kv_host_mb:
        layout += f" + {kv_host_mb:g} MB host KV tier"
    spec_note = f", spec k={spec_k} ngram={spec_ngram}" if spec_k else ""
    print(
        f"serving started: {n_requests} requests, {num_slots} slots "
        f"({layout}), rate={rate or 'burst'} req/s, "
        f"prefill_chunk={prefill_chunk}{spec_note}"
    )
    # Every tick reads its sampled tokens back to the host, so the trace
    # has finished on the device when run() returns.
    records = scheduler.run(requests)
    elapsed = time.monotonic() - t0
    summary = summarize_records(
        records, elapsed=elapsed,
        queue_depth_samples=scheduler.queue_depth_samples,
        rejected=scheduler.rejected,
        active_slot_samples=scheduler.active_slot_samples,
        engine_stats=engine.stats() if (paged or spec_k) else None,
    )
    if spec_k and summary.get("spec"):
        sp = summary["spec"]
        print(
            f"speculation: acceptance_rate={sp['acceptance_rate']} "
            f"({sp['accepted_tokens']}/{sp['drafted_tokens']} drafted), "
            f"tokens_per_tick={sp['tokens_per_decode_tick']}"
        )
    if paged:
        st = engine.stats()
        hit_rate = (
            st["prefix_hit_tokens"] / st["prefix_lookup_tokens"]
            if st["prefix_lookup_tokens"] else 0.0
        )
        print(
            f"paged pool: prefix_hit_rate={hit_rate:.3f} "
            f"blocks_evicted={st['blocks_evicted']} "
            f"prefill_tokens={st['prefill_tokens_computed']}/"
            f"{st['prefill_tokens_offered']}"
        )
        if kv_host_mb:
            print(
                f"host KV tier: spilled={st.get('blocks_spilled', 0)} "
                f"restored={st.get('blocks_restored', 0)} "
                f"dropped={st.get('host_dropped_blocks', 0)} "
                f"resident={st.get('host_blocks', 0)} blocks"
            )
    metrics_lib.MetricsLogger(None).log({"mode": "serve", **{
        k: v for k, v in summary.items() if not isinstance(v, dict)
    }})
    return {"summary": summary, "engine": engine.stats(), "tokens": tokens}


def build_schedule(lr_schedule: str, learning_rate: float, *,
                   total_steps: int, warmup_steps: int = 0):
    """The learning rate: a float, or a host function of the step count
    (the JAX CLI's optax schedules)."""
    from ..train import optim

    if lr_schedule == "constant":
        return learning_rate
    if lr_schedule == "cosine":
        return optim.cosine_decay_schedule(learning_rate, total_steps)
    if lr_schedule == "warmup-cosine":
        warmup = max(warmup_steps, 1)
        return optim.warmup_cosine_decay_schedule(
            0.0, learning_rate, warmup_steps=warmup,
            decay_steps=max(total_steps, warmup + 1),
        )
    raise SystemExit(f"unknown lr schedule {lr_schedule!r}")


def build_optimizer(name: str, lr, *, weight_decay: float,
                    momentum: float = 0.9, grad_clip: float | None = None):
    """The JAX CLI's optimizer block with optax's semantics
    (``train/optim.py``): ``adam`` is coupled L2 (decay added to the
    gradient before the moments, torch ``Adam(weight_decay=)``), ``adamw``
    decoupled, ``sgd`` coupled L2 then momentum ``buf = m*buf + g``;
    ``grad_clip`` clips by global norm before all of it."""
    from ..train import optim

    if name == "adam":
        tx = optim.chain(optim.add_decayed_weights(weight_decay),
                         optim.scale_by_adam(),
                         optim.scale_by_learning_rate(lr))
    elif name == "adamw":
        tx = optim.adamw(lr, weight_decay=weight_decay)
    elif name == "sgd":
        tx = optim.chain(optim.add_decayed_weights(weight_decay),
                         optim.sgd(lr, momentum=momentum))
    else:
        raise SystemExit(f"unknown optimizer {name!r}")
    if grad_clip is not None:
        tx = optim.chain(optim.clip_by_global_norm(grad_clip), tx)
    return tx


_IMAGE_DATASETS = ("cifar10", "synthetic-images", "shapes")
_IMAGENET_DATASETS = ("imagefolder:", "packed-images:")


def _dataset_kind(dataset: str) -> str:
    """The batches ``--dataset`` provides, before anything is read."""
    if dataset in _IMAGE_DATASETS or dataset.startswith(_IMAGENET_DATASETS):
        return "image_classifier"
    if dataset == "synthetic-tokens" or dataset.startswith("token-file:"):
        return "lm"
    raise SystemExit(f"unknown dataset {dataset!r}")


def _image_datasets(args):
    """(train set, eval set or None, num_classes, input_normalize): the
    JAX CLI's image datasets.  ``input_normalize`` is the (mean, std) the
    step applies on the device to uint8 batches (packed records), else
    None."""
    import os

    from ..data import (
        ImageFolder, PackedImages, ShapeImages, SyntheticImages, cifar10,
    )
    from ..data.transforms import (
        imagenet_eval_transform, imagenet_train_transform,
    )

    if args.dataset == "cifar10":
        ds = cifar10(args.data_dir, train=True, synthetic=args.synthetic_data)
        eval_ds = (cifar10(args.data_dir, train=False,
                           synthetic=args.synthetic_data)
                   if args.do_eval else None)
        return ds, eval_ds, len(ds.classes), None
    if args.dataset == "synthetic-images":
        ds = SyntheticImages(image_size=args.image_size, num_classes=1000)
        eval_ds = (SyntheticImages(n=1000, image_size=args.image_size,
                                   num_classes=1000, seed=1)
                   if args.do_eval else None)
        return ds, eval_ds, 1000, None
    if args.dataset.startswith("imagefolder:"):
        # root/train + root/val; a flat root trains and evaluates on the
        # same images, with a warning.
        root = args.dataset.split(":", 1)[1]
        train_root = eval_root = root
        if os.path.isdir(os.path.join(root, "train")):
            train_root = os.path.join(root, "train")
            eval_root = (os.path.join(root, "val")
                         if os.path.isdir(os.path.join(root, "val"))
                         else train_root)
        ds = ImageFolder(train_root,
                         transform=imagenet_train_transform(args.image_size),
                         seed=args.seed)
        eval_ds = None
        if args.do_eval:
            if eval_root == train_root:
                print("warning: no val/ split found — eval runs on the "
                      "training images (use <root>/train + <root>/val)")
            eval_ds = ImageFolder(
                eval_root, transform=imagenet_eval_transform(args.image_size),
                seed=args.seed)
        return ds, eval_ds, len(ds.classes), None
    if args.dataset.startswith("packed-images:"):
        # uint8 batches from one native call each; ToTensor + Normalize
        # run in the step on the device.  The held-out split is a sibling
        # <path>.eval file.
        path = args.dataset.split(":", 1)[1]
        ds = PackedImages(path, train=True, crop_size=args.image_size,
                          seed=args.seed, output_dtype="uint8")
        eval_ds = None
        if args.do_eval:
            eval_path = path + ".eval"
            if not os.path.exists(eval_path):
                eval_path = path
                print("warning: no .eval packed file found — eval runs on "
                      "the training records (pack a held-out split to "
                      f"{path}.eval)")
            eval_ds = PackedImages(eval_path, train=False,
                                   crop_size=args.image_size, seed=args.seed,
                                   output_dtype="uint8")
        return ds, eval_ds, len(ds.classes), (ds.mean, ds.std)
    # The learnable procedural set: train and eval are disjoint draws.
    ds = ShapeImages(n=50_000, train=True, seed=args.seed)
    eval_ds = (ShapeImages(n=10_000, train=False, seed=args.seed)
               if args.do_eval else None)
    return ds, eval_ds, len(ds.classes), None


def _lm_datasets(dataset: str, *, seq_len: int, vocab: int, do_eval: bool):
    """(train set, eval set or None) for an LM ``--dataset``."""
    from ..data import Subset, SyntheticTokens, TokenFile

    if dataset == "synthetic-tokens":
        # Token range follows the model's embedding table.
        ds = SyntheticTokens(seq_len=seq_len, vocab_size=vocab)
        eval_ds = (SyntheticTokens(n=512, seq_len=seq_len, vocab_size=vocab,
                                   seed=1) if do_eval else None)
        return ds, eval_ds
    import os

    path = dataset.split(":", 1)[1]
    full = TokenFile(path, seq_len=seq_len)
    if not do_eval:
        return full, None
    # A sibling val.bin if present, else the last 5% of windows.
    val_path = os.path.join(os.path.dirname(path), "val.bin")
    if os.path.exists(val_path) and \
            os.path.abspath(val_path) != os.path.abspath(path):
        return full, TokenFile(val_path, seq_len=seq_len)
    n_eval = max(len(full) // 20, 1)
    return (Subset(full, 0, len(full) - n_eval),
            Subset(full, len(full) - n_eval, len(full)))


def run_train(args, overrides: dict, device=None):
    """Train ``args.model`` on ``args.dataset``; prints the JAX CLI's
    milestones and one summary line per epoch (image classifiers add
    ``accuracy``, and ``eval_accuracy`` under ``--eval``).  Returns the
    Trainer.  ``--distributed`` joins the process group first and leaves
    it at the end, whatever happens between."""
    from ..comm import init as comm_init
    from ..utils.device import resolve_device
    from ..utils.seeding import seed_everything

    device = resolve_device(device)
    group = comm_init.initialize(device) if args.distributed else None
    try:
        rank, world = comm_init.process_index(), comm_init.process_count()
        if group is not None:
            print(f"Process group initialized - WORLD_SIZE: {world}, "
                  f"RANK: {rank}")
        print(f"process {rank}/{world} | backend={device.type} | devices=1")
        seed_everything(args.seed)
        return _train(args, overrides, device, group, rank, world)
    finally:
        comm_init.shutdown()


def _train(args, overrides, device, group, rank, world):
    import itertools

    from ..data import DataLoader, DataLoaderConfig
    from ..data.loader import to_device
    from ..models import create_model, model_kind
    from ..train import (
        Trainer, TrainerConfig, create_train_state, make_eval_step,
        make_policy, make_train_step,
    )
    from ..utils import metrics as metrics_lib

    kind = _dataset_kind(args.dataset)
    m_kind = model_kind(args.model)
    if m_kind != kind:
        raise SystemExit(
            f"--model {args.model} is a {m_kind!r} model but --dataset "
            f"{args.dataset} provides {kind!r} batches; pick a matching pair "
            "(e.g. gpt2 with synthetic-tokens, resnet50 with "
            "cifar10/synthetic-images)"
        )
    if args.ce_chunk is not None and kind != "lm":
        raise SystemExit("--ce-chunk applies to LM models (--model gpt2*)")
    if args.remat:
        overrides["remat"] = True
    input_normalize = image_size = None
    if kind == "lm":
        num_classes = None
        ds, eval_ds = _lm_datasets(
            args.dataset, seq_len=args.seq_len,
            vocab=int(overrides.get("vocab_size", 50257)),
            do_eval=args.do_eval)
    else:
        ds, eval_ds, num_classes, input_normalize = _image_datasets(args)
        if args.model.startswith("vit"):
            # A ViT's position table is sized from the images it will
            # see: the crop side of the ImageNet-format sets, else the
            # stored side (CIFAR-10, shapes).
            image_size = (args.image_size if args.dataset.startswith(
                ("synthetic-images", "imagefolder:", "packed-images:"))
                else int(ds[0]["image"].shape[0]))
    if args.batch_size % (args.accum_steps * world):
        raise SystemExit(
            f"--batch-size {args.batch_size} must divide into "
            f"--accum-steps {args.accum_steps} microbatches x {world} "
            "processes")
    loader = DataLoader(ds, DataLoaderConfig(
        batch_size=args.batch_size, num_workers=args.num_workers,
        seed=args.seed,
    ), shard_index=rank, num_shards=world,
        num_microbatches=args.accum_steps)
    policy = make_policy(args.precision)
    net = create_model(args.model, num_classes=num_classes,
                       dtype=policy.param_dtype, device=device,
                       seed=args.seed, cfg_overrides=overrides,
                       image_size=image_size)
    total_steps = args.total_steps
    if total_steps is None:
        per_epoch = args.steps_per_epoch if args.steps_per_epoch is not None \
            else max(len(ds) // args.batch_size, 1)
        total_steps = max(args.epochs * per_epoch, 1)
    lr = build_schedule(args.lr_schedule, args.learning_rate,
                        total_steps=total_steps,
                        warmup_steps=args.warmup_steps)
    tx = build_optimizer(args.optimizer, lr, weight_decay=args.weight_decay,
                         momentum=args.momentum, grad_clip=args.grad_clip)
    state = create_train_state(net, tx, policy=policy, process_group=group)
    step_fn = make_train_step(
        kind=kind, policy=policy, num_microbatches=args.accum_steps,
        seed=args.seed + 1, label_smoothing=args.label_smoothing,
        lm_loss_chunk=args.ce_chunk, input_normalize=input_normalize,
        process_group=group,
    )
    trainer = Trainer(state, step_fn, device, TrainerConfig())
    logger = metrics_lib.MetricsLogger(args.metrics_jsonl)
    eval_loader = eval_step = None
    if eval_ds is not None:
        eval_bs = min(args.batch_size, len(eval_ds))
        eval_loader = DataLoader(eval_ds, DataLoaderConfig(
            batch_size=eval_bs, num_workers=0, shuffle=False))
        # LM eval always chunks the CE: the eval batch is not split by
        # --accum-steps, so its full logits could outgrow a config whose
        # train step fits.
        eval_step = make_eval_step(kind=kind, policy=policy,
                                   lm_loss_chunk=args.ce_chunk or 256,
                                   input_normalize=input_normalize)

    print("training started")
    t0 = time.perf_counter()
    try:
        for epoch in range(args.epochs):
            loader.set_epoch(epoch)
            batches = iter(loader)
            if args.steps_per_epoch is not None:
                batches = itertools.islice(batches, args.steps_per_epoch)
            logger.log(trainer.run_epoch(batches, epoch=epoch))
            if eval_loader is None:
                continue
            batches = iter(eval_loader)
            if args.eval_steps is not None:
                batches = itertools.islice(batches, args.eval_steps)
            totals: dict = {}
            n_batches = 0
            for b in batches:
                for k, v in eval_step(trainer.state,
                                      to_device(b, device)).items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                n_batches += 1
            if n_batches:
                logger.log({"epoch": epoch, **{
                    f"eval_{k}": v / n_batches for k, v in totals.items()}})
    finally:
        loader.close()
    elapsed = time.perf_counter() - t0
    print("training finished")
    print(f"elapsed time: {elapsed:.2f}s")
    return trainer


def main(argv: list[str] | None = None):
    args = build_parser().parse_args(argv)
    from ..models import model_kind

    try:
        overrides = _parse_overrides(args.model_overrides)
        model_kind(args.model)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.remat and args.model.startswith("resnet"):
        raise SystemExit(
            "--remat applies to transformer models (gpt2*, vit_*); ResNet's "
            "fused-BN path already minimizes saved activations"
        )
    if args.serve and args.distributed:
        raise SystemExit("--distributed applies to training")
    if not args.serve:
        return run_train(args, overrides,
                         device="cpu" if args.use_cpu else None)
    if model_kind(args.model) != "lm":
        raise SystemExit("--serve requires a transformer LM (--model gpt2*)")
    return run_serve(
        model=args.model, overrides=overrides, precision=args.precision,
        seed=args.seed, seq_len=args.seq_len,
        metrics_jsonl=args.metrics_jsonl, n_requests=args.serve_requests,
        rate=args.serve_rate, num_slots=args.serve_slots,
        max_new=args.serve_max_new, prefill_chunk=args.serve_prefill_chunk,
        spec_k=args.serve_spec_k if args.serve_spec else 0,
        spec_ngram=args.serve_spec_ngram,
        device="cpu" if args.use_cpu else None,
        paged=args.serve_paged, block_size=args.serve_block_size,
        num_blocks=args.serve_num_blocks, kv_dtype=args.serve_kv_dtype,
        kv_host_mb=args.serve_kv_host_mb,
    )


if __name__ == "__main__":
    main(sys.argv[1:])
