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
[--serve-kv-dtype int8] [--serve-kv-host-mb 64]`` for the paged KV pool,
``--serve-disagg P:D`` for prefill- and decode-role pools,
``--serve-replicas N [--no-serve-affinity]`` for a router over N
replicas, ``--serve-ttl S`` for deadlines; ``--serve-tp N`` under a
torchrun world of N serves tensor-parallel);

    python -m pytorch_distributed_training_tpu_torch.cli.main \
        --model vit_b16 --dataset packed-images:train.pck --image-size 224 \
        --precision bf16 --batch-size 128 --optimizer adamw \
        --learning-rate 5e-4 --weight-decay 0.05 --grad-clip 1.0

trains ViT-B/16 on packed ImageNet-format records (``imagefolder:<root>``
reads a class-folder tree instead).

    python -m torch.distributed.run --nproc_per_node 2 \
        -m pytorch_distributed_training_tpu_torch.cli.main --distributed ...

trains data-parallel, one process per GPU (``--use-cpu``: gloo on the
host); ``--batch-size`` stays global.  Several hosts join one group through
torchrun's static rendezvous (``--nnodes N --node_rank r --master_addr A
--master_port P``).  ``--grad-sync hier|hier-bf16|hier-int8|hier-int4|
hier-topk`` replaces the one gradient all-reduce with the two-tier sync
(reduce-scatter within a node, the compressed shards across nodes,
all-gather within a node; ``comm/hierarchical.py``), over the nodes of
the launch or ``--grad-sync-slices S``, with ``--grad-sync-bucket-mb``,
``--grad-sync-topk-frac``, ``--grad-sync-stripe`` and
``--grad-sync-overlap``.

``--checkpoint-dir D`` saves a checkpoint at each epoch's end (rank 0
writes; ``--ckpt-every-steps N`` adds async step checkpoints) and makes
SIGTERM commit a synchronous checkpoint at the next step boundary and
exit 75; ``--resume`` continues from the newest verified step, skipping
the batches its epoch already consumed; ``--elastic [--max-restarts N
--heartbeat-timeout S]`` runs the command under the supervisor, which
relaunches it with ``--resume`` after a crash, hang or preemption;
``--inject-faults crash@N,stall@N:S,sigterm@N,ckpt_truncate@N`` tests all
of it.  ``--serve --checkpoint-dir D`` serves the trained parameters.

``--device-cache`` keeps the training set on the device (uint8 images:
cifar10, synthetic-images, shapes, packed-images; or a ``token-file:``
stream) and assembles every batch there, with no host-to-device copy a
step.  ``--skip-bad-steps [--grad-spike-threshold G]`` puts the update
behind the skip gate (a non-finite or spiking step leaves the state as it
was), rolls back to a host snapshot after ``--rollback-after`` bad steps
in a row and aborts (nonzero, for ``--elastic`` to relaunch) after
``--max-rollbacks``; ``--inject-faults nan_batch@N,spike_batch@N:F``
tests it.

Sharded training over the process group (``--distributed``): ``--fsdp
N`` shards parameters and optimizer slots over an ``fsdp`` axis (ZeRO-3),
``--tensor-parallel N`` splits the transformer blocks Megatron-style,
``--zero1`` shards the optimizer slots over ``data``, and
``--sequence-parallel N [--sequence-parallel-mode ring|ulysses]`` splits
each sequence over a ``sequence`` axis; ``data`` takes the rest of the
world.  Each run prints JAX's ``mesh: {...}`` line; the combinations JAX
refuses are refused with its messages (exit 2).

Pipeline parallelism (GPT-2, ``--distributed``): ``--pipeline-parallel
S [--pipeline-schedule gpipe|1f1b|interleaved] [--pipeline-microbatches
M] [--pipeline-chunks V] [--pp-compress none|bf16|int8]`` splits the
block stack into S stages over a ``pipeline`` axis
(``parallel/gpt2_pipeline.py``); ``--remat`` checkpoints GPipe's ticks,
``--grad-sync-stripe`` stripes the compressed stage hops, and the run
names the stages and the schedule in its summaries.  ``data`` takes the
rest of the world, and ``--fsdp``, ``--tensor-parallel`` and ring
``--sequence-parallel`` (GPipe) compose with it as in JAX.

Telemetry (``obs/``): ``--metrics-dir D [--log-format jsonl|tsv]``
writes each process's event log ``D/events.rank0000N.jsonl`` — JAX's
schema v4: per-step records with their counter deltas (the analytic DCN
and stage-boundary bytes), the ``grad_sync_model`` and
``pp_compress_model`` records, a ``compiled_cost`` event (the step's
FLOPs counted on ``meta`` tensors, the first step's collective census
and the allocator's peaks), flight-recorder anomalies and a closing
summary, which the repo's ``tools/telemetry_report.py`` and
``tools/trace_export.py`` read; ``--trace [--trace-sample-rate R]`` adds
request and step spans; ``--goodput`` the training goodput ledger;
``--slo SPEC`` burn-rate alerts and ``--metrics-port P [--healthz-stale-s
S]`` the ``/metrics``, ``/healthz`` and ``/slo`` endpoint on 127.0.0.1
(port 0: an ephemeral one, printed); ``--profile-dir D [--profile-steps
START:STOP]`` a ``torch.profiler`` Chrome trace of a global-step window
or of the first epoch.  The JAX CLI's refusals of these flags are usage
errors (exit 2) with its messages.

Elastic resizing (``--elastic-resize SPEC``, ``resilience/elastic.py``):

    python -m torch.distributed.run --nproc_per_node 4 \\
        -m pytorch_distributed_training_tpu_torch.cli.main --distributed \\
        --use-cpu --elastic-resize slice_lost@4:1,slice_return@9

runs JAX's scripted episode over the world's ranks, read as 2 slices of
consecutive ranks: the lost slice's heartbeats stop, the survivors
restore the peer snapshot and shrink, and the slice grows back; rank 0
prints JAX's ``elastic:`` lines.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


GRAD_SYNC_CHOICES = ("flat", "hier", "hier-bf16", "hier-int8", "hier-int4",
                     "hier-topk")


def _check_grad_sync(parser: argparse.ArgumentParser, args) -> None:
    """The JAX CLI's flag checks of --grad-sync and its companions, as
    usage errors (exit 2), before anything is built.  Parses the stripe
    and the bucket size in place."""
    if args.pp_compress != "none" and args.pipeline_parallel <= 1:
        parser.error(
            "--pp-compress compresses pipeline stage-boundary payloads; "
            "it needs --pipeline-parallel > 1")
    flat = args.grad_sync == "flat"
    if flat and args.grad_sync_slices is not None:
        parser.error(
            "--grad-sync-slices only affects the explicit two-tier sync; "
            "pass --grad-sync hier|hier-bf16|hier-int8|hier-int4|hier-topk "
            "with it (the flat all-reduce has no slice parameter to "
            "simulate)")
    if flat and args.pp_compress == "none" \
            and str(args.grad_sync_stripe) != "off":
        parser.error(
            "--grad-sync-stripe lanes the explicit two-tier sync's DCN hop "
            "(and --pp-compress stage boundaries); the flat all-reduce has "
            "no DCN hop to stripe — pass a --grad-sync mode or "
            "--pp-compress with it")
    if flat and args.grad_sync_overlap != "off":
        parser.error(
            "--grad-sync-overlap pipelines the explicit two-tier sync's "
            "ICI/DCN phases across buckets; the flat all-reduce has no "
            "phases to pipeline — pass a --grad-sync mode with it")
    if str(args.grad_sync_stripe) not in ("auto", "off"):
        try:
            args.grad_sync_stripe = int(args.grad_sync_stripe)
        except ValueError:
            parser.error(f"--grad-sync-stripe must be 'auto', 'off', or a "
                         f"lane count, got {args.grad_sync_stripe!r}")
        if args.grad_sync_stripe < 1:
            parser.error(f"--grad-sync-stripe must be >= 1, got "
                         f"{args.grad_sync_stripe}")
    if flat and str(args.grad_sync_bucket_mb) != "auto":
        parser.error(
            "--grad-sync-bucket-mb sizes the explicit two-tier sync's "
            "buckets; the flat all-reduce has none — pass a --grad-sync "
            "mode with it")
    if str(args.grad_sync_bucket_mb) != "auto":
        try:
            args.grad_sync_bucket_mb = float(args.grad_sync_bucket_mb)
        except ValueError:
            parser.error(f"--grad-sync-bucket-mb must be 'auto' or a number "
                         f"(MB), got {args.grad_sync_bucket_mb!r}")
        if args.grad_sync_bucket_mb <= 0:
            parser.error(f"--grad-sync-bucket-mb must be > 0, got "
                         f"{args.grad_sync_bucket_mb}")
    if not flat and not args.distributed:
        parser.error(
            f"--grad-sync {args.grad_sync} syncs the gradients of a "
            "data-parallel group: it needs --distributed over more than one "
            "process (torchrun)")


def _check_sharding(parser: argparse.ArgumentParser, args) -> None:
    """JAX's refusals of the sharding flags that need no model (the
    head-count checks come with the model, ``_sharding``)."""
    from ..models import model_kind

    if args.zero1 and args.fsdp > 1:
        parser.error(
            "--zero1 shards optimizer slots over the data axis; with "
            "--fsdp the slots are already sharded (ZeRO-3) — pick one")
    if args.zero1 and (args.tensor_parallel > 1
                       or args.pipeline_parallel > 1):
        parser.error(
            "--zero1 composes with data parallelism only (not "
            "--tensor-parallel/--pipeline-parallel, whose rules already "
            "shard the optimizer slots over their axes)")
    if args.grad_sync != "flat" and (
            args.fsdp > 1 or args.tensor_parallel > 1
            or args.pipeline_parallel > 1 or args.sequence_parallel > 1):
        parser.error(
            f"--grad-sync {args.grad_sync} composes with data parallelism "
            "only (not --fsdp/--tensor-parallel/--pipeline-parallel/"
            "--sequence-parallel)")
    if args.sequence_parallel > 1:
        try:
            lm = model_kind(args.model) == "lm"
        except ValueError:
            lm = True   # the unknown model is reported later
        if not lm:
            parser.error(
                "--sequence-parallel requires a transformer LM (--model "
                "gpt2)")
        if args.pipeline_parallel > 1 and (
                args.pipeline_schedule != "gpipe"
                or args.sequence_parallel_mode != "ring"):
            parser.error(
                "--sequence-parallel composes with --pipeline-parallel "
                "only as ring SP under --pipeline-schedule gpipe (the "
                "branch-free tick loop; collectives inside the manual "
                "schedules' cond-gated stage bodies are unsound — see "
                "parallel/gpt2_pipeline.py)")
        if args.seq_len % args.sequence_parallel:
            parser.error(
                f"--seq-len {args.seq_len} not divisible by "
                f"--sequence-parallel {args.sequence_parallel}")
    if args.pipeline_parallel > 1:
        _check_pipeline(parser, args)


def _check_pipeline(parser: argparse.ArgumentParser, args) -> None:
    """JAX's refusals under --pipeline-parallel that need no model (the
    layer and embedding checks come with it, ``_pipelined``)."""
    from ..models import model_kind

    try:
        lm = model_kind(args.model) == "lm"
    except ValueError:
        lm = True   # the unknown model is reported later
    if not lm:
        parser.error(
            "--pipeline-parallel requires a transformer LM (--model gpt2)")
    if args.fsdp > 1 and args.tensor_parallel > 1:
        parser.error(
            "--fsdp and --tensor-parallel do not combine under "
            "--pipeline-parallel (both split the same matmul dims)")
    if args.ce_chunk is not None:
        parser.error(
            "--ce-chunk is not wired through the pipelined model "
            "(PipelinedGPT2 has no hidden-state output)")
    if args.accum_steps > 1 and args.pipeline_schedule != "gpipe":
        parser.error(
            "--accum-steps does not compose with --pipeline-schedule "
            f"{args.pipeline_schedule} (the schedule owns microbatching; "
            "size --pipeline-microbatches instead)")


def _sharded(args) -> bool:
    return (args.fsdp > 1 or args.tensor_parallel > 1 or args.zero1
            or args.sequence_parallel > 1 or args.pipeline_parallel > 1)


def _sharding(args, net, world: int):
    """The mesh (JAX's ``MeshConfig(data=-1, fsdp, tensor, pipeline,
    sequence)`` over the world) and, for a sharded run, the rules, the
    slot rules and the head-count refusals JAX makes."""
    from ..comm.mesh import MeshConfig, make_mesh
    from ..parallel.sharding import DDP_RULES, ZERO1_OPT_RULES, tp_rules_for

    heads = getattr(getattr(net, "cfg", None), "num_heads", None)
    tp, sp = args.tensor_parallel, args.sequence_parallel
    if tp > 1 and heads is not None and heads % tp:
        build_parser().error(
            f"--tensor-parallel {tp} needs heads ({heads}) divisible by it "
            "(the SP attention shards heads over the tensor axis)")
    if sp > 1 and args.sequence_parallel_mode == "ulysses" \
            and (heads // tp) % sp:
        build_parser().error(
            f"--sequence-parallel-mode ulysses needs per-tensor-shard "
            f"heads ({heads // tp}) divisible by --sequence-parallel {sp}; "
            "use ring for this head count")
    try:
        mesh = make_mesh(MeshConfig(
            data=-1, fsdp=args.fsdp, tensor=tp,
            pipeline=args.pipeline_parallel, sequence=sp), world=world)
    except ValueError as e:
        raise SystemExit(f"mesh: {e}") from None
    print(f"mesh: {dict(mesh.shape)}")
    rules = (tp_rules_for(args.model) if args.fsdp > 1 or tp > 1
             else DDP_RULES)
    return mesh, rules, ZERO1_OPT_RULES if args.zero1 else None


def _pipelined(args, net, mesh, policy):
    """``--pipeline-parallel``: the pipelined GPT-2 of ``net``'s config and
    weights (JAX's ``PipelinedGPT2``), its refusals as usage errors."""
    from ..comm.striping import resolve_channel_stripe
    from ..parallel.gpt2_pipeline import pipelined_gpt2

    try:
        return pipelined_gpt2(
            net, mesh,
            num_microbatches=(args.pipeline_microbatches
                              or 2 * args.pipeline_parallel),
            compute_dtype=policy.compute_dtype,
            # --remat maps to the per-tick checkpoint: the stage body
            # calls the blocks directly, past GPT2Config.remat.
            remat_ticks=args.remat, schedule=args.pipeline_schedule,
            num_chunks=args.pipeline_chunks, pp_compress=args.pp_compress,
            pp_stripe=resolve_channel_stripe(args.grad_sync_stripe))
    except ValueError as e:
        build_parser().error(str(e))


def _check_telemetry(parser: argparse.ArgumentParser, args) -> None:
    """The JAX CLI's refusals of the telemetry flags, as usage errors
    (exit 2) with its messages, before anything is built.  Parses
    ``--profile-steps`` into ``args.profile_window``."""
    args.profile_window = None
    if args.profile_steps is not None:
        if not args.profile_dir:
            parser.error("--profile-steps requires --profile-dir")
        lo, sep, hi = args.profile_steps.partition(":")
        try:
            window = (int(lo), int(hi))
        except ValueError:
            parser.error(f"--profile-steps must be START:STOP, got "
                         f"{args.profile_steps!r}")
        if not sep or window[0] < 0 or window[1] <= window[0]:
            parser.error(f"--profile-steps window must satisfy 0 <= START "
                         f"< STOP, got {args.profile_steps!r}")
        args.profile_window = window
    if args.trace:
        if not args.metrics_dir:
            parser.error("--trace records span events into the "
                         "--metrics-dir log; pass --metrics-dir")
        if args.log_format != "jsonl":
            parser.error("--trace needs --log-format jsonl (the exporter "
                         "and the TTFT decomposition read spans back)")
    if args.goodput:
        if args.serve:
            parser.error("--goodput attributes a TRAINING run's wall "
                         "clock; serving goodput is the --slo plane's job")
        if not args.metrics_dir:
            parser.error("--goodput writes the goodput_ledger record into "
                         "the --metrics-dir log; pass --metrics-dir")
    if args.slo is not None or args.metrics_port is not None:
        if not args.metrics_dir:
            parser.error("--slo/--metrics-port aggregate the telemetry "
                         "spine live; pass --metrics-dir")
        from ..obs import parse_slo_spec

        try:
            if args.slo:
                parse_slo_spec(args.slo)
        except ValueError as e:
            parser.error(f"--slo: {e}")


class _Telemetry:
    """The telemetry of one run, as the JAX CLI builds it: the emitter
    (disabled without ``--metrics-dir``, so every wiring point threads
    one object), the span recorder (``--trace``), the goodput ledger
    (``--goodput``; its restart watermark in ``<checkpoint-dir>/
    .progress``), and the live aggregator, SLO policy and ops endpoint
    (``--slo`` / ``--metrics-port``), teed from the same emitter."""

    def __init__(self, args, *, rank: int, world: int, device, mode: str):
        import os

        from ..obs import MetricsEmitter

        self.emitter = MetricsEmitter(
            args.metrics_dir, rank=rank, world=world,
            log_format=args.log_format, meta={
                "mode": mode, "model": args.model, "dataset": args.dataset,
                "precision": args.precision, "batch_size": args.batch_size,
                "accum_steps": args.accum_steps, "grad_sync": args.grad_sync,
                "backend": "gpu" if device.type == "cuda" else "cpu",
            })
        self.spans = self.ledger = self.live = self.slo = self.server = None
        self._closed = False
        if args.trace:
            from ..obs import SpanRecorder

            self.spans = SpanRecorder(self.emitter,
                                      sample_rate=args.trace_sample_rate)
        if args.goodput:
            from ..obs import GoodputLedger

            self.ledger = GoodputLedger(
                clock=self.emitter.clock,
                progress_path=(os.path.join(args.checkpoint_dir, ".progress")
                               if args.checkpoint_dir else None))
        if args.slo is not None or args.metrics_port is not None:
            from ..obs import (
                LiveAggregator, OpsServer, SLOPolicy, parse_slo_spec,
            )

            self.live = LiveAggregator(clock=self.emitter.clock)
            self.slo = SLOPolicy(
                self.live, parse_slo_spec(args.slo) if args.slo else [],
                emitter=self.emitter)
            self.emitter.attach_sink(self.live)
            self.emitter.attach_sink(self.slo)   # anomaly -> alert
            if args.metrics_port is not None:
                # Ranks of one host (torchrun) each take their own port:
                # the given one plus the local rank, or an ephemeral one.
                port = args.metrics_port and args.metrics_port + int(
                    os.environ.get("LOCAL_RANK", 0))
                self.server = OpsServer(
                    self.live, self.slo, port=port,
                    stale_after_s=args.healthz_stale_s,
                    ledger=self.ledger).start()
                print(f"ops endpoint: {self.server.url} (/metrics /healthz "
                      "/slo)", flush=True)

    @property
    def live_emitter(self):
        return self.emitter if self.emitter.enabled else None

    def bracket(self, category: str):
        import contextlib

        return (self.ledger.bracket(category) if self.ledger is not None
                else contextlib.nullcontext())

    def close(self, **summary) -> None:
        """Every exit path: stop the endpoint, print the alert summary,
        flush the spans, freeze the ledger (its gauges and record come
        before the summary, from one snapshot), write the summary and
        close the log.  Once: later calls do nothing."""
        if self._closed:
            return
        self._closed = True
        if self.server is not None:
            self.server.stop()
        if self.slo is not None and self.slo.alert_log:
            red = self.slo.snapshot()["alerts"]
            print(f"slo: {red['transitions']} alert transition(s), "
                  f"{red['anomaly_alerts']['count']} promoted anomaly "
                  f"alert(s); active: {self.slo.active_alerts or 'none'}")
        if self.spans is not None:
            self.spans.close()
        if self.ledger is not None:
            snap = self.ledger.finalize(self.emitter)
            print(f"goodput: {snap['goodput_fraction']:.4f} over "
                  f"{snap['wall_s']:.2f}s wall (identity "
                  f"{'ok' if snap['identity_ok'] else 'BROKEN'})")
        self.emitter.summary(**summary)
        self.emitter.close()


def _emit_models(tel: _Telemetry, args, state, mesh, grad_sync, net,
                 policy) -> None:
    """The JAX CLI's byte-model records and per-step counters: the DCN
    bytes of the gradient sync (``dcn_model_unavailable`` where the flat
    model does not cover the layout: recorded, and the run trains on),
    the stage-boundary bytes under ``--pipeline-parallel`` with the
    ``pp_compress_model`` record, and the ``grad_sync_model`` record with
    the wall model, whose per-step quota the goodput ledger splits off
    as ``grad_sync``."""
    import torch

    from ..obs import (
        dcn_step_counters, grad_sync_wall_model, pp_step_counters,
    )

    emitter = tel.emitter
    counters: dict = {}
    try:
        params = state.params
        if state.shardings is not None:
            params = {n: state.shardings.params[n].shape for n in params}
        counters.update(dcn_step_counters(
            grad_sync=grad_sync, mesh=mesh, params=params,
            num_microbatches=args.accum_steps))
    except ValueError as e:
        emitter.emit("record", {"record": "dcn_model_unavailable",
                                "error": str(e)})
    if args.pipeline_parallel > 1:
        fields = dict(
            schedule=args.pipeline_schedule,
            num_stages=args.pipeline_parallel,
            num_microbatches=net.num_microbatches,
            microbatch_rows=args.batch_size // net.num_microbatches,
            seq_len=args.seq_len,
            hidden=net.cfg.hidden_dim,
            act_itemsize=torch.empty(
                (), dtype=policy.compute_dtype).element_size(),
            mode=args.pp_compress,
            num_chunks=(args.pipeline_chunks
                        if args.pipeline_schedule == "interleaved" else 1))
        pp = pp_step_counters(**fields)
        counters.update(pp)
        emitter.emit("record", {
            "record": "pp_compress_model", **fields,
            "pp_boundary_bytes_per_step": pp["pp_boundary_bytes"]})
    emitter.set_step_counters(counters)
    if grad_sync is None:
        return
    wall = grad_sync_wall_model(
        ici_bytes=grad_sync.ici_bytes_per_sync(),
        dcn_bytes=grad_sync.dcn_bytes_per_sync(),
        n_buckets=grad_sync.layout.n_buckets, n_slices=grad_sync.n_slices,
        ici_size=grad_sync.ici_size, stripe=grad_sync.stripe,
        phase_overlap=grad_sync.phase_overlap)
    syncs = grad_sync.syncs_per_step(args.accum_steps)
    emitter.emit("record", {
        "record": "grad_sync_model", "mode": args.grad_sync,
        "dcn_bytes_per_sync": grad_sync.dcn_bytes_per_sync(),
        "ici_bytes_per_sync": grad_sync.ici_bytes_per_sync(),
        "n_elems_padded": grad_sync.layout.padded,
        "n_slices": grad_sync.n_slices, "ici": grad_sync.ici_size,
        "n_buckets": grad_sync.layout.n_buckets,
        "topk_frac": grad_sync.config.topk_frac,
        "bucket_mb": grad_sync.bucket_mb,
        "bucket_policy": grad_sync.bucket_policy,
        "syncs_per_step": syncs, "stripe": grad_sync.stripe,
        "phase_overlap": grad_sync.phase_overlap,
        "overlap_depth": grad_sync.overlap_depth,
        "wall_serial_s": wall["wall_serial_s"],
        "wall_overlap_s": wall["wall_overlap_s"], "wall_s": wall["wall_s"],
        "bubble_s": wall["bubble_s"], "overlap_ratio": wall["overlap_ratio"],
    })
    if tel.ledger is not None:
        u, v = wall["ici_per_bucket_s"], wall["dcn_per_bucket_s"]
        share = u / (u + v) if (u + v) > 0 else 0.0
        tel.ledger.set_grad_sync_model(
            wall["wall_s"] * syncs, ici_share=share, model={
                "mode": args.grad_sync, "wall_s_per_sync": wall["wall_s"],
                "syncs_per_step": syncs,
                "per_step_s": wall["wall_s"] * syncs, "ici_share": share})


def _probe_step_cost(trainer, batches, *, kind, policy, args,
                     input_normalize):
    """The ``compiled_cost`` probe on the first batch: the step's FLOPs
    counted on ``meta`` tensors (``obs.count_step_flops``: no launch, no
    state, RNG or batch-order change) and the card's peak, left on the
    trainer, which adds the first step's census and memory and emits it.
    The peeked batch is chained back.  Accounting never fails the run:
    an error is recorded in the event instead, as in JAX."""
    import itertools

    import torch

    from ..obs import count_step_flops, peak_flops_for
    from ..train import step_objective

    batches = iter(batches)
    first = next(batches, None)
    if first is None:
        return batches
    try:
        loss_fn = step_objective(
            trainer.state, kind=kind, policy=policy,
            lm_loss_chunk=args.ce_chunk,
            label_smoothing=args.label_smoothing,
            input_normalize=input_normalize)
        flops = count_step_flops(loss_fn, trainer.state.params, {
            k: torch.as_tensor(v) for k, v in first.items()})
        trainer.cost_report = {
            "flops": flops,
            "peak_flops": (peak_flops_for()
                           if trainer.device.type == "cuda" else None)}
    except Exception as e:   # never fail the run for accounting
        trainer.cost_report = {"error": str(e)}
    return itertools.chain([first], batches)


def _build_grad_sync(args, state, group):
    """The ``GradSync`` of ``--grad-sync`` (None for ``flat``), its
    refusals as usage errors, and JAX's ``grad-sync:`` line."""
    import dataclasses

    from ..comm import GradSync, GradSyncConfig

    if args.grad_sync == "flat":
        return state, None
    try:
        sync = GradSync(group, state.params, GradSyncConfig(
            mode=args.grad_sync, n_slices=args.grad_sync_slices,
            zero1=args.zero1,
            bucket_mb=args.grad_sync_bucket_mb,
            topk_frac=args.grad_sync_topk_frac, stripe=args.grad_sync_stripe,
            phase_overlap=args.grad_sync_overlap == "on"))
    except ValueError as e:
        build_parser().error(f"--grad-sync {args.grad_sync}: {e}")
    print(f"grad-sync: {args.grad_sync} over {sync.n_slices} slice(s) x "
          f"{sync.ici_size} ici, {sync.layout.n_buckets} bucket(s) of "
          f"{sync.bucket_mb} MB ({sync.bucket_policy}), stripe={sync.stripe} "
          f"overlap={'on' if sync.phase_overlap else 'off'}", flush=True)
    return dataclasses.replace(
        state, grad_sync_residual=sync.init_residual()), sync


# Config fields that take a string (JAX CLI's ``_STRING_OVERRIDE_KEYS``).
_STRING_OVERRIDE_KEYS = frozenset({"moe_dispatch"})


def _parse_overrides(text: str | None) -> dict:
    """``"num_layers=2,hidden_dim=64"`` → dict of int/float/bool values
    (strings for ``_STRING_OVERRIDE_KEYS``)."""
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
                if k not in _STRING_OVERRIDE_KEYS:
                    raise ValueError(
                        f"--model-overrides value for {k!r} must be "
                        f"int/float/bool, got {v!r}"
                    ) from None
                overrides[k] = v
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
    p.add_argument("--grad-sync", default="flat", choices=GRAD_SYNC_CHOICES,
                   help="Gradient all-reduce strategy (comm/hierarchical.py)."
                        " flat: the one all-reduce of --distributed. hier: "
                        "the two-tier sync: reduce-scatter within a node, "
                        "all-reduce of the 1/L shards across nodes, "
                        "all-gather within a node, once per microbatch of "
                        "--accum-steps. hier-bf16/hier-int8/hier-int4 "
                        "compress the cross-node hop (per-bucket scales and "
                        "error-feedback residuals for the lossy ones); "
                        "hier-topk sends the top --grad-sync-topk-frac of "
                        "each bucket by magnitude. Needs --distributed.")
    p.add_argument("--grad-sync-slices", type=int, default=None,
                   help="Override the detected slice (node) count for "
                        "--grad-sync, to simulate several nodes; slices are "
                        "consecutive ranks.")
    p.add_argument("--grad-sync-bucket-mb", default="auto",
                   help="Gradient bucket size for --grad-sync: 'auto' "
                        "derives it from the inter-node link's latency x "
                        "bandwidth crossover per compression mode "
                        "(comm.compress.auto_bucket_mb), or a number in MB "
                        "of f32 gradient.")
    p.add_argument("--grad-sync-topk-frac", type=float, default=0.1,
                   help="Transmitted fraction per bucket under --grad-sync "
                        "hier-topk.")
    p.add_argument("--grad-sync-stripe", default="off",
                   help="Multi-path striping of the --grad-sync cross-node "
                        "hop (comm/striping.py): 'auto' uses min(ranks a "
                        "node, 4) lanes' links, 'off' one, or a lane count. "
                        "Bitwise the same gradients. Also stripes the "
                        "--pp-compress stage-boundary hops.")
    p.add_argument("--grad-sync-overlap", default="off", choices=("on", "off"),
                   help="Pipeline the --grad-sync phases over the buckets "
                        "(bucket i's cross-node all-reduce beside bucket "
                        "i+1's reduce-scatter and bucket i-1's all-gather). "
                        "Bitwise the same gradients.")
    p.add_argument("--fsdp", type=int, default=1,
                   help="FSDP mesh axis size.")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="TP mesh axis size.")
    p.add_argument("--sequence-parallel", type=int, default=1,
                   help="Sequence-parallel attention shards (LM models).")
    p.add_argument("--sequence-parallel-mode", default="ring",
                   choices=("ring", "ulysses"),
                   help="SP decomposition: ring (K/V rotation, any head "
                        "count) or ulysses (all-to-all head resharding, "
                        "needs heads divisible by shards).")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 weight-update sharding (arXiv:2004.13336): "
                        "params stay replicated but optimizer slots and "
                        "the update math shard over the data axis.")
    p.add_argument("--pipeline-parallel", type=int, default=1,
                   help="Pipeline stages (GPT-2 only).")
    p.add_argument("--pipeline-schedule", default="gpipe",
                   choices=("gpipe", "1f1b", "interleaved"),
                   help="gpipe (autograd backward) | 1f1b (forward/backward "
                        "interleaving: live activations bounded by stages, "
                        "not microbatches; per-stage recompute is built in, "
                        "so --remat adds nothing) | interleaved (multi-chunk "
                        "1F1B: --pipeline-chunks model chunks per stage "
                        "divide the bubble by ~V). Microbatching belongs to "
                        "--pipeline-microbatches, not --accum-steps.")
    p.add_argument("--pipeline-microbatches", type=int, default=None,
                   help="Microbatches per pipeline step (default 2x "
                        "stages).")
    p.add_argument("--pipeline-chunks", type=int, default=2,
                   help="Model chunks per stage (interleaved schedule "
                        "only).")
    p.add_argument("--pp-compress", default="none",
                   choices=("none", "bf16", "int8"),
                   help="Compress the pipeline stage-boundary hops "
                        "(--pipeline-parallel): bf16 halves them; int8 "
                        "quarters them with per-token scales and "
                        "error-feedback residuals carried through the tick "
                        "loop (comm/compress.py). All three schedules.")
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
    # --- telemetry (obs/; the JAX CLI's flags and defaults) ---
    p.add_argument("--metrics-dir", default=None,
                   help="Telemetry spine (obs/): write this process's "
                        "schema-versioned structured event log "
                        "(events.rank*.jsonl) here — per-step records with "
                        "counter deltas (analytic DCN bytes under "
                        "--grad-sync), phase/heartbeat/anomaly "
                        "flight-recorder events, a compiled-cost record "
                        "(the step's FLOPs counted on meta tensors, the "
                        "first step's collective census and peak memory), "
                        "and a closing summary.  Every process writes its "
                        "own file; merge with tools/telemetry_report.py.")
    p.add_argument("--log-format", default="jsonl", choices=("jsonl", "tsv"),
                   help="--metrics-dir event format (tsv is write-only "
                        "export; the report tooling reads jsonl).")
    p.add_argument("--profile-dir", default=None,
                   help="Write a torch.profiler trace (CPU and CUDA "
                        "activities, Chrome format) of the first epoch, or "
                        "of the --profile-steps window, here.")
    p.add_argument("--profile-steps", default=None,
                   help="START:STOP global-step window to capture, "
                        "[START, STOP) (requires --profile-dir); captured "
                        "once, cut at the end of the data.")
    p.add_argument("--trace", action="store_true",
                   help="Request-scoped tracing (obs/spans.py): record span "
                        "events into the --metrics-dir log — the request "
                        "lifecycle (queue wait, prefill chunks, per-tick "
                        "decode/verify with slot attribution) under "
                        "--serve, per-step host spans (dispatch, host sync, "
                        "snapshot, checkpoint) in training.  Export with "
                        "tools/trace_export.py (Perfetto / "
                        "chrome://tracing); tools/telemetry_report.py adds "
                        "the TTFT decomposition.")
    p.add_argument("--trace-sample-rate", type=float, default=1.0,
                   help="Fraction of requests (serve) / steps (train) "
                        "traced (--trace).  Deterministic per correlation "
                        "id: a sampled request records its WHOLE span "
                        "chain, an unsampled one records nothing.")
    p.add_argument("--slo", default=None,
                   help="Declared service objectives over the live "
                        "telemetry plane (obs/slo.py), e.g. "
                        "'ttft_p99=250ms,tpot_p99=40ms,goodput=0.99' "
                        "(serve) or 'step_time_p95=120ms' (train): "
                        "multi-window burn-rate alerts (fast 1m / slow "
                        "10m) evaluated at every tick/step, each state "
                        "transition an alert event in the --metrics-dir "
                        "log and on /slo.  Requires --metrics-dir.")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="Scrapeable ops endpoint (obs/http.py) on "
                        "127.0.0.1: /metrics (Prometheus text), /healthz "
                        "(heartbeat-staleness liveness), /slo (objective "
                        "status, active alerts, live TTFT decomposition).  "
                        "0 binds an ephemeral port (printed); under "
                        "torchrun each rank of a host binds this port plus "
                        "its local rank.  Requires --metrics-dir.")
    p.add_argument("--healthz-stale-s", type=float, default=60.0,
                   help="/healthz staleness bound (--metrics-port): a "
                        "component whose last event/gauge is older than "
                        "this flips the probe to 503.  Liveness refreshes "
                        "per optimizer step (train) / scheduler tick "
                        "(serve).")
    p.add_argument("--goodput", action="store_true",
                   help="Training goodput ledger (obs/ledger.py): classify "
                        "every second of the run into mutually exclusive "
                        "categories — compile (the first step's one-time "
                        "costs), step_compute, grad_sync (ICI/DCN split "
                        "via the analytic wall model), data_wait, "
                        "ckpt_save, ckpt_restore, rework, "
                        "supervisor_backoff, other — with sum(categories) "
                        "== wall clock EXACT; a goodput_ledger record in "
                        "the event log.  Requires --metrics-dir; training "
                        "runs only.")
    # --- checkpoints and resilience (the JAX CLI's flags and defaults) ---
    p.add_argument("--checkpoint-dir", default=None,
                   help="Save a checkpoint per epoch.")
    p.add_argument("--resume", action="store_true",
                   help="Resume from --checkpoint-dir if present.")
    p.add_argument("--ckpt-every-steps", type=int, default=None,
                   help="Mid-epoch checkpoint cadence (global steps): async "
                        "step-granular saves so a crash/preemption loses at "
                        "most this many steps; resume skips the consumed "
                        "batches of the partial epoch deterministically "
                        "(requires --checkpoint-dir).")
    p.add_argument("--elastic", action="store_true",
                   help="Supervise the run: restart on crash/hang, resuming "
                        "from --checkpoint-dir (torchelastic equivalent).  "
                        "Crash relaunches back off exponentially with "
                        "jitter; a preemption exit (SIGTERM -> step "
                        "checkpoint -> exit 75) relaunches immediately "
                        "without charging --max-restarts.")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="Restart budget under --elastic.")
    p.add_argument("--heartbeat-timeout", type=float, default=600.0,
                   help="Seconds without training progress before a hung "
                        "run is killed (--elastic).")
    p.add_argument("--skip-bad-steps", action="store_true",
                   help="Skip gate (resilience/anomaly.py): a step with a "
                        "non-finite loss or gradient norm (or a norm over "
                        "--grad-spike-threshold) leaves the state as it "
                        "was; --rollback-after bad steps in a row roll back "
                        "to the last host snapshot, --max-rollbacks "
                        "rollbacks abort for a supervised restart.")
    p.add_argument("--grad-spike-threshold", type=float, default=None,
                   help="Skip finite steps whose global gradient norm "
                        "exceeds this (--skip-bad-steps; default: "
                        "non-finite only).")
    p.add_argument("--rollback-after", type=int, default=8,
                   help="Consecutive skipped steps before rolling back to "
                        "the last snapshot (--skip-bad-steps).")
    p.add_argument("--max-rollbacks", type=int, default=2,
                   help="Rollbacks before aborting the run for a supervised "
                        "restart (--skip-bad-steps).")
    p.add_argument("--snapshot-every-steps", type=int, default=200,
                   help="Host snapshot cadence for the rollback "
                        "(--skip-bad-steps).")
    p.add_argument("--inject-faults", default=None,
                   help="Deterministic fault injection "
                        "(resilience/faults.py): comma-separated "
                        "kind@step[:arg] with kinds crash, stall, sigterm, "
                        "nan_batch, spike_batch, ckpt_truncate — each fires "
                        "once per run (markers persist across supervised "
                        "relaunches in <ckpt-dir>/.fault_state).  Chaos "
                        "testing only.")
    p.add_argument("--elastic-resize", default=None, metavar="SPEC",
                   help="Elastic membership chaos episode "
                        "(resilience/elastic.py): comma-separated "
                        "kind@step[:arg] with kinds slice_lost@N:K, "
                        "slice_return@N, host_hang@N[:S].  Unlike --elastic, "
                        "a lost slice does NOT kill the run: the survivors "
                        "restore from the peer-RAM snapshot tier, shrink to "
                        "their group, scale grad accumulation to preserve "
                        "the global batch, and grow back when the slice "
                        "returns.  Runs under torchrun with --distributed, "
                        "the world read as 2 slices of consecutive ranks.")
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
    p.add_argument("--device-cache", action="store_true",
                   help="Keep the training set on the device and assemble "
                        "every batch there (shuffle, crop, flip; or token "
                        "windows): uint8 image sets (cifar10, "
                        "synthetic-images, shapes, packed-images) or a "
                        "token-file: stream.  No host-to-device copy a "
                        "step.  Crop boxes are drawn per batch, flips per "
                        "sample; eval stays on the host loader.")
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
    p.add_argument("--serve-tp", type=int, default=1,
                   help="Tensor-parallel size of each serving replica: run "
                        "under torchrun with a world of N x "
                        "--serve-replicas; each rank holds its shard of the "
                        "heads and of the MLP and a replica's ranks step in "
                        "lockstep (serve/tp.py).  Greedy output stays "
                        "token-exact.  1 = unsharded.")
    p.add_argument("--serve-replicas", type=int, default=1,
                   help="Independent engine replicas behind one router "
                        "(serve/router.py): prefix-cache affinity, then "
                        "least-loaded dispatch.  Replica k runs on card k "
                        "when there are enough cards, else all share one; "
                        "with --serve-tp N, on ranks [kN, (k+1)N).")
    p.add_argument("--serve-affinity", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="Prefix-cache-affinity routing (--serve-replicas > "
                        "1, paged engines); off = pure least-loaded "
                        "dispatch.")
    p.add_argument("--serve-ttl", type=float, default=None,
                   help="Deadline in seconds after arrival: a request "
                        "still queued past it is shed, one in flight is "
                        "cancelled at the next tick; both are excluded from "
                        "goodput.")
    p.add_argument("--serve-disagg", default=None, metavar="P:D",
                   help="Disaggregated prefill/decode serving: a P-slot "
                        "prefill-role pool and a D-slot decode-role pool "
                        "per replica (serve/disagg.py), KV handed off "
                        "through the shared paged block pool (or a row "
                        "copy, contiguous).  Replaces --serve-slots.")
    p.add_argument("--serve-inject-faults", default=None, metavar="SPEC",
                   help="Serving-tier chaos plane (resilience/faults.py): "
                        "comma-separated kind@tick[:replica[:arg]] with "
                        "kinds replica_crash[:role], replica_stall[:ticks], "
                        "replica_slow:factor, handoff_drop — evaluated at "
                        "router tick boundaries, each fires once per run "
                        "(markers persist in <ckpt-dir>/.fault_state across "
                        "supervised relaunches).  Forces the replica router "
                        "even at --serve-replicas 1.  Chaos testing only.")
    p.add_argument("--serve-failover", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="Router-level replica failover (serve/failover.py, "
                        "multi-replica or chaos runs): missed-tick/heartbeat "
                        "death detection, fence + drain, token-exact requeue "
                        "of a dead replica's queued and in-flight requests "
                        "onto survivors, exactly-once retirement, brown-out "
                        "shedding, backoff-scheduled respawn.  "
                        "--no-serve-failover is the control: a dead replica "
                        "strands its work (expect a hung run under replica "
                        "faults).")
    p.add_argument("--serve-retry-budget", type=int, default=2,
                   help="Failover re-placements a request may consume "
                        "before it is retired with finish reason 'failed' "
                        "(--serve-failover).")
    p.add_argument("--serve-brownout-s", type=float, default=0.0,
                   help="Brown-out margin (--serve-failover): while the "
                        "tier is under capacity after a replica death, "
                        "queued requests shed this many seconds BEFORE "
                        "their --serve-ttl deadline instead of at it.")
    p.add_argument("--serve-autoscale", action="store_true",
                   help="Closed-loop autoscaling (serve/autoscale.py): the "
                        "fleet is built at --serve-replicas up front, spares "
                        "park, and a controller on the router tick revives/"
                        "retires replicas from queue depth + SLO burn "
                        "alerts, re-splits disagg roles from the live TTFT "
                        "decomposition, and walks a pressure ladder "
                        "(host-tier shedding, brown-out) before dropping "
                        "work.  No device allocation per action; every "
                        "action is a schema'd autoscale_action event with "
                        "its cause.  Implies the router path and needs "
                        "--serve-failover.")
    p.add_argument("--serve-autoscale-min", type=int, default=1,
                   help="Floor of active replicas (--serve-autoscale); the "
                        "controller starts here and parks the rest.")
    p.add_argument("--serve-autoscale-max", type=int, default=0,
                   help="Ceiling of active replicas (--serve-autoscale); "
                        "0 = the whole built fleet (--serve-replicas).")
    p.add_argument("--serve-autoscale-up-depth", type=int, default=8,
                   help="Queued requests across the tier (incl. the "
                        "failover pending buffer) that count as scale-up "
                        "pressure (--serve-autoscale).")
    p.add_argument("--serve-autoscale-down-idle", type=int, default=32,
                   help="Consecutive fully-idle ticks before one replica "
                        "is drained and parked (--serve-autoscale).")
    p.add_argument("--serve-autoscale-cooldown", type=int, default=16,
                   help="Minimum ticks between replica-count actions "
                        "(--serve-autoscale).")
    p.add_argument("--serve-priority", default=None, metavar="SPEC",
                   help="Priority classes for SLO-weighted admission "
                        "(serve/policy.py): 'interactive=4,batch=1' maps "
                        "tenant names to scheduling weights popped by "
                        "weighted deficit over the tenant-fair queue; "
                        "per-class --slo objectives "
                        "(ttft_p99[interactive]=250ms) boost a class while "
                        "its live window is out of budget.")
    return p


def _check_serve_scale(tp: int, replicas: int) -> None:
    """The refusal of ``--serve-tp`` / ``--serve-replicas`` below 1."""
    if tp < 1 or replicas < 1:
        raise SystemExit("--serve-tp and --serve-replicas must be >= 1")


def _serve_world(tp: int, replicas: int, device) -> tuple[int, int]:
    """``(rank, world)`` of a ``--serve-tp`` run: the torchrun group of
    ``tp`` x ``replicas`` ranks joined (gloo when the ranks share a card
    or run on the host, NCCL when each has its own card); ``(0, 1)`` at
    ``tp`` 1."""
    import os

    import torch

    from ..comm import init as comm_init

    if tp == 1:
        return 0, 1
    want = tp * replicas
    world = (comm_init.process_count() if comm_init.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != want:
        raise SystemExit(
            f"--serve-tp {tp} x --serve-replicas {replicas} runs under "
            f"torchrun with a world of {want} (got {world}): python -m "
            f"torch.distributed.run --nproc-per-node {want} -m "
            "pytorch_distributed_training_tpu_torch.cli.main --serve ..."
        )
    backend = ("nccl" if device.type == "cuda"
               and torch.cuda.device_count() >= want else "gloo")
    comm_init.initialize(device, backend=backend)
    return comm_init.process_index(), world


def run_serve(*, model, overrides, precision, seed, seq_len, metrics_jsonl,
              n_requests, rate, num_slots, max_new, prefill_chunk, spec_k=0,
              spec_ngram=4, device=None, paged=False, block_size=16,
              num_blocks=0, kv_dtype="bf16", kv_host_mb=0.0,
              checkpoint_dir=None, emitter=None, spans=None,
              slo_policy=None, ttl=None, tp=1, replicas=1, affinity=True,
              disagg=None, inject_faults=None, failover=True,
              retry_budget=2, brownout_s=0.0, autoscale=False,
              autoscale_min=1, autoscale_max=0, autoscale_up_depth=8,
              autoscale_down_idle=32, autoscale_cooldown=16, priority=None,
              healthz_stale_s=60.0, ops_server=None) -> dict:
    """Serve ``model`` over the synthetic trace and print the summary.
    With ``checkpoint_dir`` the newest verified checkpoint's parameters
    replace the fresh-init weights drawn from ``seed``.  ``emitter``,
    ``spans`` and ``slo_policy`` are the scheduler's telemetry hooks
    (``_Telemetry``); the caller closes them.

    Scale-out, as the JAX CLI builds it: ``disagg`` ("P:D") splits each
    replica into a prefill-role and a decode-role pool
    (``DisaggServingEngine``); ``replicas`` > 1 puts a prefix-affinity
    router (``ReplicaRouter``) above the replicas, replica k on card k
    when there are enough cards, else all on ``device``; ``tp`` > 1 shards
    each replica over ``tp`` ranks of a torchrun world of ``tp`` x
    ``replicas``, replica k on ranks ``[k tp, (k + 1) tp)``: rank 0 runs
    the router and drives replica 0's ranks in lockstep and the other
    replicas through their leaders (``serve/tp.py``).  ``ttl`` gives
    every request a deadline ``ttl`` seconds after its arrival.

    The serving fleet's controllers, as the JAX CLI wires them: a fault
    spec (``inject_faults`` or ``PDT_SERVE_FAULTS``) arms the chaos plane
    and forces the router even at one replica; ``failover`` (on by
    default wherever the router runs) adds the ``FailoverController``
    (``retry_budget``, ``brownout_s``, the staleness bound
    ``healthz_stale_s``); ``autoscale`` adds the ``AutoscaleController``
    and needs failover; ``priority`` ("class=weight,...") the admission
    policy.  ``ops_server`` serves the autoscale controller's block on
    ``/slo``.

    Returns ``{"summary", "engine", "tokens", "prefill_ticks", "rank",
    ...}``: the SLO summary, the engine's (tier's, router's summed)
    counters, every request's generated tokens by id, this rank's prefill
    forwards; ``router``, ``tp`` and ``remote`` hold the router's
    counters (the controllers' blocks included), the lockstep's and the
    remote replicas'.  Any other rank returns its engine's counters, no
    summary and no tokens."""
    import copy

    import torch

    from ..models import create_model
    from ..serve import DisaggServingEngine, ServingEngine
    from ..train import make_policy
    from ..utils.device import resolve_device

    _check_serve_scale(tp, replicas)
    role_slots = None
    if disagg is not None:
        try:
            p_slots, d_slots = (int(x) for x in str(disagg).split(":"))
            if p_slots < 1 or d_slots < 1:
                raise ValueError
        except ValueError:
            raise SystemExit(
                f"--serve-disagg wants P:D with both >= 1 (e.g. 1:3), got "
                f"{disagg!r}") from None
        role_slots = (p_slots, d_slots)
    if kv_host_mb and not paged:
        raise SystemExit(
            "--serve-kv-host-mb spills paged blocks — add --serve-paged"
        )
    if kv_dtype != "bf16" and not paged:
        raise SystemExit(
            "--serve-kv-dtype quantizes paged blocks — add --serve-paged"
        )
    if autoscale and not failover:
        build_parser().error(
            "--serve-autoscale retires/revives replicas through the "
            "failover fence/drain path — drop --no-serve-failover")
    device = resolve_device(device)
    policy = make_policy(precision)
    # Serving casts every parameter (LayerNorm and embeddings included) to
    # the compute dtype, as the JAX CLI does.
    net = create_model(
        model, dtype=policy.compute_dtype, device=device, seed=seed,
        cfg_overrides=overrides,
    )
    if max_new > net.cfg.max_seq_len - 2:
        raise ValueError(
            f"--serve-max-new {max_new} leaves no room for a prompt in the "
            f"model's {net.cfg.max_seq_len}-position cache"
        )
    params = None
    if checkpoint_dir:
        from ..checkpoint import CheckpointManager

        params = CheckpointManager(checkpoint_dir).restore_params()
        if params is not None:
            _load_params(net, params)
            print(f"serving params restored from {checkpoint_dir}")
    if params is None:
        if checkpoint_dir:
            print(f"warning: no committed checkpoint in {checkpoint_dir}")
        print("warning: serving FRESH-INIT weights (pass --checkpoint-dir "
              "with a trained run for real outputs)")
    max_len = net.cfg.max_seq_len
    rank, fabric = 0, None
    if tp > 1:
        from ..comm.mesh import MeshConfig, make_mesh
        from ..parallel.sharded import shard_for_serving
        from ..serve.tp import ReplicaFabric

        rank, _ = _serve_world(tp, replicas, device)
        heads = net.cfg.num_heads
        if heads % tp:
            build_parser().error(
                f"--serve-tp {tp} needs heads ({heads}) divisible by it "
                "(each rank attends over its own heads)")
        mesh = make_mesh(MeshConfig(data=replicas, tensor=tp))
        shard_for_serving(net, mesh)
        fabric = ReplicaFabric(mesh)
    tokens: dict = {}
    stream_cb = (None if rank != 0 else
                 lambda rid, tok: tokens.setdefault(rid, []).append(tok))
    engine_kw = dict(
        max_len=max_len, prefill_chunk=prefill_chunk, temperature=0.0,
        seed=seed, spec_k=spec_k, spec_ngram=spec_ngram,
        paged=paged, block_size=block_size, num_blocks=num_blocks or None,
        kv_dtype=kv_dtype, kv_host_mb=kv_host_mb or None,
        stream_cb=stream_cb,
    )
    engines = []
    # Under --serve-tp every rank builds its shard of its own replica.
    for k in range(1 if fabric is not None else replicas):
        dev, net_k = device, net
        if (fabric is None and device.type == "cuda" and replicas > 1
                and torch.cuda.device_count() >= replicas):
            dev = torch.device("cuda", k)
            if dev != device:
                net_k = copy.deepcopy(net).to(dev)
        if role_slots is not None:
            engines.append(DisaggServingEngine(
                net_k, prefill_slots=role_slots[0],
                decode_slots=role_slots[1], device=dev, **engine_kw))
        else:
            engines.append(ServingEngine(net_k, num_slots=num_slots,
                                         device=dev, **engine_kw))

    def prefill_ticks():
        return sum((e.prefill_engine if role_slots else e).prefill_ticks
                   for e in engines)

    def trace(group_engines):
        for e in group_engines:
            e.stream_cb = stream_cb
        return _serve_trace(
            engines=group_engines, net=net, seed=seed, seq_len=seq_len,
            max_len=max_len, max_new=max_new, n_requests=n_requests,
            rate=rate, ttl=ttl, metrics_jsonl=metrics_jsonl,
            emitter=emitter, spans=spans, slo_policy=slo_policy,
            affinity=affinity, paged=paged, spec_k=spec_k,
            spec_ngram=spec_ngram, kv_dtype=kv_dtype, kv_host_mb=kv_host_mb,
            block_size=block_size, prefill_chunk=prefill_chunk,
            num_slots=num_slots, role_slots=role_slots, tp=tp,
            replicas=replicas, tokens=tokens, inject_faults=inject_faults,
            failover=failover, retry_budget=retry_budget,
            brownout_s=brownout_s, autoscale=autoscale,
            autoscale_min=autoscale_min, autoscale_max=autoscale_max,
            autoscale_up_depth=autoscale_up_depth,
            autoscale_down_idle=autoscale_down_idle,
            autoscale_cooldown=autoscale_cooldown, priority=priority,
            healthz_stale_s=healthz_stale_s, ops_server=ops_server,
            checkpoint_dir=checkpoint_dir)

    if fabric is None:
        result = trace(engines)
    else:
        from ..serve.tp import run_fleet_rank

        result = run_fleet_rank(fabric, engines[0], trace)
        if rank != 0:
            return {"summary": None, "engine": engines[0].stats(),
                    "tokens": {}, "prefill_ticks": prefill_ticks(),
                    "rank": rank, "calls": result}
    return {**result, "prefill_ticks": prefill_ticks(), "rank": rank}


def serve_requests(*, vocab, seed, seq_len, max_len, max_new, n_requests,
                   rate=0.0, t0=0.0, ttl=None) -> list:
    """The CLI's synthetic serving trace (the JAX CLI's, draw for draw):
    prompts of 2 to ``min(seq_len, max_len - max_new) // 2`` tokens,
    budgets from ``max_new // 4`` to ``max_new``, Poisson arrivals at
    ``rate`` from ``t0`` (all at ``t0`` when 0), deadlines ``ttl`` after
    arrival."""
    from ..serve import Request

    rng = np.random.default_rng(seed)
    p_hi = max(min(seq_len, max_len - max_new) // 2, 2)
    prompts = [
        rng.integers(0, vocab, (int(rng.integers(2, p_hi + 1)),))
        .astype(np.int32)
        for _ in range(n_requests)
    ]
    budgets = rng.integers(max(max_new // 4, 1), max_new + 1, n_requests)
    if rate and rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    else:
        arrivals = np.zeros(n_requests)
    return [
        Request(i, prompts[i], int(budgets[i]), float(t0 + arrivals[i]),
                deadline=(float(t0 + arrivals[i] + ttl)
                          if ttl is not None else None))
        for i in range(n_requests)
    ]


def _serve_trace(*, engines, net, seed, seq_len, max_len, max_new,
                 n_requests, rate, ttl, metrics_jsonl, emitter, spans,
                 slo_policy, affinity, paged, spec_k, spec_ngram, kv_dtype,
                 kv_host_mb, block_size, prefill_chunk, num_slots,
                 role_slots, tp, replicas, tokens, inject_faults, failover,
                 retry_budget, brownout_s, autoscale, autoscale_min,
                 autoscale_max, autoscale_up_depth, autoscale_down_idle,
                 autoscale_cooldown, priority, healthz_stale_s, ops_server,
                 checkpoint_dir) -> dict:
    """``run_serve``'s trace on rank 0: the synthetic requests, the
    scheduler or the router (and its controllers) over ``engines``, and
    the summary lines."""
    import os

    from ..resilience.faults import SERVE_FAULTS_ENV
    from ..serve import (
        ContinuousScheduler, ReplicaRouter, summarize_records,
    )
    from ..serve.tp import LockstepEngine, RemoteReplica
    from ..utils import metrics as metrics_lib

    engine = engines[0]
    t0 = time.monotonic()
    requests = serve_requests(
        vocab=net.cfg.vocab_size, seed=seed, seq_len=seq_len,
        max_len=max_len, max_new=max_new, n_requests=n_requests, rate=rate,
        t0=t0, ttl=ttl)
    req_log = (
        metrics_lib.RequestLogger(metrics_jsonl) if metrics_jsonl else None
    )
    # The chaos plane: a fault spec forces the router even at one replica
    # (the failover controller is what is under test).
    fault_spec = inject_faults or os.environ.get(SERVE_FAULTS_ENV)
    chaos = None
    if fault_spec:
        from ..resilience import ServeFaultInjector

        chaos = ServeFaultInjector.from_spec(
            fault_spec, emitter=emitter,
            state_dir=(os.path.join(checkpoint_dir, ".fault_state")
                       if checkpoint_dir else None))
        if not failover:
            print("warning: serving faults armed WITHOUT failover — a dead "
                  "replica strands its queue (control mode)")
    aggregator = slo_policy.aggregator if slo_policy is not None else None
    serve_policy = None
    if priority:
        from ..serve import ServePolicy, parse_priority_spec

        try:
            weights = parse_priority_spec(priority)
        except ValueError as e:
            build_parser().error(f"--serve-priority: {e}")
        serve_policy = ServePolicy(weights, aggregator=aggregator)
        if slo_policy is not None:
            serve_policy.bind_objectives(slo_policy.objectives)
    # The whole trace is this tool's own workload: queue all of it.
    router = None
    if len(engines) > 1 or chaos is not None or autoscale:
        failover_ctrl = autoscale_ctrl = None
        if failover:
            from ..serve import FailoverController

            failover_ctrl = FailoverController(
                retry_budget=retry_budget, brownout_margin_s=brownout_s,
                aggregator=aggregator,
                # One staleness bound for /healthz and the detector.
                stale_after_s=healthz_stale_s)
        if autoscale:
            from ..serve import AutoscaleController

            try:
                autoscale_ctrl = AutoscaleController(
                    min_replicas=autoscale_min,
                    max_replicas=autoscale_max or None,
                    up_queue_depth=autoscale_up_depth,
                    down_idle_ticks=autoscale_down_idle,
                    cooldown_ticks=autoscale_cooldown,
                    slo=slo_policy, aggregator=aggregator)
            except ValueError as e:
                build_parser().error(f"--serve-autoscale: {e}")
        try:
            router = ReplicaRouter(
                engines, max_queue=n_requests, request_logger=req_log,
                emitter=emitter, affinity=affinity, spans=spans,
                slo=slo_policy, chaos=chaos, failover=failover_ctrl,
                autoscale=autoscale_ctrl, policy=serve_policy,
            )
        except ValueError as e:
            if autoscale_ctrl is None:
                raise
            build_parser().error(f"--serve-autoscale: {e}")
        if autoscale_ctrl is not None and ops_server is not None:
            # /slo grows the controller block (a read-only snapshot).
            ops_server.controller = autoscale_ctrl
        driver = router
    else:
        driver = ContinuousScheduler(
            engine, max_queue=n_requests, request_logger=req_log,
            emitter=emitter, spans=spans, slo=slo_policy,
            policy=serve_policy,
        )
    n_blocks = (engine.blocks.num_blocks if role_slots is not None
                else engine.pool.num_blocks) if paged else 0
    layout = (
        f"paged ({n_blocks} blocks x {block_size})" if paged
        else "contiguous"
    )
    if kv_dtype != "bf16":
        layout += f", kv={kv_dtype}"
    if kv_host_mb:
        layout += f" + {kv_host_mb:g} MB host KV tier"
    slots_note = (f"{role_slots[0]}+{role_slots[1]} prefill+decode slots"
                  if role_slots is not None else f"{num_slots} slots")
    spec_note = f", spec k={spec_k} ngram={spec_ngram}" if spec_k else ""
    scale_note = ""
    if tp > 1 or replicas > 1:
        scale_note = (f", tp={tp} x {replicas} replica(s)"
                      f"{', affinity' if replicas > 1 and affinity else ''}")
    if router is not None and router.autoscale is not None:
        a = router.autoscale
        scale_note += f", autoscale [{a.min_replicas}, {a.max_replicas}]"
    if serve_policy is not None:
        scale_note += f", priority({priority})"
    print(
        f"serving started: {n_requests} requests, {slots_note} "
        f"({layout}), rate={rate or 'burst'} req/s, "
        f"prefill_chunk={prefill_chunk}{spec_note}{scale_note}"
    )
    # Every tick reads its sampled tokens back to the host, so the trace
    # has finished on the device when run() returns.
    records = driver.run(requests)
    elapsed = time.monotonic() - t0
    if router is not None:
        engine_stats = router.engine_stats()
        samples = (router.queue_depth_samples(),
                   router.active_slot_samples())
    else:
        engine_stats = engine.stats()
        samples = (driver.queue_depth_samples, driver.active_slot_samples)
    summary = summarize_records(
        records, elapsed=elapsed, queue_depth_samples=samples[0],
        rejected=driver.rejected, active_slot_samples=samples[1],
        engine_stats=engine_stats if (paged or spec_k) else None,
        failover_stats=(router.failover.stats() if router is not None
                        and router.failover is not None else None),
    )
    if router is not None:
        rt = router.stats()
        hit_rate = (rt["affinity_hits"] / sum(rt["routed"])
                    if sum(rt["routed"]) else 0.0)
        print(f"router: routed={rt['routed']} "
              f"affinity_hit_rate={hit_rate:.3f} "
              f"rebalanced={rt['rebalanced']} rejected={rt['rejected']} "
              f"sibling_fetches={rt['sibling_fetches']} "
              f"({rt['sibling_fetch_blocks']} blocks)")
        if router.failover is not None:
            fo = rt["failover"]
            print(f"failover: deaths={fo['replica_deaths']} "
                  f"requeued={fo['requeued']} retried={fo['retried']} "
                  f"dup_suppressed={fo['duplicates_suppressed']} "
                  f"failed={fo['failed']} respawns={fo['respawns']}")
        if router.autoscale is not None:
            a = router.autoscale.stats()
            print(f"autoscale: actions={a['actions']} "
                  f"up={a['scale_ups']} down={a['scale_downs']} "
                  f"resplits={a['resplits']} "
                  f"ladder_moves={a['ladder_moves']} "
                  f"active={a['replicas_active']}/"
                  f"{a['replicas_active'] + a['replicas_parked']} "
                  f"rung={a['rung']} split_bias={a['split_bias']}")
    if spec_k and summary.get("spec"):
        sp = summary["spec"]
        print(
            f"speculation: acceptance_rate={sp['acceptance_rate']} "
            f"({sp['accepted_tokens']}/{sp['drafted_tokens']} drafted), "
            f"tokens_per_tick={sp['tokens_per_decode_tick']}"
        )
    if paged:
        st = engine_stats
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
    ticks = len(samples[0])
    extra = {}
    remotes = [e for e in engines if isinstance(e, RemoteReplica)]
    if role_slots is not None:
        handoff_s = sum(e.read("handoff_s") if isinstance(e, RemoteReplica)
                        else e.handoff_s for e in engines)
        print(f"disagg: {engine_stats.get('handoffs', 0)} prefill->decode "
              f"handoff(s), roles {role_slots[0]}p+{role_slots[1]}d, "
              f"handoff host {handoff_s / max(ticks, 1) * 1e3:.4f} ms a "
              "tick")
        extra["handoff_s"] = handoff_s
    if isinstance(engine, LockstepEngine):
        print(f"tensor parallel: {tp} ranks in lockstep, "
              f"{engine.broadcasts} calls broadcast, broadcast host "
              f"{engine.broadcast_s / max(ticks, 1) * 1e3:.4f} ms a tick")
        extra["tp"] = {"broadcasts": engine.broadcasts,
                       "broadcast_s": engine.broadcast_s}
    if remotes:
        calls = sum(r.round_trips for r in remotes)
        call_s = sum(r.round_trip_s for r in remotes)
        served_s = sum(r.served_s for r in remotes)
        wait_s = sum(r.wait_s for r in remotes)
        cached = sum(r.cached_reads for r in remotes)
        print(f"remote replicas: {len(remotes)} group(s) led by other "
              f"processes, {calls} calls ({calls / max(ticks, 1):.2f} a "
              f"tick), round-trip host {call_s / max(ticks, 1) * 1e3:.4f} "
              f"ms a tick ({served_s / max(ticks, 1) * 1e3:.4f} of it the "
              f"groups' own work, rank 0 blocked "
              f"{wait_s / max(ticks, 1) * 1e3:.4f}), {cached} cached reads")
        extra["remote"] = {"round_trips": calls, "round_trip_s": call_s,
                           "served_s": served_s, "wait_s": wait_s,
                           "cached_reads": cached}
    extra["ticks"] = ticks
    if router is not None:
        extra["router"] = router.stats()
        if router.autoscale is not None:
            extra["autoscale"] = router.autoscale.stats()
    metrics_lib.MetricsLogger(None).log({"mode": "serve", **{
        k: v for k, v in summary.items() if not isinstance(v, dict)
    }})
    if serve_policy is not None:
        ps = serve_policy.snapshot()
        print(f"priority: admitted_by_class={ps['admitted_by_class']} "
              f"boosted={ps['boosted_admissions']}")
    if spans is not None:
        spans.close()
        print(f"trace: {spans.recorded} spans recorded ({spans.sampled_out} "
              f"sampled out at rate {spans.sample_rate}); export with "
              "tools/trace_export.py")
    return {"summary": summary, "engine": engine_stats, "tokens": tokens,
            **extra}


def _load_params(net, params: dict) -> None:
    """Copy checkpointed parameters into ``net`` by name, cast to its
    dtype; the names must be exactly the model's."""
    import torch

    names = dict(net.named_parameters())
    if set(names) != set(params):
        diff = sorted(set(names) ^ set(params))
        raise ValueError(
            f"checkpoint parameters do not match --model: {len(diff)} "
            f"names differ (first: {diff[0]})")
    with torch.no_grad():
        for name, p in names.items():
            p.copy_(params[name])


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
        # Built as early as possible, so the ledger books the start-up.
        tel = _Telemetry(args, rank=rank, world=world, device=device,
                         mode="train")
        try:
            return _train(args, overrides, device, group, rank, world, tel)
        finally:
            tel.close()   # a run refused before its loop started
    finally:
        comm_init.shutdown()


def _loader_microbatches(args) -> int:
    """The row-wise microbatches a rank's batch holds, JAX's: the
    accumulation slices, each cut into the pipeline's microbatches."""
    if args.pipeline_parallel <= 1:
        return args.accum_steps
    return args.accum_steps * (args.pipeline_microbatches
                               or 2 * args.pipeline_parallel)


def _device_cache(args, ds, kind, device, rank, world):
    """The JAX CLI's ``--device-cache`` branch: the token stream (LM) or
    the uint8 records (images) uploaded to ``device``, each rank drawing
    the global batch and keeping its rows.  Refused across hosts: every
    rank holds the whole set, which only the ranks of one node share."""
    import os

    from ..data import DeviceCachedImages, DeviceCachedTokens, Subset

    if world > 1 and int(os.environ.get("LOCAL_WORLD_SIZE", world)) != world:
        raise SystemExit(
            "--device-cache is single-host (each host would need its own "
            "shard); use the streaming loader for multi-host runs")
    shard = dict(device=device, seed=args.seed, rank=rank, world=world,
                 num_microbatches=_loader_microbatches(args))
    if kind == "lm":
        src, lo, hi = ds, None, None
        if isinstance(src, Subset):
            lo, hi = src.start, src.stop
            src = src.dataset
        stream = getattr(src, "tokens", None)
        if stream is None:
            raise SystemExit(
                f"--device-cache for LM needs a token-stream dataset "
                f"(token-file:<path>); {args.dataset!r} has none")
        if lo is not None:
            # Window-range subset -> token-range slice (+1 so the last
            # window keeps its next-token target).
            stream = stream[lo * args.seq_len:hi * args.seq_len + 1]
        return DeviceCachedTokens(stream, default_seq_len=args.seq_len,
                                  **shard)
    images = getattr(ds, "images", None)
    if images is None:
        raise SystemExit(
            f"--device-cache needs a dataset with uint8 records (cifar10, "
            f"shapes, packed-images); {args.dataset!r} has none")
    side = int(images.shape[1])
    if args.image_size > side:
        # The cache crops from the stored records and cannot upscale.
        print(f"warning: --device-cache trains at the stored record "
              f"resolution {side}px, not --image-size {args.image_size} "
              f"(records cannot be upscaled on-device; use the host loader "
              f"for resize-up training)", file=sys.stderr)
    try:
        return DeviceCachedImages(ds, crop_size=min(args.image_size, side),
                                  train=True, **shard)
    except ValueError as e:  # non-uint8 records, crop too large, ...
        raise SystemExit(f"--device-cache: {e}") from None


def _train(args, overrides, device, group, rank, world, tel):
    import dataclasses
    import itertools
    import os

    from ..checkpoint import CheckpointManager
    from ..comm.mesh import BATCH_AXES
    from ..data import DataLoader, DataLoaderConfig
    from ..data.loader import to_device
    from ..models import create_model, model_kind
    from ..resilience import (
        PREEMPTED_EXIT_CODE, AnomalyPolicy, FaultInjector, Preempted,
        PreemptionHandler, RecoveryConfig, RecoveryManager,
        init_resilience_state,
    )
    from ..resilience.faults import FAULTS_ENV
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
    policy = make_policy(args.precision)
    if args.model == "gpt2_moe" or int(overrides.get("num_experts", 0)) > 0:
        # The CLI's mesh has no expert axis, so the scatter dispatch (no
        # (T, E, C) one-hots) is JAX's choice; an explicit
        # --model-overrides moe_dispatch=einsum wins.
        overrides.setdefault("moe_dispatch", "scatter")
    net = create_model(args.model, num_classes=num_classes,
                       dtype=policy.param_dtype, device=device,
                       seed=args.seed, cfg_overrides=overrides,
                       image_size=image_size)
    mesh, rules, opt_rules = _sharding(args, net, world)
    # The batch splits over the batch axes only: the ranks of one tensor,
    # sequence or pipeline group take the same rows.
    shard, n_shards = mesh.batch_index, mesh.axes_size(BATCH_AXES)
    n_micro = _loader_microbatches(args)
    if args.pipeline_parallel > 1:
        net = _pipelined(args, net, mesh, policy)
        # The stage axis over ``pipeline``, and FSDP's or TP's splits.
        rules = net.rules()
    if args.batch_size % (n_micro * n_shards):
        raise SystemExit(
            f"--batch-size {args.batch_size} must divide into "
            f"--accum-steps {args.accum_steps} microbatches x {n_shards} "
            "processes"
            + (f" x {net.num_microbatches} pipeline microbatches"
               if args.pipeline_parallel > 1 else ""))
    faults = None
    emitter = tel.emitter
    fault_spec = args.inject_faults or os.environ.get(FAULTS_ENV)
    if fault_spec:
        # Fired-markers persist under the checkpoint dir, so a supervised
        # relaunch (which resumes BELOW the fault step) does not refire.
        try:
            faults = FaultInjector.from_spec(fault_spec, state_dir=(
                os.path.join(args.checkpoint_dir, ".fault_state")
                if args.checkpoint_dir else None),
                emitter=tel.live_emitter)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    loader = DataLoader(ds, DataLoaderConfig(
        batch_size=args.batch_size, num_workers=args.num_workers,
        seed=args.seed,
    ), shard_index=shard, num_shards=n_shards,
        num_microbatches=n_micro)
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
    if _sharded(args):
        from ..parallel.sharded import describe

        state = create_train_state(
            net, tx, policy=policy, mesh=mesh, rules=rules,
            opt_rules=opt_rules, sp_mode=args.sequence_parallel_mode)
        print(describe(state.shardings), flush=True)
    else:
        state = create_train_state(net, tx, policy=policy,
                                   process_group=group)
    # The residual joins the state before a restore, which keeps it.
    state, grad_sync = _build_grad_sync(args, state, group)
    # The skip gate rides the step; the recovery manager stages snapshots
    # and rolls back or aborts at the trainer's log points.  The counters
    # join the state before a restore fills them.
    anomaly_policy = recovery = None
    if args.skip_bad_steps:
        anomaly_policy = AnomalyPolicy(
            grad_norm_threshold=args.grad_spike_threshold)
        state = dataclasses.replace(state,
                                    resilience=init_resilience_state(device))
        recovery = RecoveryManager(RecoveryConfig(
            rollback_after=args.rollback_after,
            max_rollbacks=args.max_rollbacks,
            snapshot_every_steps=args.snapshot_every_steps),
            emitter=tel.live_emitter, ledger=tel.ledger)
    if emitter.enabled:
        _emit_models(tel, args, state, mesh, grad_sync, net, policy)
    # Optimizer steps per epoch — translates a restored step counter back
    # into an epoch index on --resume.  len(loader) is the per-process
    # step count, which equals the global optimizer step count (every
    # process advances state.step together).
    per_epoch_steps = args.steps_per_epoch \
        if args.steps_per_epoch is not None else max(len(loader), 1)
    start_epoch = resume_skip_steps = 0
    ckpt_mgr = None
    if args.checkpoint_dir:
        def ckpt_anomaly(kind, **fields):
            # A silent fallback to an older step is a debugging trap.
            print(f"checkpoint: {kind} {fields}")
            emitter.anomaly(kind, **fields)

        ckpt_mgr = CheckpointManager(
            args.checkpoint_dir, on_anomaly=ckpt_anomaly,
            fault_injector=faults, process_group=group)
        restored = None
        if args.resume:
            with tel.bracket("ckpt_restore"):
                restored = ckpt_mgr.restore_latest(state)
            if tel.ledger is not None:
                # Restart rework: the steps this attempt re-executes below
                # the interrupted one's watermark.
                prev = tel.ledger.read_progress(tel.ledger.progress_path)
                if prev is not None:
                    tel.ledger.set_rework_until(prev)
        if restored is not None:
            state = restored
            emitter.emit("record", {"record": "checkpoint_restore",
                                    "step": int(state.step),
                                    "restore_source": "disk"})
            # Resume where training left off; a mid-epoch step checkpoint
            # also skips the partial epoch's consumed batches (the
            # loader's epoch-seeded order replays them identically).
            start_epoch = min(state.step // per_epoch_steps, args.epochs)
            if start_epoch < args.epochs:
                resume_skip_steps = state.step - start_epoch * per_epoch_steps
            print(f"resumed from step {state.step} (epoch {start_epoch}, "
                  f"skipping {resume_skip_steps} consumed batches)")
    pipeline_grad_fn = None
    if args.pipeline_parallel > 1:
        from ..parallel.gpt2_pipeline import make_pipeline_grad_fn

        pipeline_grad_fn = make_pipeline_grad_fn(
            net, label_smoothing=args.label_smoothing,
            accum_steps=args.accum_steps)
    step_fn = make_train_step(
        kind=kind, policy=policy, num_microbatches=args.accum_steps,
        seed=args.seed + 1, label_smoothing=args.label_smoothing,
        lm_loss_chunk=args.ce_chunk, input_normalize=input_normalize,
        process_group=None if state.shardings is not None else group,
        anomaly_policy=anomaly_policy, grad_sync=grad_sync,
        state_shardings=state.shardings, grad_fn=pipeline_grad_fn,
    )
    cache = (_device_cache(args, ds, kind, device, shard, n_shards)
             if args.device_cache else None)
    # Preemption latch: a checkpointed run takes a synchronous step
    # checkpoint on SIGTERM and exits the code the supervisor relaunches
    # for free.
    preemption = checkpoint_fn = None
    if ckpt_mgr is not None:
        def checkpoint_fn(s, wait=False):
            ckpt_mgr.save(s, wait=wait)

        try:
            preemption = PreemptionHandler().install()
        except ValueError:
            preemption = None  # not the main thread (embedded callers)
    window = args.profile_window
    trainer = Trainer(state, step_fn, device, TrainerConfig(
        prefetch=0 if cache is not None else TrainerConfig.prefetch,
        checkpoint_every_steps=args.ckpt_every_steps,
        # The step window is the trainer's; a whole first epoch is
        # bracketed below.
        profile_dir=args.profile_dir if window is not None else None,
        profile_steps=window),
        faults=faults, preemption=preemption, checkpoint_fn=checkpoint_fn,
        recovery=recovery, emitter=emitter, spans=tel.spans,
        # What one step holds: the span attributes a timeline reader
        # needs (the sub-phase ranges are the profiler capture's).
        anatomy={
            "microbatches": args.accum_steps, "grad_sync": args.grad_sync,
            **({"sync_tiers": [
                "grad_sync/rs_ici", "grad_sync/ar_dcn", "grad_sync/ag_ici",
            ] + (["grad_sync/stripe"]
                 if grad_sync is not None and grad_sync.stripe > 1 else [])}
               if args.grad_sync.startswith("hier") else {}),
            **({"pipeline_stages": args.pipeline_parallel,
                "pipeline_schedule": args.pipeline_schedule}
               if args.pipeline_parallel > 1 else {}),
        },
        slo=tel.slo, ledger=tel.ledger)
    logger = metrics_lib.MetricsLogger(args.metrics_jsonl)
    eval_loader = eval_step = None
    if eval_ds is not None:
        eval_bs = min(args.batch_size, len(eval_ds))
        eval_loader = DataLoader(eval_ds, DataLoaderConfig(
            batch_size=eval_bs, num_workers=0, shuffle=False))
        # LM eval always chunks the CE: the eval batch is not split by
        # --accum-steps, so its full logits could outgrow a config whose
        # train step fits.  (Not the pipelined model's, as in JAX: its
        # eval batch is the train batch the pipeline already fits.)
        eval_chunk = (args.ce_chunk if args.pipeline_parallel > 1
                      else args.ce_chunk or 256)
        eval_step = make_eval_step(kind=kind, policy=policy,
                                   lm_loss_chunk=eval_chunk,
                                   input_normalize=input_normalize,
                                   state_shardings=state.shardings)

    print("training started")
    t0 = time.perf_counter()
    preempted = None
    probed = False
    try:
        for epoch in range(start_epoch, args.epochs):
            if cache is not None:
                batches = cache.batches(epoch, args.batch_size)
            else:
                loader.set_epoch(epoch)
                batches = iter(loader)
            # Deterministic mid-epoch resume: drop the batches the
            # interrupted run already consumed, capped at the same
            # absolute per-epoch bound.
            skip = resume_skip_steps if epoch == start_epoch else 0
            if skip or args.steps_per_epoch is not None:
                batches = itertools.islice(batches, skip,
                                           args.steps_per_epoch)
            if emitter.enabled and not probed:
                # The flop probe, booked as the ledger's compile interval.
                with tel.bracket("compile"):
                    batches = _probe_step_cost(
                        trainer, batches, kind=kind, policy=policy,
                        args=args, input_normalize=input_normalize)
                probed = True
            if args.profile_dir and window is None and epoch == 0:
                from ..utils.profiling import trace

                with trace(args.profile_dir):
                    summary = trainer.run_epoch(batches, epoch=epoch)
            else:
                summary = trainer.run_epoch(batches, epoch=epoch)
            if args.pipeline_parallel > 1:
                summary = {**summary,
                           "pipeline_stages": args.pipeline_parallel,
                           "pipeline_schedule": args.pipeline_schedule}
            logger.log(summary)
            if ckpt_mgr is not None:
                # Async: staging is enqueued now, the write overlaps the
                # eval and the next epoch; the finally below commits the
                # last save.
                with tel.bracket("ckpt_save"):
                    ckpt_mgr.save(trainer.state)
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
    except Preempted as e:
        # The trainer already committed a synchronous step checkpoint at
        # the boundary; fall through to the shared cleanup.
        preempted = e
    finally:
        if preemption is not None:
            preemption.uninstall()
        try:
            loader.close()
        finally:
            try:
                # Every exit path waits for the last async save to commit
                # (and raises if it failed).
                if ckpt_mgr is not None:
                    ckpt_mgr.close()
            finally:
                # Every exit path — normal, preempted, failed — flushes
                # and closes the event log.
                tel.close()
    elapsed = time.perf_counter() - t0
    if preempted is not None:
        print(f"preempted at step {preempted.step}; checkpoint "
              f"{'committed' if preempted.saved else 'unavailable'}; "
              f"exiting {PREEMPTED_EXIT_CODE}")
        print(f"elapsed time: {elapsed:.2f}s")
        sys.exit(PREEMPTED_EXIT_CODE)
    print("training finished")
    print(f"elapsed time: {elapsed:.2f}s")
    return trainer


# Flags the supervisor keeps to itself: the child runs without them.
_SUPERVISOR_FLAGS = ("elastic", "max_restarts", "heartbeat_timeout")


def _child_argv(parser: argparse.ArgumentParser, args) -> list[str]:
    """The parsed options as an argv for the supervised child, without
    the supervisor's own flags (built from the parsed options, not
    sys.argv, so programmatic calls supervise the intended command)."""
    argv: list[str] = []
    for action in parser._actions:
        if not action.option_strings or action.dest in _SUPERVISOR_FLAGS \
                or action.dest == "help":
            continue
        value = getattr(args, action.dest)
        if isinstance(action, argparse._StoreTrueAction):
            if value:
                argv.append(action.option_strings[0])
        elif isinstance(action, argparse.BooleanOptionalAction):
            # --flag / --no-flag: the first option string is the positive.
            argv.append(action.option_strings[0 if value else 1])
        elif value is not None:
            argv.extend([action.option_strings[0], str(value)])
    return argv


def _run_elastic(parser: argparse.ArgumentParser, args) -> None:
    """Re-execute this entry point under the failure supervisor: a crash
    or heartbeat stall relaunches it with --resume, restoring the latest
    checkpoint and continuing at the right epoch."""
    import os

    from ..utils.supervisor import supervise

    if not args.checkpoint_dir:
        parser.error("--elastic requires --checkpoint-dir to resume into")
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    child = [sys.executable, "-m", "pytorch_distributed_training_tpu_torch"
             ".cli.main", *_child_argv(parser, args)]
    result = supervise(
        child, max_restarts=args.max_restarts,
        heartbeat_path=os.path.join(args.checkpoint_dir, ".heartbeat"),
        heartbeat_timeout_s=args.heartbeat_timeout,
    )
    if result.restarts or result.hung_kills or result.preemptions:
        print(f"supervisor: finished after {result.restarts} restarts "
              f"({result.hung_kills} hang kills, {result.preemptions} "
              f"preemptions), exit {result.exit_code}")
    # Signal deaths (negative Popen codes) map to the 128+N shell
    # convention (SIGKILL -> 137).
    code = result.exit_code
    sys.exit(128 + abs(code) if code < 0 else code)


def _run_elastic_resize(args) -> None:
    """One scripted elastic episode over the process group's ranks: the
    JAX CLI's ``--elastic-resize``.  Parses the elastic fault plan, runs
    the episode (shrink on slice loss, peer-RAM restore, grow-back; every
    rank takes part) and prints the audited outcome from rank 0.
    Deterministic: the same spec and seed replay the identical episode.
    JAX's refusals (a bad plan, a world that does not form 2 slices of 2
    or more ranks) exit with its messages."""
    import json
    import os

    from ..comm import init as comm_init
    from ..obs import MetricsEmitter
    from ..resilience.elastic import ElasticConfig, run_elastic_episode
    from ..resilience.faults import parse_elastic_faults
    from ..utils.device import resolve_device

    try:
        faults = parse_elastic_faults(args.elastic_resize)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    # Run past the last scripted fault so detection (patience) and the
    # grow-back both land inside the episode.
    n_steps = max(8, max((f.step for f in faults), default=0) + 3)
    cadence = args.snapshot_every_steps or 2
    config = ElasticConfig(snapshot_every_steps=min(cadence, n_steps))
    state_dir = (os.path.join(args.checkpoint_dir, ".elastic_state")
                 if args.checkpoint_dir else None)
    device = resolve_device("cpu" if args.use_cpu else None)
    if args.distributed:
        comm_init.initialize(device)
    try:
        rank = comm_init.process_index()
        emitter = (MetricsEmitter(args.metrics_dir, rank=0, world=1)
                   if rank == 0 else None)
        try:
            report = run_elastic_episode(
                faults=faults, n_steps=n_steps, config=config,
                seed=args.seed or 0, emitter=emitter, state_dir=state_dir,
                device=device,
            )
        except ValueError as e:
            raise SystemExit(str(e)) from None
        finally:
            if emitter is not None:
                emitter.summary()
                emitter.close()
    finally:
        comm_init.shutdown()
    if rank:
        return
    ledger = report["ledger"]
    print(f"elastic: world {report['world']['initial']} -> "
          f"{report['world']['final']} over {len(report['transitions'])} "
          f"transitions, final step {report['final_step']}")
    for t in report["transitions"]:
        print(f"elastic: {t['transition']}@{t['step']} "
              f"{t['world_from']} -> {t['world_to']}")
    print(f"elastic: peer restore bit-identical: "
          f"{report['restore_bit_identical']}; ledger identity_ok: "
          f"{ledger['identity_ok']} "
          f"(rework {ledger['seconds']['rework']:.3f}s of "
          f"{ledger['wall_s']:.3f}s wall)")
    print("elastic: counters " + json.dumps(report["counters"],
                                            sort_keys=True))


def main(argv: list[str] | None = None):
    parser = build_parser()
    args = parser.parse_args(argv)
    _check_grad_sync(parser, args)
    _check_sharding(parser, args)
    _check_telemetry(parser, args)
    if args.elastic:
        return _run_elastic(parser, args)
    if args.elastic_resize is not None:
        return _run_elastic_resize(args)
    if args.ckpt_every_steps and not args.checkpoint_dir:
        parser.error("--ckpt-every-steps requires --checkpoint-dir")
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
    from ..comm import init as comm_init
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.use_cpu else None)
    # A --serve-tp run joins its torchrun group first: each rank's
    # telemetry is its own.
    _check_serve_scale(args.serve_tp, args.serve_replicas)
    joined = args.serve_tp > 1 and not comm_init.is_initialized()
    rank, world = _serve_world(args.serve_tp, args.serve_replicas, device)
    tel = _Telemetry(args, rank=rank, world=world, mode="serve",
                     device=device)
    result = None
    try:
        result = run_serve(
            model=args.model, overrides=overrides, precision=args.precision,
            seed=args.seed, seq_len=args.seq_len,
            metrics_jsonl=args.metrics_jsonl, n_requests=args.serve_requests,
            rate=args.serve_rate, num_slots=args.serve_slots,
            max_new=args.serve_max_new,
            prefill_chunk=args.serve_prefill_chunk,
            spec_k=args.serve_spec_k if args.serve_spec else 0,
            spec_ngram=args.serve_spec_ngram,
            device="cpu" if args.use_cpu else None,
            paged=args.serve_paged, block_size=args.serve_block_size,
            num_blocks=args.serve_num_blocks, kv_dtype=args.serve_kv_dtype,
            kv_host_mb=args.serve_kv_host_mb,
            checkpoint_dir=args.checkpoint_dir, emitter=tel.live_emitter,
            spans=tel.spans, slo_policy=tel.slo, ttl=args.serve_ttl,
            tp=args.serve_tp, replicas=args.serve_replicas,
            affinity=args.serve_affinity, disagg=args.serve_disagg,
            inject_faults=args.serve_inject_faults,
            failover=args.serve_failover,
            retry_budget=args.serve_retry_budget,
            brownout_s=args.serve_brownout_s,
            autoscale=args.serve_autoscale,
            autoscale_min=args.serve_autoscale_min,
            autoscale_max=args.serve_autoscale_max,
            autoscale_up_depth=args.serve_autoscale_up_depth,
            autoscale_down_idle=args.serve_autoscale_down_idle,
            autoscale_cooldown=args.serve_autoscale_cooldown,
            priority=args.serve_priority,
            healthz_stale_s=args.healthz_stale_s, ops_server=tel.server,
        )
    finally:
        tel.close(**({"serve": result["summary"]}
                     if result and result["summary"] else {}))
        if joined:
            comm_init.shutdown()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
