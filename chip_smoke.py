#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

First runs the port's AST lint (``analysis/lint.py``) in process over the
package and this script: no finding, or the run fails.  Then builds the
port's CUDA kernels from the sources in this checkout (nvcc,
one process per source, all at once, into build/torch_kernels/) and the
native data library (g++, csrc/fastbatch.cpp, into build/fastbatch/), holds
each kernel against its plain PyTorch version and times both, then drives
the port's main paths:

- serving: the ``--serve`` CLI serving GPT-2 124M (bf16, fresh weights
  from the seed) over the contiguous cache with and without speculative
  decoding, and over the paged pool plainly, with speculative decoding and
  with int8 KV, checking that every request completed and that the
  attention kernels carried every decode, verify and prefill tick; every
  single-process engine captures its programs as CUDA graphs once, at
  construction, and replays them (``PROGRAM_REGISTRY`` holds one record
  a program of each engine built, and nothing more), and the greedy
  tokens equal those of the same run with ``cuda_graphs=False`` (the
  contiguous, speculative, paged, paged speculative, int8 and
  shared-prefix runs; ``serve_graphs``, ``graph_check``) (the
  speculative paged run with telemetry on: ``--metrics-dir --trace --slo
  --metrics-port 0``, its 16 request span chains whole, its tick spans
  equal to its decode ticks, each TTFT its queued and prefill spans,
  ``/metrics``, ``/healthz`` and ``/slo`` answering 200 mid-run and the
  live TTFT p99 equal to the log's); the disaggregated tier
  (``--serve-disagg 2:6``, paged with a host tier and contiguous: 16
  handoffs, the prefill role's and the decode role's kernel launches
  counted apart); a scripted engine run at full width serves
  shared-prefix traffic through the prefix cache, then a two-replica
  ``ReplicaRouter`` on the card (affinity hits, a rebalance with a
  sibling fetch, the fetched blocks bitwise equal across the pools, the
  counters equal to the telemetry); the serving fleet's controllers
  (``fleet_phase``, each router under a virtual clock): F1 two paged
  replicas with a replica crash and a stall (failover: one death, its
  work drained and requeued, one respawn at the backoff's tick with the
  card's allocations unchanged, tokens equal to a faultless run up to
  each requeue point), F2 the disaggregated tier losing its prefill
  role and then a parked handoff (the role revived, the orphan
  requeued, the shared pool's audit clean), A1 three replicas under
  the autoscale controller (a scale-up and a scale-down with their
  causes, no allocation across a revive, ``/slo``'s controller block);
  lockstep ``generate`` runs at full width; a small f32 model's slot-mode logits on the card are checked
  against the host; #9-#12 are also held and timed at the heads a rank
  holds in the TP runs (``TP_KERNEL_CASES``: 3 under ``--serve-tp 4``, 6
  under ``--serve-tp 2``);
- training: the CLI trains GPT-2 at full width (124M at 1024 and 512
  positions with gradient accumulation, XL widths at 1024, 2048
  positions, and the main run again with remat and chunked CE), each run
  routed to the flash kernels that port one TPU tiling, with the flash
  launch counts checked exactly and no attention outside the kernels; a
  small f32 model trains three steps on the card and on the host from the
  same weights and must agree; T6 the MoE GPT-2 (``gpt2_moe``: 124M
  widths, 8 experts in every odd block, 322,634,544 parameters) on T1's
  recipe, 3 steps in the CLI's scatter dispatch (flash #4/#5 counted
  exactly, the drop rate a fraction; tokens/s, step time, peak memory)
  and two steps of the same batches in einsum mode, its losses, drop
  rates and update of the MoE leaves held to scatter's;
- image classification, which runs none of the kernels (convolutions,
  pooling and the head are cuDNN/cuBLAS calls, the norms the port's
  BatchNorm functions): R1 the reference's own run through the CLI
  (ResNet-18, CIFAR-10-shaped synthetic data, batch 32, adam lr 0.1, f32,
  100 steps; images/s and step time), then the same command reading a
  CIFAR-10 archive of random bytes through the native gather (the
  gathers counted); R2 ResNet-50 at ImageNet width (224 px, 1000
  classes, bf16, batch 128, sgd, 40 steps; images/s/chip, step time, peak
  memory, analytic MFU); R3 ResNet-18 on ``shapes``, whose loss must fall
  below its start and below chance within 150 steps; R4 a shallow f32
  ResNet trains three steps on the card (TF32 off) and on the host from
  the same weights and must agree;
- data parallel (the reference's DDP), D1, D2 and V2 one one-rank
  ``torch.distributed.run`` of the port (the rank runs this script as
  ``--cli-runs-leg OUT SPEC --cli-joins``: the NCCL group kept across
  the three CLI runs), read back through ``--metrics-jsonl``: D1 R2's
  command with ``--distributed`` (a one-rank NCCL group: sync-BN and the
  gradient all-reduce on the path), D2 T1's recipe with
  ``--distributed`` (2 epochs of 8 steps, the flash launches counted in
  the rank), D3 two ranks on the one card over gloo (a shallow ResNet
  and a 2-layer GPT-2, f32, TF32 off, 3 steps): the ranks bit-identical
  and within 1e-4 of one process;
- ViT-B/16 (BASELINE configs[2]) on packed ImageNet-format records of
  random bytes written by the port's ``synthesize_packed_images``: V1
  the CLI at full width (224 px, 1000 classes, bf16, batch 128, adamw,
  40 steps; the native uint8 crop counted; images/s, step time, analytic
  MFU, peak memory), V2 V1 with ``--distributed`` (one NCCL rank, one
  gradient ``pmean`` a step and no other all-reduce), V3 the ``auto``
  layout under ``PDT_FORCE_ATTN=flash`` (the flash kernels at L 197,
  launches counted exactly) timed in turns against the default ``bhld2``
  layout and ``auto`` under ``PDT_FORCE_ATTN=xla``, V4 a shallow f32 ViT
  three steps card against host (TF32 off), and R2p R2's ResNet-50
  command reading the same packed file;
- checkpoint and resume (T1 writes its step-8 checkpoint as it trains):
  C0 what a save of T1's state (GPT-2 124M, 1.49 GB) and of R2's costs
  (host stall, commit, restore) and the torn-save check on the card, C1
  T1's command preempted by ``sigterm@4`` (exit 75) and resumed, its
  flash launches and step-8 checkpoint equal to T1's, both processes
  under ``--metrics-dir --trace --goodput`` (valid logs, each ledger
  summing to its wall with no rework, the ``compiled_cost`` FLOPs within
  10 % of the analytic count) and the resumed one profiling steps 5-6
  (the trace's flash forward kernels counted), C2 R2's command
  under ``--elastic`` with ``crash@7``, its step-12 checkpoint equal to
  the uninterrupted run's, C3 the multi-node shape of configs[4] (two
  ``torch.distributed.run`` nodes of one rank, static rendezvous, gloo on
  the one card) and its step-2 checkpoint resumed by one process;
- device-resident datasets (``--device-cache``): DC1 R1, DC2 R2p's
  ResNet-50 and V1's ViT-B/16 on the packed records, DC3 T1 on a token
  file written from the seed, each beside its loader run, with a
  profiled window's busy share and host-to-device copies a step (none
  allowed with the cache), DC4 DC1's cached command preempted and
  resumed, bitwise;
- the skip gate (``--skip-bad-steps``): G1 T1 with and without it,
  bitwise alike, and its cost a step in turns; G2 R1 with ``nan_batch``
  and ``spike_batch``, the NaN step skipped with the parameters
  unchanged; G3 a threshold under every clean norm: a rollback, an abort
  and the supervisor's relaunch failing alike.
- the two-tier gradient sync (``--grad-sync``), ranks of
  ``torch.distributed.run`` on the one card over gloo (NCCL takes one
  rank a card) in 2 slices of 2: H0 the codecs (int8, int4, top-k, the
  bf16 payload's int16 view) on GPT-2 124M's ``hier-int8`` bucket layout,
  card against host bitwise, each encode and decode timed per bucket; H1
  a 2-layer f32 GPT-2, the five modes against flat (the step-1 loss
  within 1e-5, weights within 10x the JAX package's tolerances, the
  error-feedback residual non-zero) and ``hier-int8`` striped and
  pipelined bitwise serial; H2 GPT-2 124M on T1's recipe under flat and
  under ``hier-int8`` with stripe ``auto`` and the phase pipeline, H1
  and H2 in one torchrun (``--grad-sync-leg``): ranks bit-identical, the step-3 losses
  within ``H2_INT8_LOSS_BOUND``, flash #4/#5 counted, step and sync
  times (gloo's on one card);
- elastic resizing (``resilience/elastic.py``), in the same torchrun,
  the 4 ranks as 2 slices of 2: EL0 the JAX package's own episode (its
  tiny f32 GPT-2, ``slice_lost@4:1,slice_return@9``, 12 steps) and EL1
  GPT-2 124M at L 1024 under T1's bf16 policy (global batch 16,
  ``slice_lost@2:1,slice_return@6``, 9 steps, flash #4/#5 counted):
  the transitions, the peer restore bit-identical, every step's batch
  the oracle's, the accumulation, the ledger's integer-ns categories;
  EL1's losses within ``EL1_LOSS_BOUND`` and its final state within
  ``M1_STATE_BOUND`` of an uninterrupted run of the same batches; the
  host times of a step at world 4 and 2, a peer put, the restore and
  the grow transfer;
- sharded training (``--fsdp``, ``--tensor-parallel``, ``--zero1``,
  ``--sequence-parallel``), 4 ranks of ``torch.distributed.run`` on the
  one card over gloo: M0 each layout (fsdp 4, data 2 x fsdp 2, TP 2 and
  4, ZeRO-1 flat and under ``hier-int8``, ring and Ulysses at sequence
  2, both under TP 2 too) on the JAX package's tiny GPT-2, and fsdp 2 on
  R4's shallow ResNet, f32 with TF32 off, against one process: the
  first batch's loss, logits and gradients at the JAX tests'
  tolerances, 3 steps' losses, weights (ZeRO-1's relative 1e-4) and
  weight updates (relative 1e-2); ZeRO-1 under ``hier-int8`` is held at
  those bounds to data parallelism under the same sync (the same
  quantized sums), and both to one process within Adam's 2 lr a step;
  M1 T1's recipe at GPT-2 124M's widths cut to ``GLOO_LAYERS`` blocks
  through the CLI under flat, ``--fsdp 4``,
  ``--zero1``, ``--tensor-parallel 2`` and Ulysses ``--sequence-parallel
  2``: losses against flat within ``M1_LOSS_BOUND``, the step-3
  checkpoint's weights and Adam slots against flat's within
  ``M1_STATE_BOUND``, each rank's state bytes within 10 % of
  ``M1_STATE_GB``, peak memory and step time, flash #4/#5 counted; M2
  the ``--fsdp 4`` run's step-2 checkpoint resumed under ``--zero1`` at
  world 2 (its step-3 checkpoint within ``M1_STATE_BOUND`` of the
  uninterrupted run's) and under ``--fsdp 4`` (bitwise); E0 JAX's tiny
  MoE GPT-2 under expert 4, data 2 x expert 2, expert 2 x tensor 2 and
  data 4 at a capacity that drops tokens (routed over the global batch),
  f32 with TF32 off, against one process at M0's tolerances.  M0, E0,
  M1 and M2's ``--fsdp 4`` resume run in one torchrun
  (``--sharded-leg``).
  The flash check also holds the kernels at the heads a rank holds
  there (H 6, H 3);
- pipeline parallelism (``--pipeline-parallel``), 4 ranks of one
  ``torch.distributed.run`` on the one card over gloo (``--pipeline-leg``):
  P0 every schedule (gpipe, 1f1b, interleaved) at PP 4 and PP 2 x data
  2, ``--pp-compress`` bf16 and int8 under each, stripe 2, and PP 2 x
  fsdp 2, x TP 2 and x ring SP 2 on the JAX package's pipeline-test
  GPT-2, f32 with TF32 off, against one process (loss, every gradient
  and 3 steps at the JAX tests' tolerances; the compressed runs within
  JAX's band; stripe 2 bitwise stripe 1); P1 T1's recipe at
  ``GLOO_LAYERS`` blocks through the CLI in the same torchrun, PP 4 with
  8 microbatches under gpipe, gpipe ``--remat``, 1f1b and 1f1b
  ``--pp-compress int8``, PP 2 x data 2 under 1f1b and interleaved (2
  chunks), against flat (the sharded phase's M1 flat run): step-3
  losses within ``P1_LOSS_BOUND`` of flat's, step-3 checkpoints within
  ``M1_STATE_BOUND`` of flat's, flash #4/#5 counted exactly, state
  bytes, peak memory and step times a rank; P2 the 1f1b run's step-2
  checkpoint resumed under PP 4 (bitwise), PP 2 x data 2 and flat at
  world 1 (step-3 losses and checkpoints held to the 1f1b run's); P3
  GPipe x MoE, ``gpt2_moe`` on T1's recipe at PP 2 x data 2 against
  T6's scatter run, step-3 loss within ``P1_LOSS_BOUND``.  In the same
  torchrun GPT-2 124M serves (bf16, speculative) under ``--serve-tp 4``
  (contiguous) and as two tensor-parallel replicas, ``--serve-tp 2
  --serve-replicas 2`` (paged; rank 0's router drives its own group and
  the other group's leader), with and without a crash of replica 1:
  every rank's kernel launches at its local heads counted, the first
  prefill tick's logits held to the one-process runs', the remote calls
  and the failover block printed; the JAX tests' tiny f32 GPT-2 at TP 2,
  at TP 4 and as TP 2 x 2 replicas behind one router (with and without
  a crash) gives one process's greedy tokens and routing, and a prefix
  fetched between the groups is each rank's shard bit for bit.  P1's
  ``1f1b_int8`` run writes its four rank logs (``--metrics-dir``):
  ``merge_timeline`` aligns them, and the ``pp_compress_model`` record
  and the per-step ``pp_boundary_bytes`` counters equal the model.  The
  flash check holds
  the kernels at the pipeline's microbatch (B 2, H 12).

Each phase prints its lines; any failed check ends the run with a
traceback and a non-zero exit.  The last lines are the kernel table
(JSON), the card's name and power limit, and the result object.  Without
a CUDA device, or without the port package beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

SOURCE = "pytorch_distributed_training_tpu_torch/csrc/decode_attention.cu"
PAGED_SOURCE = "pytorch_distributed_training_tpu_torch/csrc/paged_attention.cu"
FLASH_SOURCE = "pytorch_distributed_training_tpu_torch/csrc/flash_attention.cu"
PALLAS = "pytorch_distributed_training_tpu/ops/pallas_attention.py"
# Rows #1-#8: the TPU flash kernels (def line) by row number.
FLASH_ROWS = {
    1: ("_flash_fwd_single", 224), 2: ("_flash_fwd_single_nlhd", 302),
    3: ("_flash_bwd_nlhd", 380), 4: ("_flash_fwd_grouped", 594),
    5: ("_flash_bwd_grouped", 633), 6: ("_flash_fwd", 712),
    7: ("_flash_bwd_single", 918), 8: ("_flash_bwd", 949),
}
TPU_KERNELS = {
    "decode_attention":
        "pytorch_distributed_training_tpu/ops/pallas_attention.py:1221",
    "decode_attention_multi":
        "pytorch_distributed_training_tpu/ops/pallas_attention.py:1295",
    "paged_decode_attention":
        "pytorch_distributed_training_tpu/ops/pallas_attention.py:1471",
    "_paged_multi_call":
        "pytorch_distributed_training_tpu/ops/pallas_attention.py:1643",
}
# Data-sheet memory bandwidth (bytes/s) by card; dense peak rates (op/s)
# of the H100 SXM at 700 W, from NVIDIA's data sheet.
BANDWIDTH = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
             ("H100", 3.35e12))
PEAK_OPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# The flash kernels at the heads a rank holds under the sharded paths:
# label -> (batch, length, heads), causal bf16.
SHARDED_FLASH = {"H6 (TP 2 / Ulysses 2, M1)": (4, 1024, 6),
                 "H3 (TP 4)": (8, 1024, 3),
                 # The pipeline's microbatch (P1: 16 rows in 8).
                 "B2 H12 (PP 4 x 8 microbatches, P1)": (2, 1024, 12)}
# The serving shapes of GPT-2 124M: 8 slots, 12 heads, 1024 positions,
# head dim 64; one index per row, sentinel (1024) included.
B, H, L, DH = 8, 12, 1024, 64
INDEX = [0, 5, 100, 511, 1000, 1023, 1024, 300]
LAYERS = 12
# The paged pool at the same serving shapes: blocks of 16 positions, a
# 64-entry table per row (1024 positions), 512 physical blocks.
BS, NB, NBLOCKS = 16, 64, 512
VOCAB = 50257
# The flash kernels' timed shapes (bf16, causal, head dim 64) and the TPU
# tiling each routes to in the JAX package's flash_attention
# (tests/test_torch_flash_attention.py pins the routing with its helpers).
FLASH_SHAPES = {
    "A": {"batch": 16, "seq": 512, "heads": 12, "fwd": 2, "bwd": 3},
    "B": {"batch": 8, "seq": 1024, "heads": 12, "fwd": 4, "bwd": 5},
    "C": {"batch": 2, "seq": 1024, "heads": 25, "fwd": 1, "bwd": 7},
    "D": {"batch": 2, "seq": 2048, "heads": 12, "fwd": 6, "bwd": 8},
}
# The TPU rows JAX's flash_attention takes for ViT-B/16's L 197 (padded to
# 256, heads-fused single tile): #2 forward, #3 backward
# (tests/test_torch_vit.py pins the routing).
VIT_FLASH_ROWS = (2, 3)
SERVE_ARGV = ["--serve", "--model", "gpt2", "--precision", "bf16",
              "--seq-len", "512", "--serve-requests", "16",
              "--serve-slots", "8", "--serve-max-new", "64",
              "--serve-rate", "0"]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def ptxas_lines(report: str) -> list[str]:
    """One line per kernel of a ``-Xptxas -v`` report: its template
    arguments, registers, barriers and shared memory, and its spills."""
    storage = {"0": "f32", "1": "bf16", "2": "int8", "3": "int4"}
    dtype = {"f": "f32", "13__nv_bfloat16": "bf16"}
    lines, name, spill = [], None, ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = m.group(1), ""
            k = re.search(r"(paged_attention_kernel)ILi(\d)E(f|13__nv_bfloat16)"
                          r"Li(\d+)E", name)
            c = re.search(r"(paged_combine_kernel)I(f|13__nv_bfloat16)E", name)
            d = re.search(r"(decode_attention_kernel)I(f|13__nv_bfloat16)"
                          r"Li(\d)E", name)
            if k:
                name = (f"{k.group(1)}<{storage[k.group(2)]}, q "
                        f"{dtype[k.group(3)]}, Dh <= {k.group(4)}>")
            elif c:
                name = f"{c.group(1)}<{dtype[c.group(2)]}>"
            elif d:
                name = f"{d.group(1)}<{dtype[d.group(2)]}, C = {d.group(3)}>"
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and name:
            lines.append(f"{name}: {ln.split(':', 1)[-1].strip()}; {spill}")
            name = None
    return lines


def lint_phase(repo: str, card: str) -> float:
    """The port's lint over the package and this script, on the host:
    every rule, no finding (a finding fails the run).  Its seconds."""
    from pytorch_distributed_training_tpu_torch.analysis.lint import (
        DEFAULT_LINT_TARGETS, RULES, iter_python_files, lint_paths,
    )

    t0 = time.monotonic()
    files = iter_python_files(DEFAULT_LINT_TARGETS, repo)
    findings = lint_paths(root=repo)
    seconds = time.monotonic() - t0
    for f in findings:
        print(f.format(), flush=True)
    print(f"LINT: {len(files)} files, {len(RULES)} rules, {len(findings)} "
          f"findings, {seconds:.2f} s ({card})", flush=True)
    check(not findings, f"the lint reports {len(findings)} finding(s)")
    return seconds


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def bandwidth_of(name: str) -> float:
    for key, bw in BANDWIDTH:
        if key in name:
            return bw
    raise RuntimeError(f"no data-sheet bandwidth for card {name!r}")


def time_ms(torch, fn, reps: int = 50) -> float:
    """Median device time of one call (CUDA events), with the 50 MB L2
    flushed before each call: in serving, each layer's cache is cold.  The
    flush writes 1 GiB (~0.3 ms), so the host has enqueued the call before
    the device reaches the start event and no launch latency is timed."""
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn, reps: int = 200) -> float:
    """Host time of one call in us: ``reps`` calls enqueued back to back
    with no sync between them (the device queue stays short of full, so
    the host never waits), over ``reps``: what a serving tick pays per
    layer on the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def bound_ms(index, c: int, dtype, bandwidth: float,
             heads: int = H) -> tuple[float, str]:
    """Least time for the work these inputs need: the visible K/V prefix
    read once plus q, out and index, against the flops of QK^T and PV."""
    item = 2 if "bfloat16" in str(dtype) else 4
    keys = [min(i + c, L) for i in index]
    per_query = [min(i + j + 1, L) for i in index for j in range(c)]
    nbytes = (2 * sum(keys) * heads * DH * item
              + 2 * B * c * heads * DH * item + 4 * B)
    ops = 4 * sum(per_query) * heads * DH
    t_bytes, t_ops = nbytes / bandwidth, ops / PEAK_OPS[str(dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, da, seed: int, bandwidth: float) -> dict:
    """Each kernel against its plain version at the serving shapes, f32
    (atol 1e-5) and bf16 (atol 2e-3, rtol 1e-2: an output one bf16 ulp
    off, about four times a sound run's largest error), then timed in bf16
    at C = 1, 5 and 8, each with its ratio to SDPA and to its bound and the
    host time a wrapper call costs; then a row whose first query sees no
    key (index -1: the mean of V) and L 8192 at C 8 against the plain
    version."""
    import torch.nn.functional as F

    bf16_tol = (torch.bfloat16, 2e-3, 1e-2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    index = torch.tensor(INDEX, dtype=torch.int32, device="cuda")
    k32 = torch.randn(B, H, L, DH, generator=gen, device="cuda")
    v32 = torch.randn(B, H, L, DH, generator=gen, device="cuda")
    results = {}
    for name, c in (("decode_attention", 1), ("decode_attention_multi", 5),
                    ("decode_attention_multi", 8)):
        for dtype, atol, rtol in ((torch.float32, 1e-5, 0.0), bf16_tol):
            k, v = k32.to(dtype), v32.to(dtype)
            q = torch.randn(B, c, H, DH, generator=gen, device="cuda").to(dtype)
            if c == 1:
                def kernel(q=q, k=k, v=v):
                    return da.decode_attention(q[:, 0], k, v, index)[:, None]
            else:
                def kernel(q=q, k=k, v=v):
                    return da.decode_attention_multi(q, k, v, index)

            out = kernel()
            ref = da.decode_attention_multi_plain(q, k, v, index)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            check(bool(torch.isfinite(out.float()).all()), f"{name} C={c} finite")
            ok = bool((err <= atol + rtol * ref.float().abs()).all())
            check(ok, f"{name} C={c} {dtype} within atol {atol} rtol {rtol} "
                      f"(max err {err.max().item():.3g})")
            split = da.decode_split(B, H, L, c, DH, da.sm_count(q.device),
                                    q.element_size())
            line = (f"kernel {name} C={c} {str(dtype)[6:]}: max_abs_err "
                    f"{err.max().item():.3g} (atol {atol}, rtol {rtol}); "
                    f"decode_split S={split.cluster} share "
                    f"{split.share_keys} keys, ring tile {split.tile_keys}, "
                    f"{split.smem_bytes} B shared a block")
            if dtype is torch.bfloat16:
                mask = (torch.arange(L, device="cuda")[None, None, :]
                        <= index[:, None, None].long()
                        + torch.arange(c, device="cuda")[None, :, None])
                qt = q.transpose(1, 2)
                ms = time_ms(torch, kernel)
                plain_ms = time_ms(
                    torch, lambda: da.decode_attention_multi_plain(q, k, v, index)
                )
                library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, k, v, attn_mask=mask[:, None]))
                bms, by = bound_ms(INDEX, c, dtype, bandwidth)
                # The host time of one wrapper call, as the model calls it.
                if c == 1:
                    q0 = q[:, 0]
                    host = host_us(
                        torch, lambda: da.decode_attention(q0, k, v, index))
                else:
                    host = host_us(torch, kernel)
                variant = dict(chunk=c, max_abs_err=err.max().item(), ms=ms,
                               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                               library_ms=library_ms, host_us=host)
                row = results.setdefault(name, dict(
                    name=name, route="cuda", source=SOURCE,
                    replaces=TPU_KERNELS[name], launches=0, variants=[],
                ))
                row["variants"].append(variant)
                # The headline numbers: C = 1 (#9) and C = 5 (#10, the
                # speculative verify chunk of the serving runs).
                if c in (1, 5):
                    row.update({key: variant[key] for key in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")})
                line += (f"; kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f}"
                         f" us, sdpa {library_ms * 1e3:.1f} us, bound "
                         f"{bms * 1e3:.2f} us ({by}); {ms / library_ms:.2f}x "
                         f"sdpa, {ms / bms:.1f}x bound, host {host:.1f} us a "
                         "call")
            print(line, flush=True)

    # A chunk that starts before position 0 (row 0 at -1, row 1 at -2):
    # its first queries see no key and return the mean of V over all L
    # positions, as the TPU kernel does.
    neg = torch.tensor([-1, -2] + INDEX[2:], dtype=torch.int32, device="cuda")
    for dtype, atol, rtol in ((torch.float32, 1e-5, 0.0), bf16_tol):
        k, v = k32.to(dtype), v32.to(dtype)
        q = torch.randn(B, 5, H, DH, generator=gen, device="cuda").to(dtype)
        out = da.decode_attention_multi(q, k, v, neg)
        ref = da.decode_attention_multi_plain(q, k, v, neg)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        mean_v = v.float()[0].mean(dim=1)
        mean_err = (out[0, 0].float() - mean_v).abs()
        check(bool((err <= atol + rtol * ref.float().abs()).all())
              and bool((mean_err <= atol + rtol * mean_v.abs()).all()),
              f"index -1 row {dtype}: max err {err.max().item():.3g}, "
              f"to the mean of V {mean_err.max().item():.3g}")
        print(f"kernel decode_attention_multi C=5 {str(dtype)[6:]} index -1 "
              f"row: max_abs_err {err.max().item():.3g}, query 0 to the mean "
              f"of V {mean_err.max().item():.3g}", flush=True)

    # L 8192 at C 8: shares of 1024 keys through a refilled ring.
    long_len = 8192
    kl = torch.randn(4, H, long_len, DH, generator=gen, device="cuda")
    vl = torch.randn(4, H, long_len, DH, generator=gen, device="cuda")
    long_index = torch.tensor([8184, long_len, 3000, 5], dtype=torch.int32,
                              device="cuda")
    for dtype, atol, rtol in ((torch.float32, 1e-5, 0.0), bf16_tol):
        k, v = kl.to(dtype), vl.to(dtype)
        q = torch.randn(4, 8, H, DH, generator=gen, device="cuda").to(dtype)
        out = da.decode_attention_multi(q, k, v, long_index)
        ref = da.decode_attention_multi_plain(q, k, v, long_index)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        check(bool((err <= atol + rtol * ref.float().abs()).all()),
              f"L {long_len} C 8 {dtype}: max err {err.max().item():.3g}")
        split = da.decode_split(4, H, long_len, 8, DH, da.sm_count(q.device),
                                q.element_size())
        print(f"kernel decode_attention_multi C=8 L={long_len} "
              f"{str(dtype)[6:]}: max_abs_err {err.max().item():.3g}; "
              f"decode_split S={split.cluster} share {split.share_keys} keys, "
              f"ring tile {split.tile_keys}", flush=True)
    return results


@contextlib.contextmanager
def first_logits(torch, box: dict, key: str):
    """While the CLI serves in this process: the LM head's first output
    (the first prefill tick's logits, (slots, vocab) f32) kept on the
    host as ``box[key]``."""
    from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2

    head = GPT2.head

    def first(self, x):
        out = head(self, x)
        if key not in box:
            box[key] = out.detach().float().cpu()
        return out

    GPT2.head = first
    try:
        yield
    finally:
        GPT2.head = head


@contextlib.contextmanager
def serve_graphs(graphs: bool = True):
    """While a serving leg runs: every ``ServingEngine`` it builds (the
    CLI's, a disaggregated tier's two roles, a router's replicas), built
    with ``cuda_graphs=graphs`` (``tools/serve_profile.py``'s
    ``engines_built``).  Yields ``{"engines": [...], "base":
    PROGRAM_REGISTRY.snapshot()}`` taken before the first of them, for
    ``graph_check``."""
    from pytorch_distributed_training_tpu_torch.analysis.signature import (
        PROGRAM_REGISTRY,
    )
    from pytorch_distributed_training_tpu_torch.tools.serve_profile import (
        engines_built,
    )

    base = PROGRAM_REGISTRY.snapshot()
    with engines_built(graphs) as engines:
        yield {"engines": engines, "base": base}


def graph_check(label: str, run: dict) -> str:
    """The recompile guard over a leg run under ``serve_graphs()``: every
    engine captured its programs as CUDA graphs, ``PROGRAM_REGISTRY``
    holds since the leg began one record a program of each engine built
    and nothing more (none captured again across the trace, a reset, a
    respawn or a second wave), and the graphs were replayed.  Returns
    the note for the leg's line: engines, captures, replays, pools."""
    import collections

    from pytorch_distributed_training_tpu_torch.analysis.signature import (
        PROGRAM_REGISTRY,
    )

    engines = run["engines"]
    want = collections.Counter(
        (f"serve/{name}", sig) for e in engines
        for name, sig in e.program_signatures.items())
    got = PROGRAM_REGISTRY.compiles_since(run["base"])
    check(bool(engines) and all(e.cuda_graphs for e in engines),
          f"{label}: every engine captured its programs as CUDA graphs")
    check(got == dict(want),
          f"{label}: one capture a program of each of {len(engines)} "
          f"engine(s) and none again ({got} vs {dict(want)})")
    stats = [e.program_stats() for e in engines]
    progs = [p for st in stats for p in st["programs"].values()]
    replays = sum(p["replays"] for p in progs)
    check(replays > 0, f"{label}: the graphs replayed")
    capture = [p["capture_s"] * 1e3 for p in progs]
    pools = ["not measured" if st["graph_pool_bytes"] is None
             else f"{st['graph_pool_bytes'] / 2**20:.0f}" for st in stats]
    return (f"graphs: {len(engines)} engine(s), {len(progs)} programs "
            f"captured once ({min(capture):.1f}-{max(capture):.1f} ms a "
            f"capture), {replays} replays, pools {'/'.join(pools)} MiB")


def warm_launches(run: dict) -> dict:
    """The kernel launches the engines' warm-ups before their captures
    made, by wrapper name (counted on the wrappers as any launch is)."""
    out: dict = {}
    for e in run["engines"]:
        for p in e.program_stats()["programs"].values():
            for name, n in p["warmup_launches"].items():
                out[name] = out.get(name, 0) + n
    return out


def serving_phase(torch, da, seed: int, carry: dict) -> tuple[dict, dict]:
    """The main path: the CLI serving GPT-2 124M in bf16, once plainly and
    once with speculative decoding (k = 4), its engine replaying its
    programs as CUDA graphs (``graph_check``); then each again with
    ``cuda_graphs=False``, whose greedy tokens must be the same.  The
    eager speculative run's first prefill logits and the tokens go to
    ``carry`` (the one-process reference of the tensor-parallel runs,
    ``pipeline_phase``)."""
    from pytorch_distributed_training_tpu_torch.cli.main import main as cli

    argv = SERVE_ARGV + ["--seed", str(seed)]
    runs, launches = {}, {"decode_attention": 0, "decode_attention_multi": 0}
    for spec in (False, True):
        extra = ["--serve-spec", "--serve-spec-k", "4"] if spec else []
        label = "spec" if spec else "plain"
        da.decode_attention.launches = 0
        da.decode_attention_multi.launches = 0
        with serve_graphs() as run:
            res = cli(argv + extra)
        n9 = da.decode_attention.launches
        n10 = da.decode_attention_multi.launches
        note = graph_check(f"serve {label}", run)
        warm = warm_launches(run)
        with serve_graphs(False), first_logits(
                torch, carry, "logits/contig" if spec else "-"):
            eager = cli(argv + extra)
        carry.pop("-", None)
        check(res["tokens"] == eager["tokens"],
              f"{label}: greedy tokens with graphs equal the eager run's")
        if spec:
            carry["tokens/contig"] = res["tokens"]
        launches["decode_attention"] += n9
        launches["decode_attention_multi"] += n10
        s, ticks = res["summary"], res["engine"]["decode_ticks"]
        w9 = warm.get("decode_attention", 0)
        w10 = warm.get("decode_attention_multi", 0)
        check(s["completed"] == 16, f"{label}: 16 requests completed")
        toks = res["tokens"]
        check(all(0 <= t < 50257 for r in toks.values() for t in r),
              f"{label}: tokens inside the vocabulary")
        check(sum(len(r) for r in toks.values()) == s["generated_tokens"],
              f"{label}: streamed tokens match the summary")
        if spec:
            check(n10 > w10, "spec: decode_attention_multi launched")
            check(n9 - w9 + n10 - w10 == LAYERS * ticks,
                  "spec: one kernel launch per layer per decode/verify "
                  "tick, beside the warm-ups'")
        else:
            check(n9 - w9 == LAYERS * ticks and n10 == 0,
                  "plain: decode_attention launched 12x per decode tick, "
                  "beside the warm-up's")
        e = eager["summary"]
        print(f"serve {label}: completed {s['completed']}/16, "
              f"{s['goodput_tok_per_s']} tok/s, ttft p50/p99 "
              f"{s['ttft_p50_s']}/{s['ttft_p99_s']} s, tpot p50/p99 "
              f"{s['tpot_p50_s']}/{s['tpot_p99_s']} s, decode ticks {ticks}, "
              f"launches decode_attention {n9} decode_attention_multi {n10} "
              f"(warm-ups {w9} / {w10}); {note}; eager (cuda_graphs=False): "
              f"the same tokens, {e['goodput_tok_per_s']} tok/s, tpot "
              f"p50/p99 {e['tpot_p50_s']}/{e['tpot_p99_s']} s", flush=True)
        runs[label] = res
    a, b = runs["plain"]["tokens"], runs["spec"]["tokens"]
    same = sum(x == y for rid in a for x, y in zip(a[rid], b[rid]))
    total = sum(len(a[rid]) for rid in a)
    print(f"serve agreement (informational): {same}/{total} tokens equal "
          "between plain and speculative runs", flush=True)
    return runs, launches


def paged_bound_ms(index, c: int, storage: str, bandwidth: float,
                   heads: int = H) -> tuple[float, str]:
    """Least time for one paged call on these inputs: the visible whole
    blocks of each row at the stored width (plus their bf16 scales when
    quantized), q, out, table and index read or written once, against
    the flops of QK^T and PV at q's dtype."""
    item = {"f32": 4, "bf16": 2, "int8": 1, "int4": 0.5}[storage]
    q_item = 4 if storage == "f32" else 2
    span = NB * BS
    blocks = sum(min(NB, (i + c - 1) // BS + 1) for i in index)
    nbytes = 2 * blocks * heads * BS * DH * item
    if storage in ("int8", "int4"):
        nbytes += 2 * blocks * heads * BS * 2
    nbytes += 2 * B * c * heads * DH * q_item + 4 * B * NB + 4 * B
    live = sum(min(i + j + 1, span) for i in index for j in range(c))
    ops = 4 * live * heads * DH
    peak = PEAK_OPS["torch.float32" if storage == "f32" else "torch.bfloat16"]
    t_bytes, t_ops = nbytes / bandwidth, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def paged_kernel_phase(torch, pa, seed: int, bandwidth: float) -> dict:
    """#11 and #12 against their plain version through a shuffled block
    table with sentinel entries, in every storage kind: f32 (atol 1e-5),
    bf16, int8 and int4 with bf16 q (atol 2e-2 + rtol 2e-2); then bf16
    and int8 timed at C = 1, 5 and 16, and bf16 at C = 64 (a full prefill
    chunk), each with its ratio to SDPA and to its bound (int8: to bf16 at
    the same C).  ``library_ms``: SDPA on the same K/V already gathered
    into a contiguous cache (gather excluded), bf16 only: no PyTorch call
    reads int8/int4 KV."""
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.comm.compress import (
        quantize_kv,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    k32 = torch.randn(NBLOCKS + 1, H, BS, DH, generator=gen, device="cuda")
    v32 = torch.randn(NBLOCKS + 1, H, BS, DH, generator=gen, device="cuda")
    perm = torch.randperm(NBLOCKS, generator=torch.Generator().manual_seed(seed))
    table = perm[:B * NB].view(B, NB).to(torch.int32)
    table[6, NB // 2:] = NBLOCKS          # the idle row's unallocated tail
    table[0, 4:] = NBLOCKS                # a fresh row: 64 positions so far
    table = table.clamp(max=NBLOCKS - 1).cuda()
    index = torch.tensor(INDEX, dtype=torch.int32, device="cuda")
    pools = {"f32": (k32, v32, {}), "bf16": (k32.bfloat16(), v32.bfloat16(), {})}
    for quant in ("int8", "int4"):
        kq, ks = quantize_kv(k32, quant)
        vq, vs = quantize_kv(v32, quant)
        pools[quant] = (kq, vq, dict(k_scale=ks, v_scale=vs, quant=quant))
    results = {}
    for c in (1, 5, 8, 16, 64):
        name = "paged_decode_attention" if c == 1 else "_paged_multi_call"
        for storage, (kb, vb, kw) in pools.items():
            dtype = torch.float32 if storage == "f32" else torch.bfloat16
            atol, rtol = (1e-5, 0.0) if storage == "f32" else (2e-2, 2e-2)
            q = torch.randn(B, c, H, DH, generator=gen, device="cuda").to(dtype)
            if c == 1:
                def kernel(q=q, kb=kb, vb=vb, kw=kw):
                    return pa.paged_decode_attention(
                        q[:, 0], kb, vb, table, index, **kw)[:, None]
            elif c <= 8:
                def kernel(q=q, kb=kb, vb=vb, kw=kw):
                    return pa.paged_decode_attention_multi(
                        q, kb, vb, table, index, **kw)
            else:
                def kernel(q=q, kb=kb, vb=vb, kw=kw):
                    return pa.paged_prefill_attention(
                        q, kb, vb, table, index, **kw)

            def plain(q=q, kb=kb, vb=vb, kw=kw):
                return pa.paged_attention_plain(q, kb, vb, table, index, **kw)

            out = kernel()
            ref = plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            check(bool(torch.isfinite(out.float()).all()),
                  f"{name} C={c} {storage} finite")
            ok = bool((err <= atol + rtol * ref.float().abs()).all())
            check(ok, f"{name} C={c} {storage} within atol {atol} rtol "
                      f"{rtol} (max err {err.max().item():.3g})")
            line = (f"kernel {name} C={c} {storage}: max_abs_err "
                    f"{err.max().item():.3g} (atol {atol}, rtol {rtol})")
            if (storage in ("bf16", "int8") and c in (1, 5, 16)
                    or (storage, c) == ("bf16", 64)):
                ms = time_ms(torch, kernel)
                plain_ms = time_ms(torch, plain)
                library_ms = None
                if storage == "bf16":
                    kk, vv = pa.paged_window(kb, vb, table)
                    span = kk.shape[2]
                    mask = (torch.arange(span, device="cuda")[None, None, :]
                            <= index[:, None, None].long()
                            + torch.arange(c, device="cuda")[None, :, None])
                    qt = q.transpose(1, 2)
                    library_ms = time_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qt, kk, vv, attn_mask=mask[:, None]))
                bms, by = paged_bound_ms(INDEX, c, storage, bandwidth)
                variant = dict(storage=storage, chunk=c,
                               max_abs_err=err.max().item(), ms=ms,
                               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                               library_ms=library_ms)
                row = results.setdefault(name, dict(
                    name=name, route="cuda", source=PAGED_SOURCE,
                    replaces=TPU_KERNELS[name], launches=0, variants=[],
                ))
                row["variants"].append(variant)
                # The headline numbers: bf16 at the chunk the main path
                # runs most (C = 1 decode, C = 16 prefill).
                if storage == "bf16" and c in (1, 16):
                    row.update({k: variant[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")})
                if library_ms is None:
                    bf16_ms = next(v["ms"] for v in row["variants"]
                                   if v["storage"] == "bf16" and v["chunk"] == c)
                    ratio = f"{ms / bf16_ms:.2f}x bf16 at C={c}"
                    lib = "null"
                else:
                    ratio = f"{ms / library_ms:.2f}x sdpa"
                    lib = f"{library_ms * 1e3:.1f} us (gather excluded)"
                line += (f"; kernel {ms * 1e3:.1f} us, plain "
                         f"{plain_ms * 1e3:.1f} us, sdpa {lib}, bound "
                         f"{bms * 1e3:.2f} us ({by}); {ratio}, "
                         f"{ms / bms:.1f}x bound")
                if c == 1:
                    q0 = q[:, 0]
                    line += (", host {:.1f} us a call".format(host_us(
                        torch, lambda: pa.paged_decode_attention(
                            q0, kb, vb, table, index, **kw))))
            print(line, flush=True)
    return results


# The kernels at a rank's heads under the TP runs (TP_RUNS): #9 and #10
# (C = 5, the k = 4 verify) at 3 heads under --serve-tp 4; #11 and #12
# (verify C = 5, prefill chunk C = 16) at 6 under --serve-tp 2; and #11 /
# #12 at 3 heads, the timings of the paged --serve-tp 4 run they replaced.
TP_KERNEL_CASES = ((3, "decode_attention", 1), (3, "decode_attention_multi", 5),
                   (3, "paged_decode_attention", 1),
                   (3, "_paged_multi_call", 16),
                   (6, "paged_decode_attention", 1), (6, "_paged_multi_call", 5),
                   (6, "_paged_multi_call", 16))


def tp_kernel_phase(torch, da, pa, seed: int, bandwidth: float,
                    kernels: dict) -> None:
    """Each case of ``TP_KERNEL_CASES`` (the serving shapes otherwise,
    bf16) against its plain version (#9/#10: atol 2e-3, rtol 1e-2; paged:
    atol 2e-2, rtol 2e-2), timed with its bound and SDPA's time on the
    same K/V (paged: already gathered); each is added to its row's
    ``variants`` with its ``heads``."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    index = torch.tensor(INDEX, dtype=torch.int32, device="cuda")
    perm = torch.randperm(NBLOCKS, generator=torch.Generator().manual_seed(
        seed))
    table = perm[:B * NB].view(B, NB).to(torch.int32).cuda()
    kv: dict = {}
    for hh, name, c in TP_KERNEL_CASES:
        if hh not in kv:
            kv[hh] = [torch.randn(*shape, generator=gen,
                                  device="cuda").bfloat16()
                      for shape in ((B, hh, L, DH), (B, hh, L, DH),
                                    (NBLOCKS + 1, hh, BS, DH),
                                    (NBLOCKS + 1, hh, BS, DH))]
        k, v, kb, vb = kv[hh]
        q = torch.randn(B, c, hh, DH, generator=gen,
                        device="cuda").bfloat16()
        q0 = q[:, 0]
        if name.startswith("decode_attention"):
            if c == 1:
                def kernel():
                    return da.decode_attention(q0, k, v, index)[:, None]
            else:
                def kernel():
                    return da.decode_attention_multi(q, k, v, index)

            def plain():
                return da.decode_attention_multi_plain(q, k, v, index)

            kk, vv, atol, rtol = k, v, 2e-3, 1e-2
            bms, by = bound_ms(INDEX, c, torch.bfloat16, bandwidth, hh)
        else:
            if c == 1:
                def kernel():
                    return pa.paged_decode_attention(
                        q0, kb, vb, table, index)[:, None]
            elif c <= 8:
                def kernel():
                    return pa.paged_decode_attention_multi(q, kb, vb, table,
                                                           index)
            else:
                def kernel():
                    return pa.paged_prefill_attention(q, kb, vb, table,
                                                      index)

            def plain():
                return pa.paged_attention_plain(q, kb, vb, table, index)

            kk, vv = pa.paged_window(kb, vb, table)
            atol = rtol = 2e-2
            bms, by = paged_bound_ms(INDEX, c, "bf16", bandwidth, hh)
        mask = (torch.arange(kk.shape[2], device="cuda")[None, None, :]
                <= index[:, None, None].long()
                + torch.arange(c, device="cuda")[None, :, None])
        qt = q.transpose(1, 2)
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        check(bool(torch.isfinite(out.float()).all()) and bool(
            (err <= atol + rtol * ref.float().abs()).all()),
            f"{name} C={c} H={hh} within atol {atol} rtol {rtol} (max err "
            f"{err.max().item():.3g})")
        ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kk, vv, attn_mask=mask[:, None]))
        kernels[name]["variants"].append(dict(
            heads=hh, chunk=c, storage="bf16",
            max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=library_ms))
        print(f"kernel {name} C={c} H={hh} bf16 (a rank's heads under "
              f"--serve-tp {12 // hh}): max_abs_err {err.max().item():.3g} "
              f"(atol {atol}, rtol {rtol}); kernel {ms * 1e3:.1f} us, plain "
              f"{plain_ms * 1e3:.1f} us, sdpa {library_ms * 1e3:.1f} us"
              f"{' (gather excluded)' if 'paged' in name else ''}, bound "
              f"{bms * 1e3:.2f} us ({by}); {ms / library_ms:.2f}x sdpa, "
              f"{ms / bms:.1f}x bound", flush=True)


# The disaggregated runs: 2 prefill-role and 6 decode-role slots (the
# 8 of SERVE_ARGV), paged with a host tier, and contiguous.
DISAGG_RUNS = (("disagg paged", ["--serve-paged", "--serve-disagg", "2:6",
                                 "--serve-kv-host-mb", "64"]),
               ("disagg contiguous", ["--serve-disagg", "2:6"]))


def paged_serving_phase(torch, da, pa, seed: int, repo: str,
                        carry: dict) -> dict:
    """The paged main path: the CLI serving GPT-2 124M in bf16 from the
    paged pool, plainly, with speculative decoding (k = 4) and with int8
    KV, each engine replaying its programs as CUDA graphs
    (``graph_check``), each run again with ``cuda_graphs=False`` for the
    same greedy tokens.  Every decode and verify tick must run #11 or #12
    and every prefill tick #12, once per layer, beside the warm-ups
    before the captures, and #9/#10 never.  The speculative run serves
    with telemetry on (``serve_telemetry``); its eager twin's first
    prefill logits and the tokens go to ``carry``.  Then the
    disaggregated tier (``DISAGG_RUNS``, ``disagg_runs``).  Returns the
    launches by row."""
    from pytorch_distributed_training_tpu_torch.cli.main import main as cli
    from pytorch_distributed_training_tpu_torch.serve import ServingEngine

    prefill_ticks = [0]
    original = ServingEngine.prefill_step

    def counted_prefill(self):
        if self._live("prefill"):
            prefill_ticks[0] += 1
        return original(self)

    tm = os.path.join(repo, "build", "chip_smoke", "serve_tm")
    telemetry = ["--metrics-dir", tm, "--trace", "--slo",
                 f"ttft_p99={SERVE_TTFT_P99}", "--metrics-port", "0"]

    argv = SERVE_ARGV + ["--seed", str(seed), "--serve-paged"]
    entries = (da.decode_attention, da.decode_attention_multi,
               pa.paged_decode_attention, pa.paged_decode_attention_multi,
               pa.paged_prefill_attention)
    launches = {"paged_decode_attention": 0, "_paged_multi_call": 0}
    ServingEngine.prefill_step = counted_prefill
    try:
        for label, extra in (("paged", []),
                             ("paged spec", ["--serve-spec",
                                             "--serve-spec-k", "4"]),
                             ("paged int8", ["--serve-kv-dtype", "int8"])):
            for e in entries:
                e.launches = 0
            prefill_ticks[0] = 0
            if "spec" in label:
                with hook_clock() as clock, serve_scrapes() as scrapes, \
                        serve_graphs() as run:
                    res = cli(argv + extra + telemetry)
            else:
                with serve_graphs() as run:
                    res = cli(argv + extra)
            n9, n10, n11, n12m, n12p = (e.launches for e in entries)
            pre_ticks = prefill_ticks[0]
            note = graph_check(f"serve {label}", run)
            warm = warm_launches(run)
            if "spec" in label:
                serve_telemetry(tm, res, scrapes)
                hook_report(clock)
            with serve_graphs(False), first_logits(
                    torch, carry,
                    "logits/paged" if "spec" in label else "-"):
                eager = cli(argv + extra)
            carry.pop("-", None)
            check(res["tokens"] == eager["tokens"],
                  f"{label}: greedy tokens with graphs equal the eager "
                  "run's")
            if "spec" in label:
                carry["tokens/paged"] = res["tokens"]
            w11 = warm.get("paged_decode_attention", 0)
            w12m = warm.get("paged_decode_attention_multi", 0)
            w12p = warm.get("paged_prefill_attention", 0)
            s, st = res["summary"], res["engine"]
            ticks = st["decode_ticks"]
            check(s["completed"] == 16, f"{label}: 16 requests completed")
            toks = res["tokens"]
            check(all(0 <= t < VOCAB for r in toks.values() for t in r),
                  f"{label}: tokens inside the vocabulary")
            check(n9 == 0 and n10 == 0,
                  f"{label}: the contiguous kernels launched {n9}, {n10}")
            check(n11 - w11 + n12m - w12m == LAYERS * ticks,
                  f"{label}: one paged launch per layer per decode/verify "
                  f"tick ({n11} + {n12m} less the warm-ups' {w11} + "
                  f"{w12m} vs {ticks} ticks)")
            check(n12p - w12p == LAYERS * pre_ticks,
                  f"{label}: one prefill launch per layer per prefill tick "
                  f"({n12p} less the warm-up's {w12p} vs {pre_ticks} "
                  "ticks)")
            if "spec" in label:
                check(n12m > w12m, f"{label}: the verify chunk ran #12")
            launches["paged_decode_attention"] += n11
            launches["_paged_multi_call"] += n12m + n12p
            e = eager["summary"]
            print(f"serve {label}: completed {s['completed']}/16, "
                  f"{s['goodput_tok_per_s']} tok/s, ttft p50/p99 "
                  f"{s['ttft_p50_s']}/{s['ttft_p99_s']} s, tpot p50/p99 "
                  f"{s['tpot_p50_s']}/{s['tpot_p99_s']} s, decode ticks "
                  f"{ticks}, prefill ticks {pre_ticks}, launches "
                  f"paged_decode_attention {n11} paged_decode_attention_multi "
                  f"{n12m} paged_prefill_attention {n12p} (warm-ups {w11} / "
                  f"{w12m} / {w12p}); {note}; eager (cuda_graphs=False): "
                  f"the same tokens, {e['goodput_tok_per_s']} tok/s, tpot "
                  f"p50/p99 {e['tpot_p50_s']}/{e['tpot_p99_s']} s",
                  flush=True)
    finally:
        ServingEngine.prefill_step = original
    for row, n in disagg_runs(torch, da, pa, seed).items():
        launches[row] = launches.get(row, 0) + n
    return launches


def disagg_runs(torch, da, pa, seed: int) -> dict:
    """The disaggregated tier through the CLI (``DISAGG_RUNS``): all 16
    requests complete, each adopted once (16 handoffs); the prefill role
    runs #12 once per layer per prefill tick (paged; the contiguous
    cache's 16-wide chunks take the plain ragged path there, as the
    interleaved engine's do), the decode role #11 + #12 (paged) or #9 +
    #10 (contiguous) once per layer per decode or verify tick and no
    other kernel beside the warm-ups before the captures, each role's
    engine replaying its programs (``graph_check``); the shared pool's
    audit holds after the paged run.  Prints each run's handoffs and
    their host time a tick; returns the launches by row."""
    from pytorch_distributed_training_tpu_torch.cli.main import main as cli
    from pytorch_distributed_training_tpu_torch.serve import (
        DisaggServingEngine,
    )

    entries = (da.decode_attention, da.decode_attention_multi,
               pa.paged_decode_attention, pa.paged_decode_attention_multi,
               pa.paged_prefill_attention)
    tiers = []
    init = DisaggServingEngine.__init__

    def kept(self, *a, **kw):
        init(self, *a, **kw)
        tiers.append(self)

    launches = {"decode_attention": 0, "decode_attention_multi": 0,
                "paged_decode_attention": 0, "_paged_multi_call": 0}
    DisaggServingEngine.__init__ = kept
    try:
        for label, extra in DISAGG_RUNS:
            for e in entries:
                e.launches = 0
            tiers.clear()
            with serve_graphs() as run:
                res = cli(SERVE_ARGV + ["--seed", str(seed)] + extra)
            n9, n10, n11, n12m, n12p = (e.launches for e in entries)
            note = graph_check(label, run)
            warm = warm_launches(run)
            w9, w10, w11, w12m, w12p = (warm.get(e.__name__, 0)
                                        for e in entries)
            s, st = res["summary"], res["engine"]
            (tier,) = tiers
            ticks = st["decode_ticks"]
            pre_ticks = tier.prefill_engine.prefill_ticks
            check(s["completed"] == 16, f"{label}: 16 requests completed")
            check(all(0 <= t < VOCAB for r in res["tokens"].values()
                      for t in r), f"{label}: tokens inside the vocabulary")
            check(st["handoffs"] == 16 and res["prefill_ticks"] == pre_ticks
                  and tier.decode_engine.prefill_ticks == 0
                  and tier.prefill_engine.decode_ticks == 0,
                  f"{label}: 16 handoffs ({st['handoffs']}), each role its "
                  "half alone")
            if "paged" in label:
                check(n9 == n10 == 0
                      and n11 - w11 + n12m - w12m == LAYERS * ticks
                      and n12p - w12p == LAYERS * pre_ticks,
                      f"{label}: #11 + #12 {n11} + {n12m} = 12 x {ticks} "
                      f"decode ticks, #12 prefill {n12p} = 12 x "
                      f"{pre_ticks} prefill ticks, beside the warm-ups' "
                      f"{w11} + {w12m}, {w12p}; #9/#10 {n9}/{n10}")
                tier.check_invariants()
                launches["paged_decode_attention"] += n11
                launches["_paged_multi_call"] += n12m + n12p
            else:
                check(n11 == n12m == n12p == 0
                      and n9 - w9 + n10 - w10 == LAYERS * ticks,
                      f"{label}: #9 + #10 {n9} + {n10} = 12 x {ticks} "
                      f"decode ticks beside the warm-ups' {w9} + {w10}, "
                      f"paged {n11}/{n12m}/{n12p}")
                launches["decode_attention"] += n9
                launches["decode_attention_multi"] += n10
            print(f"serve {label} (2 prefill + 6 decode slots): completed "
                  f"{s['completed']}/16, {s['goodput_tok_per_s']} tok/s, "
                  f"ttft p50/p99 {s['ttft_p50_s']}/{s['ttft_p99_s']} s, "
                  f"tpot p50/p99 {s['tpot_p50_s']}/{s['tpot_p99_s']} s; "
                  f"{st['handoffs']} handoffs, handoff host "
                  f"{res['handoff_s'] / res['ticks'] * 1e3:.4f} ms a tick "
                  f"over {res['ticks']} ticks; decode ticks {ticks}, "
                  f"prefill ticks {pre_ticks}; launches #9 {n9} #10 {n10} "
                  f"#11 {n11} #12 {n12m} + {n12p}; {note}", flush=True)
            del tier
            tiers.clear()
    finally:
        DisaggServingEngine.__init__ = init
    return launches

# The speculative paged run's TTFT objective: loose enough that no alert
# fires on a healthy card (an alert is a recorded event, not a failure).
SERVE_TTFT_P99 = "30s"


@contextlib.contextmanager
def hook_clock():
    """While the CLI serves: the host seconds of the scheduler's ticks and,
    inside them, of the telemetry's own calls on the serving thread (the
    engine-stats gauges, the SLO's evaluation, the flight recorder's
    queue check, the span recorder, the emitter's counters, gauges,
    histograms and records), each timed where it is entered from outside
    the others.  The ``record_function`` ranges of ``phase_span`` are not
    in it.  Yields ``{"tick": [s, n], "<Class>.<method>": [s, n]}``."""
    import threading

    from pytorch_distributed_training_tpu_torch import obs
    from pytorch_distributed_training_tpu_torch.serve import (
        ContinuousScheduler,
    )

    hooks = [(ContinuousScheduler, "_emit_engine_stats"),
             (obs.SLOPolicy, "evaluate"), (obs.FlightRecorder, "check_queue"),
             *[(obs.SpanRecorder, n) for n in ("start_span", "end_span",
                                               "record_span", "flush")],
             *[(obs.MetricsEmitter, n) for n in ("counter_add", "gauge",
                                                 "observe", "emit")],
             (ContinuousScheduler, "tick")]
    clock: dict = {"tick": [0.0, 0]}
    inside = {"tick": False, "hook": False}
    serving = threading.get_ident()

    def add(key, t0):
        c = clock.setdefault(key, [0.0, 0])
        c[0] += time.perf_counter() - t0
        c[1] += 1

    def timed(owner, name, fn):
        key = f"{owner.__name__}.{name}"

        def tick(*a, **kw):
            inside["tick"] = True
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                add("tick", t0)
                inside["tick"] = False

        def hook(*a, **kw):
            if (not inside["tick"] or inside["hook"]
                    or threading.get_ident() != serving):
                return fn(*a, **kw)
            inside["hook"] = True
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                add(key, t0)
                inside["hook"] = False

        return tick if name == "tick" else hook

    originals = [(owner, name, getattr(owner, name)) for owner, name in hooks]
    for owner, name, fn in originals:
        setattr(owner, name, timed(owner, name, fn))
    try:
        yield clock
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)


def hook_report(clock: dict) -> None:
    """Prints ``hook_clock``'s reading: the telemetry's host time a tick
    beside the tick's."""
    tick_s, ticks = clock.pop("tick")
    total = sum(s for s, _ in clock.values())
    parts = ", ".join(f"{k} {s / ticks * 1e6:.1f} us ({n} calls)"
                      for k, (s, n) in sorted(clock.items(),
                                              key=lambda kv: -kv[1][0]))
    check(ticks > 0 and total > 0,
          f"serve telemetry: the hooks were timed ({ticks} ticks)")
    print(f"serve telemetry host cost (paged spec): {ticks} scheduler "
          f"ticks, {tick_s / ticks * 1e3:.3f} ms a tick; the telemetry's "
          f"calls {total / ticks * 1e6:.1f} us a tick "
          f"({total / tick_s * 100:.2f} % of the ticks' time): {parts}",
          flush=True)


@contextlib.contextmanager
def serve_scrapes():
    """While the CLI serves: the ops endpoint's ``/metrics``, ``/healthz``
    and ``/slo`` fetched over localhost on the fifth scheduler tick (the
    run live), and the live aggregator's TTFT p99 read after the tick
    that finished the last request.  Yields the dict it fills."""
    import urllib.request

    from pytorch_distributed_training_tpu_torch.obs import http
    from pytorch_distributed_training_tpu_torch.serve import (
        ContinuousScheduler,
    )

    scrapes: dict = {"servers": [], "ticks": 0}
    start, tick = http.OpsServer.start, ContinuousScheduler.tick

    def started(self):
        scrapes["servers"].append(self)
        return start(self)

    def ticked(self):
        events = tick(self)
        scrapes["ticks"] += 1
        (server,) = scrapes["servers"]
        if scrapes["ticks"] == 5:
            for path in ("/metrics", "/healthz", "/slo"):
                with urllib.request.urlopen(server.url + path,
                                            timeout=10) as r:
                    scrapes[path] = (r.status, r.read().decode())
        if self.idle:
            scrapes["live_ttft_p99"] = \
                server.aggregator.hist("ttft_s").quantile(99)
        return events

    http.OpsServer.start, ContinuousScheduler.tick = started, ticked
    try:
        yield scrapes
    finally:
        http.OpsServer.start, ContinuousScheduler.tick = start, tick


def serve_telemetry(tm: str, res: dict, scrapes: dict) -> None:
    """The speculative paged run's telemetry: the log passes the port's
    ``validate_events``; all 16 request span chains are whole; the
    engine's decode and verify tick spans equal its decode-tick counter;
    each request's TTFT is its queued plus prefill span, and the TTFT
    decomposition's p50 equals the histogram's; the endpoint answered 200
    on the three paths mid-run, ``/metrics`` a Prometheus exposition with
    the engine's counters; the live TTFT p99 equals the quantile of the
    summary's bucket counts read back from the log."""
    import shutil

    from pytorch_distributed_training_tpu_torch import obs

    events = obs.read_events(os.path.join(tm, "events.rank00000.jsonl"))
    obs.validate_events(events)
    spans = obs.span_events(events)
    chains: dict = {}
    for sp in spans:
        if sp.get("corr") is not None:
            chains.setdefault(sp["corr"], {})[sp["span"]] = sp
    whole = {"serve/request", "request/queued", "request/prefill",
             "request/decode"}
    check(sorted(chains) == list(range(16))
          and all(set(c) == whole for c in chains.values()),
          f"serve telemetry: 16 whole request chains ({len(chains)})")
    ticks = sum(sp["span"] in ("serve/decode", "serve/verify")
                for sp in spans)
    check(ticks == res["engine"]["decode_ticks"]
          == events[-1]["counters"]["decode_ticks"],
          f"serve telemetry: {ticks} tick spans, "
          f"{res['engine']['decode_ticks']} decode ticks")
    for corr, c in chains.items():
        ttft = c["request/prefill"]["t1"] - c["serve/request"]["t0"]
        parts = c["request/queued"]["dur"] + c["request/prefill"]["dur"]
        check(abs(parts - ttft) <= 1e-9,
              f"serve telemetry: request {corr} queued + prefill {parts} "
              f"vs TTFT {ttft}")
    dec = obs.ttft_decomposition(spans)
    hist = events[-1]["histograms"]["ttft_s"]
    check(dec["requests"] == 16 and hist["count"] == 16
          and abs(dec["ttft_s"]["p50"] - hist["p50"]) <= 1e-9,
          f"serve telemetry: TTFT decomposition p50 {dec['ttft_s']['p50']} "
          f"vs histogram {hist['p50']}")
    check(all(scrapes.get(p, (0,))[0] == 200
              for p in ("/metrics", "/healthz", "/slo"))
          and "# TYPE decode_ticks counter" in scrapes["/metrics"][1],
          f"serve telemetry: /metrics /healthz /slo answered 200 mid-run "
          f"({[scrapes.get(p, (None,))[0] for p in ('/metrics', '/healthz', '/slo')]})")
    offline = obs.quantile_from_buckets(hist["buckets"], 99)
    check(scrapes.get("live_ttft_p99") == offline,
          f"serve telemetry: live TTFT p99 {scrapes.get('live_ttft_p99')} "
          f"vs the log's {offline}")
    print(f"serve telemetry (paged spec): 16 whole request chains, {ticks} "
          f"tick spans = decode ticks; TTFT decomposition queue "
          f"{dec['queue_wait_s']['mean'] * 1e3:.2f} + prefill "
          f"{dec['prefill_compute_s']['mean'] * 1e3:.2f} + sched "
          f"{dec['sched_delay_s']['mean'] * 1e3:.2f} ms (means); endpoint "
          f"200 on /metrics /healthz /slo at tick 5; live TTFT p99 "
          f"{offline:.6f} s = the log's", flush=True)
    shutil.rmtree(tm, ignore_errors=True)


def prefix_phase(torch, seed: int, repo: str) -> None:
    """Shared-prefix traffic at full width: 16 requests with one
    128-token prefix (8 blocks) and distinct tails, through the paged
    engine's prefix cache, its programs replayed as CUDA graphs
    (``graph_check``) and its greedy tokens equal to the same run with
    ``cuda_graphs=False``; the same requests without the cache give the
    greedy-token agreement (information only: bf16).  Then the same
    prefix through two replicas behind the router (``router_leg``)."""
    import numpy as np

    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.serve import (
        ContinuousScheduler, Request, ServingEngine, VirtualClock,
    )

    model = create_model("gpt2", dtype=torch.bfloat16, device="cuda",
                         seed=seed)
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, VOCAB, (128,))
    prompts = [np.concatenate([prefix, rng.integers(0, VOCAB, (n,))])
               .astype(np.int32) for n in rng.integers(8, 64, 16)]
    runs = {}
    for key, cache_on, graphs in (("cache", True, True),
                                  ("eager", True, False),
                                  ("no cache", False, True)):
        tokens: dict = {}
        with serve_graphs(graphs) as run:
            engine = ServingEngine(
                model, num_slots=8, paged=True, prefix_cache=cache_on,
                temperature=0.0, seed=seed, device="cuda",
                stream_cb=lambda rid, tok: tokens.setdefault(
                    rid, []).append(tok),
            )
        sched = ContinuousScheduler(engine, clock=VirtualClock())
        for i, p in enumerate(prompts):
            check(sched.submit(Request(i, p, 32)), "prefix: request queued")
        while not sched.idle:
            sched.tick()
        st = engine.stats()
        check(len(sched.completed) == 16, "prefix: 16 requests completed")
        engine.pool.check_invariants()
        note = graph_check(f"prefix {key}", run) if graphs else ""
        runs[key] = (tokens, st, note)
        del engine, sched
    tokens, st, note = runs["cache"]
    check(tokens == runs["eager"][0], "prefix: greedy tokens with graphs "
          "equal the eager engine's")
    check(st["prefix_hit_tokens"] > 0, "prefix: the prefix cache was hit")
    check(st["prefill_tokens_computed"] < st["prefill_tokens_offered"],
          "prefix: hits skipped prefill work")
    plain = runs["no cache"][0]
    same = sum(x == y for rid in tokens for x, y in zip(tokens[rid], plain[rid]))
    total = sum(len(tokens[rid]) for rid in tokens)
    print(f"prefix: prefix_hit_tokens {st['prefix_hit_tokens']}, prefill "
          f"tokens {st['prefill_tokens_computed']}/"
          f"{st['prefill_tokens_offered']}, cow copies {st['cow_copies']}; "
          f"agreement with prefix_cache=False (informational): "
          f"{same}/{total} tokens; {note}; eager (cuda_graphs=False): the "
          "same tokens", flush=True)
    router_leg(torch, model, seed, prefix, rng, repo)
    del model


def router_leg(torch, model, seed: int, prefix, rng, repo: str) -> None:
    """A ``ReplicaRouter`` of 2 full-width paged replicas (8 slots and a
    64 MB host tier each) on the one card, scripted: one request warms
    replica 0 with the 128-token prefix, then 15 sharing it arrive at
    once.  Affinity sends them to replica 0 until its queue reaches the
    cap (2), then they rebalance to replica 1, the first with a sibling
    fetch of the prefix into its host tier.  Checks: affinity hits, a
    rebalance with a sibling fetch, the fetched blocks restored on
    replica 1 bit for bit (each block's bytes equal across the two
    pools), every request completed, and the router's counters equal to
    its emitted telemetry."""
    import shutil

    import numpy as np

    from pytorch_distributed_training_tpu_torch.obs import MetricsEmitter
    from pytorch_distributed_training_tpu_torch.serve import (
        ReplicaRouter, Request, ServingEngine, VirtualClock,
        hash_prompt_blocks,
    )

    tm = os.path.join(repo, "build", "chip_smoke", "router_tm")
    shutil.rmtree(tm, ignore_errors=True)
    emitter = MetricsEmitter(tm, rank=0)
    with serve_graphs() as run:
        engines = [ServingEngine(model, num_slots=8, paged=True,
                                 kv_host_mb=64, temperature=0.0, seed=seed,
                                 device="cuda") for _ in range(2)]
    clock = VirtualClock()
    router = ReplicaRouter(engines, clock=clock, affinity_queue_cap=2,
                           emitter=emitter)
    prompts = [np.concatenate([prefix, rng.integers(0, VOCAB, (n,))])
               .astype(np.int32) for n in rng.integers(8, 64, 16)]
    t0 = time.monotonic()
    check(router.submit(Request(0, prompts[0], 32)), "router: queued")
    while not router.idle:
        router.tick()
    for i, p in enumerate(prompts[1:], 1):
        check(router.submit(Request(i, p, 32)), "router: queued")
    while not router.idle:
        router.tick()
    seconds = time.monotonic() - t0
    rt = router.stats()
    summary = emitter.summary()
    emitter.close()
    counters = summary["counters"]
    check(len(router.completed) == 16, "router: 16 requests completed")
    check(rt["affinity_hits"] > 0 and rt["rebalanced"] > 0
          and rt["sibling_fetches"] > 0 and rt["sibling_fetch_blocks"] > 0,
          f"router: affinity hits, a rebalance and a sibling fetch ({rt})")
    src, dst = (e.pool.blocks for e in engines)
    hashes = hash_prompt_blocks(prompts[0], src.block_size)[:len(prefix)
                                                           // src.block_size]
    same = 0
    for h in hashes:
        a, b = src.read_block_bytes(h), dst.read_block_bytes(h)
        check(a is not None and b is not None
              and all(np.array_equal(x, y) for x, y in zip(a, b)),
              "router: a fetched prefix block's bytes equal on both "
              "replicas")
        same += 1
    check(dst.blocks_restored >= len(hashes),
          f"router: replica 1 restored the fetched prefix "
          f"({dst.blocks_restored} blocks)")
    for name, key in (("router_routed_requests", None),
                      ("router_affinity_hits", "affinity_hits"),
                      ("router_rebalanced", "rebalanced"),
                      ("router_sibling_fetches", "sibling_fetches"),
                      ("router_sibling_fetch_blocks",
                       "sibling_fetch_blocks")):
        want = sum(rt["routed"]) if key is None else rt[key]
        check(counters.get(name, 0) == want,
              f"router: telemetry {name} {counters.get(name)} vs {want}")
    for e in engines:
        e.pool.check_invariants()
    note = graph_check("router", run)
    shutil.rmtree(tm, ignore_errors=True)
    print(f"router (2 paged GPT-2 124M replicas, 8 slots and a 64 MB host "
          f"tier each, one card): routed {rt['routed']}, affinity hits "
          f"{rt['affinity_hits']}, rebalanced {rt['rebalanced']}, sibling "
          f"fetches {rt['sibling_fetches']} ({rt['sibling_fetch_blocks']} "
          f"blocks), replica 1 restored {dst.blocks_restored} blocks, "
          f"{same} prefix blocks bitwise equal across the pools, telemetry "
          f"= counters; {note}; {seconds:.1f} s", flush=True)


# The serving fleet's legs (``fleet_phase``): GPT-2 124M in bf16 from the
# seed, SERVE_ARGV's trace (16 requests at once, 8 slots and the CLI's
# engine settings a replica), each router under a VirtualClock advanced
# FLEET_DT a tick, so a respawn lands on the tick the backoff fixes.
FLEET_DT = 0.05
F1_FAULTS = "replica_crash@4:1,replica_stall@9:0:3"
F2_FAULTS = "replica_crash@5:0:prefill,handoff_drop@{drop}"
# The tick of F2's dropped handoff: the first at which the 2:6 tier has a
# handoff parked (the decode role full), as the trace's ticks give it.
F2_DROP_TICK = 70


def _fleet_requests(seed: int, n: int = 16, first: int = 0):
    from pytorch_distributed_training_tpu_torch.cli.main import (
        serve_requests,
    )

    reqs = serve_requests(vocab=VOCAB, seed=seed, seq_len=512, max_len=1024,
                          max_new=64, n_requests=n)
    for r in reqs:
        r.id += first
    return reqs


def _fleet_engine(model, seed: int, device, **kw):
    """The CLI's paged engine of SERVE_ARGV (8 slots, chunk 16)."""
    from pytorch_distributed_training_tpu_torch.serve import ServingEngine

    return ServingEngine(model, num_slots=8, max_len=1024, prefill_chunk=16,
                         temperature=0.0, seed=seed, paged=True,
                         device=device, **kw)


def _streams(engines) -> dict:
    toks: dict = {}
    for e in engines:
        e.stream_cb = lambda rid, t: toks.setdefault(rid, []).append(int(t))
    return toks


def _tick_until_idle(router, clock, limit: int = 6000) -> int:
    n = 0
    while not router.idle:
        router.tick()
        clock.advance(FLEET_DT)
        n += 1
        check(n < limit, f"fleet: the router went idle within {limit} ticks")
    return n


def _storage(engines) -> list:
    out = []
    for e in engines:
        blocks = e.blocks if hasattr(e, "prefill_engine") else e.pool.blocks
        out.append([t.data_ptr() for layer in blocks.cache for t in layer])
    return out


def _blocks_free(engine) -> tuple:
    st = engine.stats()
    return st["blocks_in_use"], st["blocks_free"] + st["blocks_cached"]


def _watch_respawns(torch, ctrl, router, engines, seen: list) -> None:
    """Each respawn's tick, clock and the card's allocated bytes (and the
    pools' storage) before and after it."""
    respawn = ctrl._respawn

    def logged(k, now):
        torch.cuda.synchronize()
        before = (torch.cuda.memory_allocated(), _storage(engines))
        t0 = time.perf_counter()
        respawn(k, now)
        torch.cuda.synchronize()
        seen.append({"replica": k, "tick": router.tick_index, "t": now,
                     "s": time.perf_counter() - t0,
                     "same": before == (torch.cuda.memory_allocated(),
                                        _storage(engines)),
                     "bytes": before[0]})

    ctrl._respawn = logged


def f1_leg(torch, model, seed: int, device) -> dict:
    """F1: ``--serve-replicas 2 --serve-paged --serve-kv-host-mb 64``'s
    engines behind the router with a failover controller, the chaos
    plane at ``F1_FAULTS`` (replica 1 crashes at tick 4, replica 0 stalls
    three ticks at 9), against the same router without faults.  Checks:
    16/16 finish with one record an id, one death, its drained and
    requeued counts, one respawn at the backoff's tick with the card's
    allocated bytes and the pools unchanged across it; tokens equal the
    faultless run's up to each retried request's requeue point (the
    requests differing after it counted); every block back to free or
    cached.  Returns the figures."""
    from pytorch_distributed_training_tpu_torch.resilience import (
        ServeFaultInjector,
    )
    from pytorch_distributed_training_tpu_torch.serve import (
        FailoverController, ReplicaRouter, VirtualClock,
    )

    out: dict = {}
    for faults in (None, F1_FAULTS):
        engines = [_fleet_engine(model, seed, device, kv_host_mb=64)
                   for _ in range(2)]
        toks = _streams(engines)
        clock = VirtualClock()
        ctrl = FailoverController()
        router = ReplicaRouter(
            engines, max_queue=16, clock=clock, failover=ctrl,
            chaos=ServeFaultInjector.from_spec(faults) if faults else None)
        respawns: list = []
        points: dict = {}
        timing = {"declare": 0.0, "requeue": 0.0}
        if faults:
            _watch_respawns(torch, ctrl, router, engines, respawns)
            requeue, declare = ctrl._requeue, ctrl.declare_dead

            def first_point(tr, now, **kw):
                points.setdefault(tr.request.id, len(tr.tokens))
                t0 = time.perf_counter()
                requeue(tr, now, **kw)
                timing["requeue"] += time.perf_counter() - t0

            def timed_declare(*a, **kw):
                t0 = time.perf_counter()
                declare(*a, **kw)
                timing["declare"] += time.perf_counter() - t0

            ctrl._requeue, ctrl.declare_dead = first_point, timed_declare
        start = [_blocks_free(e) for e in engines]
        t0 = time.monotonic()
        for r in _fleet_requests(seed):
            check(router.submit(r), "F1: request queued")
        ticks = _tick_until_idle(router, clock)
        seconds = time.monotonic() - t0
        # Past the trace: tick on until a respawn the backoff set is due.
        while faults and ctrl._respawn_at:
            router.tick()
            clock.advance(FLEET_DT)
        ids = [r["id"] for r in router.completed]
        check(len(ids) == len(set(ids)) == 16
              and all(r["finish_reason"] == "length"
                      for r in router.completed),
              f"F1 {faults}: 16/16 finished, one record an id")
        for e in engines:
            e.pool.check_invariants()
        end = [_blocks_free(e) for e in engines]
        check(all(u == 0 and f == s[1] for (u, f), s in zip(end, start)),
              f"F1: every block free or cached again ({start} -> {end})")
        out[faults or "clean"] = dict(
            tokens=toks, fo=ctrl.stats(), respawns=respawns, points=points,
            ticks=ticks, seconds=seconds, timing=timing,
            records={r["id"]: r for r in router.completed})
        del router, engines
        torch.cuda.empty_cache()
    clean, run = out["clean"], out[F1_FAULTS]
    fo = run["fo"]
    (death,) = fo["deaths"]
    delay = FailoverController().backoff.delay(1)
    (resp,) = run["respawns"] if len(run["respawns"]) == 1 else (None,)
    check(fo["replica_deaths"] == 1 and death["replica"] == 1
          and fo["requeued"] + fo["retried"] > 0 and fo["failed"] == 0
          and fo["respawns"] == 1 and resp is not None,
          f"F1: one death of replica 1, work drained, one respawn ({fo})")
    due = death["t"] + delay
    check(resp["t"] >= due > resp["t"] - FLEET_DT - 1e-9,
          f"F1: the respawn at tick {resp['tick']} (t {resp['t']:.3f}) is "
          f"the first at or after the backoff's {due:.3f}")
    check(resp["same"], "F1: memory_allocated and the pools unchanged "
          "across the respawn")
    check(clean["fo"]["replica_deaths"] == 0, "F1 clean: no death")
    retried = [rid for rid, rec in run["records"].items()
               if rec.get("retries")]
    for rid in retried:
        p = run["points"][rid]
        check(run["tokens"][rid][:p] == clean["tokens"][rid][:p],
              f"F1: request {rid} equal to the faultless run up to its "
              f"requeue point ({p} tokens)")
    differ = sum(run["tokens"][rid] != clean["tokens"][rid]
                 for rid in clean["tokens"])
    run.update(delay=delay, retried_ids=retried, differ=differ)
    return out


def f2_leg(torch, model, seed: int, device) -> dict:
    """F2: ``--serve-paged --serve-disagg 2:6``'s tier behind the router
    (a fault spec forces it at one replica), ``F2_FAULTS``: the prefill
    role dies at tick 5 (its stranded and queued work waits for the
    respawn), then a parked handoff is dropped.  Checks: the role
    revived, the dropped handoff's orphan requeued, 16/16 finished, the
    shared pool's audit clean after each event and every block back."""
    from pytorch_distributed_training_tpu_torch.resilience import (
        ServeFaultInjector,
    )
    from pytorch_distributed_training_tpu_torch.serve import (
        DisaggServingEngine, FailoverController, ReplicaRouter,
        VirtualClock,
    )

    tier = DisaggServingEngine(model, prefill_slots=2, decode_slots=6,
                               max_len=1024, prefill_chunk=16,
                               temperature=0.0, seed=seed, paged=True,
                               device=device)
    _streams([tier])
    clock = VirtualClock()
    ctrl = FailoverController()
    router = ReplicaRouter([tier], max_queue=16, clock=clock, failover=ctrl,
                           chaos=ServeFaultInjector.from_spec(
                               F2_FAULTS.format(drop=F2_DROP_TICK)))
    events: list = []
    respawns: list = []
    _watch_respawns(torch, ctrl, router, [tier], respawns)
    inject, drop = router.inject_role_death, router.drop_handoff

    def role_death(k, role):
        inject(k, role)
        tier.check_invariants()
        events.append(("death", role, router.tick_index))

    def dropped():
        rid = drop()
        tier.check_invariants()
        events.append(("drop", rid, router.tick_index))
        return rid

    router.inject_role_death, router.drop_handoff = role_death, dropped
    start = _blocks_free(tier)
    t0 = time.monotonic()
    for r in _fleet_requests(seed):
        check(router.submit(r), "F2: request queued")
    ticks = _tick_until_idle(router, clock)
    seconds = time.monotonic() - t0
    fo = ctrl.stats()
    ids = [r["id"] for r in router.completed]
    tier.check_invariants()
    check(len(ids) == len(set(ids)) == 16, "F2: 16/16 finished once")
    check([e[0] for e in events] == ["death", "drop"]
          and events[1][1] is not None and tier.handoffs_dropped == 1,
          f"F2: the prefill role died, then a parked handoff was dropped "
          f"({events})")
    check(fo["respawns"] == 1 and ctrl.health[0].state == "up"
          and tier.dead_roles == () and respawns[0]["same"],
          f"F2: the role revived, allocations unchanged ({fo})")
    check(fo["retried"] >= 1, "F2: the orphan was requeued")
    check(_blocks_free(tier) == (0, start[1]),
          "F2: every block free or cached again")
    return {"fo": fo, "events": events, "respawns": respawns,
            "ticks": ticks, "seconds": seconds,
            "handoffs": tier.handoffs}


def a1_leg(torch, model, seed: int, device, repo: str) -> dict:
    """A1: three paged replicas behind the router with failover and the
    autoscale controller (``min_replicas`` 1: two park at once) under a
    VirtualClock; a burst of 16, idle ticks, a burst of 8, idle ticks.
    Checks: a scale-up and a scale-down at least, each an
    ``autoscale_action`` record with its cause; the card's allocated
    bytes and the pools unchanged across every revive; every request
    done; ``/slo``'s controller block equal to ``snapshot()``."""
    import shutil

    from pytorch_distributed_training_tpu_torch.obs import (
        LiveAggregator, MetricsEmitter, OpsServer, read_events,
    )
    from pytorch_distributed_training_tpu_torch.serve import (
        AutoscaleController, FailoverController, ReplicaRouter,
        VirtualClock,
    )

    tm = os.path.join(repo, "build", "chip_smoke", "a1_tm")
    shutil.rmtree(tm, ignore_errors=True)
    clock = VirtualClock()
    emitter = MetricsEmitter(tm, rank=0, clock=clock)
    agg = LiveAggregator(clock=clock)
    emitter.attach_sink(agg)
    engines = [_fleet_engine(model, seed, device) for _ in range(3)]
    _streams(engines)
    auto = AutoscaleController(min_replicas=1)
    ctrl = FailoverController()
    router = ReplicaRouter(engines, max_queue=24, clock=clock,
                           emitter=emitter, failover=ctrl, autoscale=auto)
    revives: list = []
    revive = ctrl.revive

    def logged(k, tick, now):
        torch.cuda.synchronize()
        before = (torch.cuda.memory_allocated(), _storage(engines))
        revive(k, tick, now)
        torch.cuda.synchronize()
        revives.append((k, tick, before == (torch.cuda.memory_allocated(),
                                            _storage(engines))))

    ctrl.revive = logged
    t0 = time.monotonic()
    for r in _fleet_requests(seed):
        check(router.submit(r), "A1: request queued")
    ticks = _tick_until_idle(router, clock)
    for _ in range(auto.down_idle_ticks + auto.cooldown_ticks):
        router.tick()
        clock.advance(FLEET_DT)
    for r in _fleet_requests(seed + 1, n=8, first=100):
        check(router.submit(r), "A1: request queued")
    ticks += _tick_until_idle(router, clock)
    for _ in range(auto.down_idle_ticks + auto.cooldown_ticks):
        router.tick()
        clock.advance(FLEET_DT)
    seconds = time.monotonic() - t0
    server = OpsServer(agg, None, controller=auto)
    status, _, body = server._respond("/slo")
    block = json.loads(body)["controller"]
    snap = json.loads(json.dumps(auto.snapshot()))
    emitter.close()
    actions = [e for name in sorted(os.listdir(tm))
               if name.startswith("events.")
               for e in read_events(os.path.join(tm, name))
               if e.get("record") == "autoscale_action"]
    shutil.rmtree(tm, ignore_errors=True)
    st = auto.stats()
    done = router.completed
    check(len(done) == 24 and len({r["id"] for r in done}) == 24
          and all(r["finish_reason"] == "length" for r in done),
          "A1: 24/24 requests done, once")
    check(st["scale_ups"] >= 1 and st["scale_downs"] >= 1,
          f"A1: a scale-up and a scale-down ({st})")
    check(len(actions) == st["actions"]
          and all(a["cause"]["signal"] for a in actions)
          and [a["action"] for a in actions]
          == [h["action"] for h in auto.history],
          "A1: every action an autoscale_action record with its cause")
    check(revives and all(same for _, _, same in revives),
          f"A1: memory_allocated and the pools unchanged across each "
          f"revive ({revives})")
    check(status == 200 and block == snap,
          "A1: /slo's controller block equals snapshot()")
    for e in engines:
        e.pool.check_invariants()
    return {"stats": st, "history": list(auto.history), "ticks": ticks,
            "seconds": seconds, "revives": revives,
            "fo": ctrl.stats()}


def fleet_phase(torch, pa, seed: int, repo: str) -> dict:
    """The serving fleet's controllers on the card (F1, F2, A1), every
    engine replaying its programs as CUDA graphs (``graph_check``: none
    captured again across crashes, respawns, revives and re-splits);
    returns the paged kernels' launches by row (#11, #12)."""
    from pytorch_distributed_training_tpu_torch.models import create_model

    card = card_line()
    model = create_model("gpt2", dtype=torch.bfloat16, device="cuda",
                         seed=seed)
    entries = (pa.paged_decode_attention, pa.paged_decode_attention_multi,
               pa.paged_prefill_attention)
    launches = {"paged_decode_attention": 0, "_paged_multi_call": 0}

    def counted(leg, *a):
        for e in entries:
            e.launches = 0
        with serve_graphs() as run:
            out = leg(torch, model, seed, "cuda", *a)
        n11, n12m, n12p = (e.launches for e in entries)
        warm = warm_launches(run)
        check(n11 > warm.get("paged_decode_attention", 0)
              and n12p > warm.get("paged_prefill_attention", 0),
              f"{leg.__name__}: the paged kernels launched ({n11}, {n12m}, "
              f"{n12p}; warm-ups {warm})")
        print(f"fleet {leg.__name__}: "
              f"{graph_check(leg.__name__, run)}", flush=True)
        launches["paged_decode_attention"] += n11
        launches["_paged_multi_call"] += n12m + n12p
        return out, (n11, n12m, n12p)

    f1, n = counted(f1_leg)
    run, clean = f1[F1_FAULTS], f1["clean"]
    fo, (resp,) = run["fo"], run["respawns"]
    print(f"fleet F1 (2 paged GPT-2 124M replicas, 8 slots and a 64 MB host "
          f"tier each, {F1_FAULTS}; {card}): 16/16 once; death of replica 1 "
          f"at tick {fo['deaths'][0]['tick']}, requeued {fo['requeued']}, "
          f"retried {fo['retried']}, duplicates suppressed "
          f"{fo['duplicates_suppressed']}, respawn at tick {resp['tick']} "
          f"(backoff {run['delay']:.3f} s, {FLEET_DT} s a tick), reset "
          f"{resp['s'] * 1e3:.3f} ms host, memory_allocated "
          f"{resp['bytes']} B unchanged; detection + drain "
          f"{run['timing']['declare'] * 1e3:.3f} ms, requeues "
          f"{run['timing']['requeue'] * 1e3:.3f} ms host; requests "
          f"differing from the faultless run {run['differ']}/16 (none before "
          f"its requeue point, {len(run['retried_ids'])} retried); ticks "
          f"{run['ticks']} / {clean['ticks']} clean; {run['seconds']:.1f} / "
          f"{clean['seconds']:.1f} s; launches #11 {n[0]} #12 {n[1]} + "
          f"{n[2]}", flush=True)
    f2, n = counted(f2_leg)
    fo = f2["fo"]
    print(f"fleet F2 (--serve-disagg 2:6 paged, "
          f"{F2_FAULTS.format(drop=F2_DROP_TICK)}; {card}): 16/16 once; "
          f"events {f2['events']}, respawn at tick "
          f"{f2['respawns'][0]['tick']} (allocations unchanged), requeued "
          f"{fo['requeued']}, retried {fo['retried']}, {f2['handoffs']} "
          f"handoffs, audit clean; {f2['ticks']} ticks, "
          f"{f2['seconds']:.1f} s; launches #11 {n[0]} #12 {n[1]} + {n[2]}",
          flush=True)
    a1, n = counted(a1_leg, repo)
    st = a1["stats"]
    acts = [(h["tick"], h["action"], h["cause"]["signal"])
            for h in a1["history"]]
    print(f"fleet A1 (3 paged replicas, min 1, bursts of 16 and 8; {card}): "
          f"24/24; actions {acts}; active {st['replicas_active']}/3 at the "
          f"end; revives {len(a1['revives'])} with memory_allocated and "
          f"the pools unchanged; /slo controller block = snapshot(); "
          f"{a1['ticks']} busy ticks, {a1['seconds']:.1f} s; launches #11 "
          f"{n[0]} #12 {n[1]} + {n[2]}", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches


def generate_phase(torch, da, seed: int) -> None:
    """Lockstep generate at full width: 8 rows, 16 prompt + 8 new tokens."""
    from pytorch_distributed_training_tpu_torch.models import (
        create_model, generate,
    )

    model = create_model("gpt2", dtype=torch.bfloat16, device="cuda", seed=seed)
    prompt = torch.randint(
        0, 50257, (8, 16), generator=torch.Generator().manual_seed(seed)
    )
    da.decode_attention.launches = 0
    out = generate(model, prompt, max_new_tokens=8, temperature=0.0,
                   device="cuda")
    n9 = da.decode_attention.launches
    check(tuple(out.shape) == (8, 24), "generate: output shape")
    check(torch.equal(out[:, :16].cpu(), prompt), "generate: prompt kept")
    check(bool(((out >= 0) & (out < 50257)).all()), "generate: token range")
    check(n9 == LAYERS * 23, "generate: one launch per layer per tick")
    print(f"generate: (8, 24) tokens, decode_attention launches {n9}",
          flush=True)
    del model


def parity_phase(torch, seed: int) -> None:
    """A small f32 GPT-2 on the card (kernels) against the same weights on
    the host (plain versions): slot-mode logits of a prefill chunk, a
    decode tick and a verify chunk over the contiguous cache, the paged
    pool and the int8 paged pool, with an idle sentinel row; atol 1e-3."""
    from pytorch_distributed_training_tpu_torch.models import gpt2_124m

    torch.backends.cuda.matmul.allow_tf32 = False
    small = dict(num_layers=2, hidden_dim=64, num_heads=2, vocab_size=256,
                 max_seq_len=64)
    host = gpt2_124m(small, device="cpu", seed=seed).eval()
    card = gpt2_124m(small, device="cpu", seed=seed).to("cuda").eval()
    # Paged: blocks of 4, 12 per row (48 positions); row 0 takes blocks
    # 0..11, row 1 blocks 12..23 in reverse, row 2 is idle (sentinels).
    table = torch.tensor([list(range(12)), list(range(23, 11, -1)),
                          [40] * 12], dtype=torch.int32)
    layouts = {
        "contiguous": (lambda m: m.new_cache(3, 48), None),
        "paged": (lambda m: m.new_block_cache(40, 4), table),
        "paged int8": (lambda m: m.new_block_cache(40, 4, "int8"), table),
    }
    worst = {}
    with torch.no_grad():
        for label, (make, tbl) in layouts.items():
            caches = make(host), make(card)
            rng = torch.Generator().manual_seed(seed)
            worst[label] = 0.0
            for width, pos in ((12, [0, 5, 48]), (1, [12, 17, 48]),
                               (5, [13, 18, 48])):
                tok = torch.randint(0, 256, (3, width), generator=rng)
                p = torch.tensor(pos, dtype=torch.int32)
                ref = host(tok, cache=caches[0], positions=p,
                           block_table=tbl)
                out = card(tok.cuda(), cache=caches[1], positions=p.cuda(),
                           block_table=None if tbl is None else tbl.cuda())
                err = (out.cpu() - ref)[:2].abs().max().item()
                worst[label] = max(worst[label], err)
                check(err <= 1e-3,
                      f"parity {label} width {width}: max err {err:.3g}")
    print("parity: small f32 model, card vs host slot-mode logits max err "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + " (atol 1e-3)", flush=True)


def flash_bound_ms(batch: int, q_len: int, k_len: int, heads: int,
                   causal: bool, bandwidth: float) -> dict:
    """Least time of the forward and of the backward on these shapes
    (bf16): the live (query, key) pairs of the mask times 2 products of
    2 flops per head dim for the forward, 5 for the backward, against the
    bytes each must move once (forward: q, k, v, out and the f32 LSE;
    backward: q, k, v, dO, LSE and delta read, dq, dk and dv written)."""
    dh = 64
    if causal:
        off = k_len - q_len
        pairs = sum(max(0, min(k_len, i + off + 1)) for i in range(q_len))
    else:
        pairs = q_len * k_len
    pairs *= batch * heads
    act = batch * heads * dh * 2          # bytes per position of one tensor
    row = batch * heads * q_len * 4       # one f32 (B, H, Lq) tensor
    out = {}
    for part, n_products, nbytes in (
        ("fwd", 2, act * (2 * q_len + 2 * k_len) + row),
        ("bwd", 5, act * (3 * q_len + 4 * k_len) + 2 * row),
    ):
        t_ops = n_products * 2 * pairs * dh / PEAK_OPS["torch.bfloat16"]
        t_bytes = nbytes / bandwidth
        out[part] = (max(t_ops, t_bytes) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def _flash_inputs(torch, batch, q_len, k_len, heads, dtype, gen):
    """q, k, v as the model hands them over: strided (B, L, H, 64) views of
    one fused projection (separate q and fused k/v when the lengths
    differ), and a seeded dO."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    if q_len == k_len:
        q, k, v = rnd(batch, q_len, 3, heads, 64).unbind(2)
    else:
        q = rnd(batch, q_len, heads, 64)
        k, v = rnd(batch, k_len, 2, heads, 64).unbind(2)
    return q, k, v, rnd(batch, q_len, heads, 64)


def flash_kernel_phase(torch, fa, seed: int, bandwidth: float) -> dict:
    """The flash forward (out, LSE) and backward (dq, dk, dv from a seeded
    dO) against their plain versions on the card, at the four training
    shapes A-D in bf16 (timed) and at shape B in f32, a causal cross
    length (q 256, k 1024) and the non-causal L 197 (batch 4, and V3's
    ViT-B/16 batch 128 in bf16).  Tolerances: f32 out
    and LSE atol 2e-5, grads 2e-4 (the JAX tests' own); bf16 out, LSE and
    grads 2e-2 + 2e-2 |ref|: both sides round the same f32 p and ds to
    bf16 except where their f32 sums differ in the last bit across a
    rounding boundary (one bf16 ulp, 2^-8 relative, on a few terms of a
    sum), plus the final rounding of each result (half an ulp).
    ``library_ms``: SDPA's forward, and for the backward the aten
    flash-attention backward op on a saved forward (device time only).
    Ends with the forward's crossover against the plain attention path."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    scale = 64 ** -0.5
    cases = [(name, s["batch"], s["seq"], s["seq"], s["heads"], True,
              torch.bfloat16) for name, s in FLASH_SHAPES.items()]
    b = FLASH_SHAPES["B"]
    cases += [("B f32", b["batch"], b["seq"], b["seq"], b["heads"], True,
               torch.float32),
              ("cross-length", 2, 256, 1024, 12, True, torch.float32),
              ("cross-length", 2, 256, 1024, 12, True, torch.bfloat16),
              ("L197 non-causal", 4, 197, 197, 12, False, torch.float32),
              ("L197 non-causal", 4, 197, 197, 12, False, torch.bfloat16),
              ("V3 L197 non-causal", 128, 197, 197, 12, False,
               torch.bfloat16)]
    # The heads a rank holds under the sharded paths (M1: TP 2 and
    # Ulysses 2 at 4 rows a rank; TP 4 at 8), timed beside rows #4/#5.
    cases += [(label, b, n, n, h, True, torch.bfloat16)
              for label, (b, n, h) in SHARDED_FLASH.items()]
    rows = {}
    for label, batch, q_len, k_len, heads, causal, dtype in cases:
        q, k, v, do = _flash_inputs(torch, batch, q_len, k_len, heads, dtype,
                                    gen)
        kw = dict(causal=causal, scale=scale)

        def fwd(q=q, k=k, v=v, kw=kw):
            return fa.flash_fwd(q, k, v, **kw)

        out, lse = fwd()
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()

        def bwd(q=q, k=k, v=v, do=do, lse=lse, delta=delta, kw=kw):
            return (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                    *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))

        grads = bwd()
        ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal, scale)
        ref_grads = fa.flash_bwd_plain(q, k, v, do, ref_lse, delta, causal,
                                       scale)
        torch.cuda.synchronize()
        lowp = dtype is torch.bfloat16
        errs = {}
        for name, got, ref in (("out", out, ref_out), ("lse", lse, ref_lse),
                               *zip(("dq", "dk", "dv"), grads, ref_grads)):
            atol = 2e-2 if lowp else (2e-5 if name in ("out", "lse") else 2e-4)
            rtol = 2e-2 if lowp else 0.0
            err = (got.float() - ref.float()).abs()
            check(bool(torch.isfinite(got.float()).all()),
                  f"flash {label} {name} finite")
            check(bool((err <= atol + rtol * ref.float().abs()).all()),
                  f"flash {label} {dtype} {name} within atol {atol} rtol "
                  f"{rtol} (max err {err.max().item():.3g})")
            errs[name] = err.max().item()
        line = (f"kernel flash {label} ({batch}x{q_len}x{k_len}, H {heads}, "
                f"{'causal' if causal else 'non-causal'}, {str(dtype)[6:]}): "
                "max_abs_err " + ", ".join(f"{n} {e:.3g}"
                                          for n, e in errs.items()))
        if label in FLASH_SHAPES:
            shape = FLASH_SHAPES[label]
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            do_t = do.transpose(1, 2)
            sdpa_bwd = _sdpa_flash_backward(torch, qt, kt, vt, do_t, scale)
            timed = {
                "fwd": (fwd, lambda: fa.flash_fwd_plain(q, k, v, causal, scale),
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True)),
                "bwd": (bwd, lambda: fa.flash_bwd_plain(
                            q, k, v, do, lse, delta, causal, scale),
                        sdpa_bwd),
            }
            bounds = flash_bound_ms(batch, q_len, k_len, heads, causal,
                                    bandwidth)
            for part, (kernel, plain, library) in timed.items():
                ms, plain_ms, library_ms = (time_ms(torch, f)
                                            for f in (kernel, plain, library))
                bms, by = bounds[part]
                num = shape[part]
                fn_name, def_line = FLASH_ROWS[num]
                rows[num] = dict(
                    name=fn_name, route="cuda", source=FLASH_SOURCE,
                    replaces=f"{PALLAS}:{def_line}", launches=0,
                    max_abs_err=(errs["out"] if part == "fwd"
                                 else max(errs["dq"], errs["dk"], errs["dv"])),
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=library_ms, shape=label,
                    kernels=("flash_fwd_kernel" if part == "fwd" else
                             "flash_bwd_dq_kernel + flash_bwd_dkv_kernel"),
                )
                line += (f"; #{num} {part} {ms * 1e3:.1f} us, plain "
                         f"{plain_ms * 1e3:.1f} us, sdpa {library_ms * 1e3:.1f}"
                         f" us, bound {bms * 1e3:.2f} us ({by})")
            del sdpa_bwd
        if label in SHARDED_FLASH:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            bounds = flash_bound_ms(batch, q_len, k_len, heads, causal,
                                    bandwidth)
            sdpa_bwd = _sdpa_flash_backward(torch, qt, kt, vt,
                                            do.transpose(1, 2), scale)
            for part, kernel, plain, library in (
                    ("fwd", fwd, lambda: fa.flash_fwd_plain(
                        q, k, v, causal, scale),
                     lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=True)),
                    ("bwd", bwd, lambda: fa.flash_bwd_plain(
                        q, k, v, do, lse, delta, causal, scale), sdpa_bwd)):
                ms, plain_ms, library_ms = (time_ms(torch, f)
                                            for f in (kernel, plain, library))
                line += (f"; #{4 if part == 'fwd' else 5} {part} "
                         f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
                         f"sdpa {library_ms * 1e3:.1f} us, bound "
                         f"{bounds[part][0] * 1e3:.2f} us "
                         f"({bounds[part][1]})")
            del sdpa_bwd
        print(line, flush=True)
    flash_crossover(torch, fa, gen)
    return rows


def flash_crossover(torch, fa, gen) -> None:
    """The flash forward against the plain path that ``ops/attention.py``
    takes below its flash threshold (``_xla_attention``), at causal
    L 128, 256 and 512 (bf16, 12 heads, 8192 tokens a call: T1's
    microbatch).  Measured only; the dispatch rule is not changed here."""
    from pytorch_distributed_training_tpu_torch.ops import attention as attn

    parts = []
    with torch.no_grad():
        for length in (128, 256, 512):
            q, k, v, _ = _flash_inputs(torch, 8192 // length, length, length,
                                       12, torch.bfloat16, gen)
            flash_ms = time_ms(torch, lambda: fa.flash_fwd(q, k, v,
                                                           causal=True))
            plain_ms = time_ms(torch, lambda: attn._xla_attention(
                q, k, v, causal=True))
            parts.append(f"L {length} flash {flash_ms * 1e3:.1f} us, plain "
                         f"{plain_ms * 1e3:.1f} us ({plain_ms / flash_ms:.2f}x)")
    print("flash crossover (forward, bf16 causal, H 12, 8192 tokens a "
          "call): " + "; ".join(parts), flush=True)


def _sdpa_flash_backward(torch, qt, kt, vt, do_t, scale):
    """SDPA's backward as one device call: the aten flash-attention
    backward op on a saved forward of the same (B, H, L, D) inputs
    (causal), with no autograd work on the host between the timer's
    events.  Returns the call."""
    aten = torch.ops.aten
    (out, lse, cum_q, cum_k, max_q, max_k, seed, offset,
     _) = aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, True, False, scale=scale)

    def call():
        return aten._scaled_dot_product_flash_attention_backward(
            do_t, qt, kt, vt, out, lse, cum_q, cum_k, max_q, max_k, 0.0,
            True, seed, offset, scale=scale)

    return call


def _count_calls(module, names, counts):
    """Wrap ``module.<name>`` so each call adds one to ``counts[name]``;
    returns the originals for restoring."""
    originals = {}
    for name in names:
        fn = getattr(module, name)
        originals[name] = fn

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        setattr(module, name, counted)
    return originals


R2_ARGV = ["--model", "resnet50", "--dataset", "synthetic-images",
           "--image-size", "224", "--precision", "bf16", "--batch-size",
           "128", "--optimizer", "sgd", "--epochs", "2", "--steps-per-epoch",
           "20", "--num-workers", "6"]
CLI = "pytorch_distributed_training_tpu_torch.cli.main"
DP_CHECK = "pytorch_distributed_training_tpu_torch.tools.dp_check"
# The checkpoint phase's directories (T1 writes its epoch-end save here
# too); removed when the phase ends.
CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                    "chip_smoke", "ckpt")


TRAIN_COMMON = ["--dataset", "synthetic-tokens", "--precision", "bf16",
                "--num-workers", "0"]
T1_RECIPE = ["--model", "gpt2", "--seq-len", "1024", "--batch-size", "16",
             "--accum-steps", "2", "--optimizer", "adamw", "--learning-rate",
             "6e-4", "--weight-decay", "0.1", "--grad-clip", "1.0",
             "--lr-schedule", "warmup-cosine", "--warmup-steps", "2",
             "--total-steps", "8"]
# The 4-rank gloo legs of GPT-2 (M1, M2, P1, P2) run T1's recipe at
# GPT-2 124M's widths cut to GLOO_LAYERS blocks: on one card their steps
# and checkpoints are the host's staging of every parameter, and 4 is the
# least depth PP 4 takes (a block a stage).
GLOO_LAYERS = 4
GLOO_DEPTH = ["--model-overrides", f"num_layers={GLOO_LAYERS}"]
# (label, argv, layers, microbatches, steps, remat, flash rows)
TRAIN_RUNS = [
    ("T2", ["--model", "gpt2", "--seq-len", "512", "--batch-size", "16",
            "--accum-steps", "2", "--steps-per-epoch", "2"],
     12, 2, 2, False, (2, 3)),
    ("T3", ["--model", "gpt2_xl", "--model-overrides", "num_layers=2",
            "--seq-len", "1024", "--batch-size", "4", "--steps-per-epoch",
            "2"], 2, 1, 2, False, (1, 7)),
    ("T4", ["--model", "gpt2", "--model-overrides",
            "num_layers=2,max_seq_len=2048", "--seq-len", "2048",
            "--batch-size", "4", "--steps-per-epoch", "2"],
     2, 1, 2, False, (6, 8)),
    ("T1", T1_RECIPE + ["--steps-per-epoch", "8", "--checkpoint-dir",
                        os.path.join(CKPT, "t1")], 12, 2, 8, False, (4, 5)),
    ("T5", T1_RECIPE + ["--steps-per-epoch", "2", "--remat", "--ce-chunk",
                        "256"], 12, 2, 2, True, (4, 5)),
]


def training_phase(torch, fa, seed: int, figures: dict) -> dict:
    """The CLI trains on the card (bf16, synthetic tokens, full width).
    T2 warms the process up and routes to #2/#3 (L 512), T3 to #1/#7 (XL
    widths, 25 heads), T4 to #6/#8 (L 2048), T1 is the main path (#4/#5,
    GPT-2 124M at L 1024, the published recipe's optimizer), T5 is T1 with
    remat and chunked CE.  In every run the forward kernel launches once
    per layer per microbatch per step (twice under remat), the dq and
    dk/dv kernels once each, and the plain flash versions and the plain
    attention path not at all.  Returns the launches by row; T1's tokens/s
    and step ms go into ``figures["T1"]``."""
    from pytorch_distributed_training_tpu_torch.cli.main import main as cli
    from pytorch_distributed_training_tpu_torch.comm import collectives
    from pytorch_distributed_training_tpu_torch.ops import attention as attn

    entries = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    plain = {"flash_fwd_plain": 0, "_bwd_tiles": 0, "flash_bwd_plain": 0}
    xla = {"_xla_attention": 0, "_xla_attention_remat": 0}
    saved = (_count_calls(fa, list(plain), plain),
             _count_calls(attn, list(xla), xla))
    launches = {}
    try:
        for label, argv, layers, micro, steps, remat, row_nums in TRAIN_RUNS:
            for e in entries:
                e.launches = 0
            for c in (plain, xla):
                for k in c:
                    c[k] = 0
            trainer = cli(argv + TRAIN_COMMON + ["--seed", str(seed)])
            n_fwd, n_dq, n_dkv = (e.launches for e in entries)
            losses = trainer.last_epoch_losses
            summary = trainer.history[-1]
            want = layers * micro * steps
            check(trainer.state.step == steps, f"{label}: {steps} steps")
            check(all(x == x and abs(x) != float("inf") for x in losses),
                  f"{label}: logged losses finite ({losses})")
            check(n_fwd == want * (2 if remat else 1) and n_dq == want
                  and n_dkv == want,
                  f"{label}: flash launches fwd {n_fwd} dq {n_dq} dkv "
                  f"{n_dkv}, expected {want} each (fwd x2 under remat)")
            check(not any(plain.values()) and not any(xla.values()),
                  f"{label}: attention outside the kernels {plain} {xla}")
            fwd_row, bwd_row = row_nums
            launches[fwd_row] = launches.get(fwd_row, 0) + n_fwd
            launches[bwd_row] = launches.get(bwd_row, 0) + n_dq + n_dkv
            line = (f"train {label} (#{fwd_row}/#{bwd_row}): {steps} steps, "
                    f"losses {[round(x, 4) for x in losses]}, "
                    f"{summary['examples_per_sec']:.2f} examples/s, "
                    f"launches fwd {n_fwd} dq {n_dq} dkv {n_dkv}")
            if label == "T1":
                check(10.0 <= losses[0] <= 12.0,
                      f"T1 first loss {losses[0]} near ln 50257 = 10.8")
                model = trainer.state.model
                cfg = model.cfg
                n_params = sum(p.numel() for p in model.parameters())
                seq = 1024
                flops_per_token = (6 * n_params
                                   + 12 * cfg.num_layers * seq * cfg.hidden_dim)
                tok_s = summary["examples_per_sec"] * seq
                figures["T1"] = (tok_s, summary["elapsed_s"] / steps * 1e3)
                line += (f"; {tok_s:.0f} tokens/s, step "
                         f"{summary['elapsed_s'] / steps * 1e3:.1f} ms, MFU "
                         f"{flops_per_token * tok_s / 989e12 * 100:.2f} % "
                         f"({n_params} params, {flops_per_token:.4g} "
                         "flop/token, 989 TF/s)")
            print(line, flush=True)
            del trainer
            torch.cuda.empty_cache()
    finally:
        for module, originals in zip((fa, attn), saved):
            for name, fn in originals.items():
                setattr(module, name, fn)
    return launches


# T6: T1's recipe with the MoE GPT-2 (this slice's main path): GPT-2 124M
# widths, 8 experts in every odd block, capacity factor 1.25, the CLI's
# scatter dispatch, 3 steps; then two steps of the same batches in
# einsum mode.  Both select the same experts (a one-hot einsum adds zeros
# only), so einsum's losses are held to scatter's at 1e-4 (the first 0
# in each of this leg's chip runs, PERF.md), its drop rates exactly, and
# its update of the MoE leaves over the two steps (the warmup's first
# rate is 0) to scatter's within T6_UPDATE_BOUND (relative L2): an
# einsum that dropped the combine or picked other experts moves them
# apart by ~1 (Adam's early steps are about lr times the gradient's
# sign), where bf16 rounding flips only the signs of near-zero
# gradients.
T6_ARGV = [*T1_RECIPE, "--model", "gpt2_moe"]
T6_PARAMS = 322_634_544
T6_EINSUM_BOUND = 1e-4
T6_UPDATE_BOUND = 0.25
T6_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "chip_smoke", "t6")


def _update_rel_l2(a: list, b: list) -> float:
    """The relative L2 distance of run ``a``'s update from run ``b``'s
    (``cli_runs``' ``grab``: the leaves before the first step, the same
    start, and after the same step)."""
    num = den = 0.0
    for name, b0 in b[0].items():
        check(bool((a[0][name] == b0).all()), f"T6: {name} starts the same")
        du, dv = a[1][name] - b0, b[1][name] - b0
        num += float((du - dv).norm()) ** 2
        den += float(dv.norm()) ** 2
    return (num / den) ** 0.5


def moe_train_phase(torch, seed: int, carry: dict) -> dict:
    """T6 through the CLI on the card (module docstring of the phase
    list), two ``cli_runs`` in this process: scatter 3 steps, einsum 2
    steps on the same batches.  Exact flash #4/#5 launches (12 layers x
    2 microbatches a step), no plain attention, ``gpt2_moe`` at
    ``T6_PARAMS``, the first loss near ln 50257 (+ 0.01 aux), the drop
    rates fractions; einsum held to scatter (``T6_EINSUM_BOUND``, the
    drop rates exactly, ``T6_UPDATE_BOUND``); tokens/s, step time and
    peak memory printed.  Scatter's losses go to P3
    (``carry["t6"]``).  Returns the launches by row."""
    import shutil

    shutil.rmtree(T6_DIR, ignore_errors=True)
    os.makedirs(T6_DIR)
    runs = [dict(label=label, grab=[".moe.", 2], argv=[
        *T6_ARGV, "--steps-per-epoch", str(steps), *extra, *TRAIN_COMMON,
        "--seed", str(seed)]) for label, steps, extra in (
            ("scatter", 3, []),
            ("einsum", 2, ["--model-overrides", "moe_dispatch=einsum"]))]
    records = cli_runs(torch, T6_DIR, runs, 0)
    shutil.rmtree(T6_DIR, ignore_errors=True)
    fwd = bwd = 0
    for run in runs:
        label = run["label"]
        r = records[label]
        steps = int(run["argv"][run["argv"].index("--steps-per-epoch") + 1])
        want = 12 * 2 * steps
        launched = [r["fwd"], r["dq"], r["dkv"]]
        check(r["steps"] == steps and launched == [want] * 3
              and not any(r["plain"].values()) and not any(r["xla"].values()),
              f"T6 {label}: {steps} steps, flash fwd/dq/dkv {launched} "
              f"({want} each), no plain attention {r['plain']} {r['xla']}")
        fwd += r["fwd"]
        bwd += r["dq"] + r["dkv"]
        check(r["dispatch"] == label and r["params"] == T6_PARAMS,
              f"T6 {label}: gpt2_moe with {T6_PARAMS} parameters "
              f"({r['params']}), dispatch {r['dispatch']}")
        losses, drops = r["losses"], r["drops"]
        check(_finite(losses) and 10.0 <= losses[0] <= 12.0
              and len(drops) == steps and all(0.0 <= d <= 1.0 for d in drops),
              f"T6 {label}: losses {losses}, the first near ln 50257 "
              f"(+ 0.01 aux), drop rates {drops} in [0, 1]")
    sc, ei = records["scatter"], records["einsum"]
    step_ms = statistics.median(sc["step_s"][1:]) * 1e3
    d = max(abs(x - y) for x, y in zip(ei["losses"], sc["losses"]))
    update = _update_rel_l2(ei["grab"], sc["grab"])
    n_leaves = len(sc["grab"][0])
    del records, sc["grab"], ei["grab"]
    print(f"train T6 (#4/#5; gpt2_moe, {T6_PARAMS} parameters, E 8, cf "
          f"1.25, bf16, L 1024, 16 = 2 x 8 rows, adamw 6e-4, scatter, 3 "
          f"steps): losses {[round(x, 5) for x in sc['losses']]}, drop "
          f"rates {[round(x, 4) for x in sc['drops']]}, step (median of "
          f"steps 2-3) {step_ms:.1f} ms, {16 * 1024 / step_ms * 1e3:.0f} "
          f"tokens/s, peak memory {sc['peak_mem_gb']:.2f} GB, flash "
          f"fwd/dq/dkv 72 each; einsum mode on the first 2 batches: "
          f"losses {ei['losses']} vs scatter's {sc['losses'][:2]} (at most "
          f"{d:.3g}, bound {T6_EINSUM_BOUND}), drop rates {ei['drops']} vs "
          f"{sc['drops'][:2]} (exact), update of the {n_leaves} MoE leaves "
          f"over the 2 steps vs scatter's: relative L2 {update:.3g} (bound "
          f"{T6_UPDATE_BOUND}); step {ei['step_s'][1] * 1e3:.1f} ms (the "
          f"second), peak memory {ei['peak_mem_gb']:.2f} GB", flush=True)
    check(d <= T6_EINSUM_BOUND, f"T6: einsum's losses vs scatter's {d:.3g} "
          f"within {T6_EINSUM_BOUND}")
    check(ei["drops"] == sc["drops"][:2], f"T6: einsum's drop rates "
          f"{ei['drops']} are scatter's {sc['drops'][:2]}")
    check(update <= T6_UPDATE_BOUND, f"T6: einsum's update of the MoE "
          f"leaves vs scatter's {update:.3g} within {T6_UPDATE_BOUND}")
    carry["t6"] = sc["losses"]
    # The 322 M-parameter state's blocks go back to the card for the
    # later phases' ranks.
    gc.collect()
    torch.cuda.empty_cache()
    return {4: fwd, 5: bwd}


def train_parity_phase(torch, fa, seed: int) -> None:
    """Three f32 training steps of a small GPT-2 (2 layers, hidden 128, 2
    heads of 64, vocab 512, seq 256, batch 4, accumulation 2, adam) on the
    card (flash kernels) and on the host (plain attention) from the same
    weights: per-step losses within 1e-4 and every weight within 1e-4,
    except the key third of each qkv bias, whose gradient is zero in exact
    arithmetic (softmax ignores a per-query constant), so that Adam turns
    both sides' rounding noise into steps of up to lr: it is held to
    2 x steps x lr."""
    import copy

    import numpy as np

    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer,
    )
    from pytorch_distributed_training_tpu_torch.models import gpt2_124m
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    lr, steps = 1e-3, 3
    cfg = dict(num_layers=2, hidden_dim=128, num_heads=2, vocab_size=512,
               max_seq_len=256)
    host_model = gpt2_124m(cfg, device="cpu", seed=seed)
    card_model = copy.deepcopy(host_model).to("cuda")
    rng = np.random.default_rng(seed)
    batches = [rng.integers(0, 512, (4, 256)).astype(np.int32)
               for _ in range(steps)]
    policy = make_policy("f32")
    results = {}
    fa.flash_fwd.launches = 0
    for where, model in (("host", host_model), ("card", card_model)):
        state = create_train_state(
            model, build_optimizer("adam", lr, weight_decay=1e-3),
            policy=policy)
        step = make_train_step(kind="lm", policy=policy, num_microbatches=2)
        losses = []
        for b in batches:
            state, m = step(state, {"tokens": torch.from_numpy(b).to(
                model.wte.device)})
            losses.append(float(m["loss"]))
        results[where] = (losses, {k: v.detach().cpu()
                                   for k, v in state.params.items()})
    check(fa.flash_fwd.launches == 2 * 2 * steps,
          f"parity: the card ran the flash kernels ({fa.flash_fwd.launches})")
    (hl, hp), (cl, cp) = results["host"], results["card"]
    loss_err = max(abs(a - b) for a, b in zip(hl, cl))
    worst, worst_kbias = 0.0, 0.0
    for name, ref in hp.items():
        diff = (cp[name] - ref).abs()
        if name.endswith("attn.qkv.bias"):
            d = ref.shape[0] // 3
            worst_kbias = max(worst_kbias, diff[d:2 * d].max().item())
            diff = torch.cat([diff[:d], diff[2 * d:]])
        worst = max(worst, diff.max().item())
    check(loss_err <= 1e-4, f"parity: losses {cl} vs host {hl}")
    check(worst <= 1e-4, f"parity: max weight difference {worst:.3g}")
    check(worst_kbias <= 2 * steps * lr,
          f"parity: key bias difference {worst_kbias:.3g}")
    print(f"train parity: small f32 GPT-2, 3 steps card vs host: losses "
          f"{[round(x, 6) for x in cl]}, max loss diff {loss_err:.3g} "
          f"(1e-4), max weight diff {worst:.3g} (1e-4), key-bias diff "
          f"{worst_kbias:.3g} (bound {2 * steps * lr:g})", flush=True)


def _recording_steps(losses: list):
    """Wrap the port's ``make_train_step`` so every step's loss (a device
    tensor: nothing waits for it) goes into ``losses``; returns the
    original for restoring."""
    import pytorch_distributed_training_tpu_torch.train as train

    original = train.make_train_step

    def make(**kw):
        step = original(**kw)

        def recorded(state, batch):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
            return state, metrics

        return recorded

    train.make_train_step = make
    return original


def resnet_train_flops(torch, model, size: int) -> float:
    """Model flops of training on one image: 3x the forward's (forward,
    then backward for inputs and weights), 2 per multiply-add of every
    convolution (the stem as its 7x7 conv) and the head; norms, ReLU and
    pooling are not counted."""
    macs = []

    def hook(module, inputs, out):
        macs.append(module.weight[0].numel() * out[0].numel())

    kinds = (torch.nn.Conv2d, torch.nn.Linear)
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, kinds) or type(m).__name__ == "SpaceToDepthStem"]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            w = next(model.parameters())
            model(torch.zeros(1, 3, size, size, device=w.device,
                              dtype=w.dtype).contiguous(
                                  memory_format=torch.channels_last))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    return 3 * 2 * float(sum(macs))


def write_cifar_archive(root: str, seed: int, per_batch: int = 1000) -> str:
    """A CIFAR-10 python-version tree of random bytes from ``seed`` (5
    train batches and the test batch), the layout the reader takes."""
    import pickle

    import numpy as np

    folder = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        entry = {"data": rng.integers(0, 256, (per_batch, 3072),
                                      dtype=np.uint8),
                 "labels": rng.integers(0, 10, per_batch).tolist()}
        with open(os.path.join(folder, name), "wb") as f:
            pickle.dump(entry, f)
    return root


def _finite(values) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values)


def _warm_epoch_line(trainer, steps: int) -> tuple[float, float]:
    """(images/s, step ms) of the last epoch: the first epoch carries the
    cuDNN and allocator warm-up."""
    s = trainer.history[-1]
    return s["examples_per_sec"], s["elapsed_s"] / steps * 1e3


def image_phase(torch, seed: int, repo: str, figures: dict) -> None:
    """The image-classifier path through the CLI (no TPU kernel on it:
    convolutions, pooling and the head are cuDNN/cuBLAS calls, the norms
    the port's BatchNorm functions).  R1 the reference run, then its
    batches read from a CIFAR-10 archive by the native gather; R2
    ResNet-50 at ImageNet width in bf16; R3 learnability on ``shapes``;
    R4 a shallow f32 ResNet, card against host.  R2's images/s and step
    ms go into ``figures["R2"]``."""
    import numpy as np

    from pytorch_distributed_training_tpu_torch.cli.main import main as cli
    from pytorch_distributed_training_tpu_torch.data import native

    # R1: the reference's command (ResNet-18, CIFAR-10-shaped synthetic
    # data, batch 32, adam lr 0.1, wd 1e-3, f32, the ImageNet stem at 32
    # px), 2 epochs of 50 steps; the second is timed warm.
    trainer = cli(["--model", "resnet18", "--dataset", "cifar10",
                   "--synthetic-data", "--epochs", "2", "--steps-per-epoch",
                   "50", "--seed", str(seed)])
    losses = [h["loss"] for h in trainer.history]
    check(trainer.state.step == 100, "R1: 100 steps")
    check(_finite(losses) and _finite(trainer.last_epoch_losses),
          f"R1: losses finite ({losses})")
    check(next(iter(trainer.state.params.values())).is_cuda, "R1 on the card")
    img_s, step_ms = _warm_epoch_line(trainer, 50)
    print(f"image R1 (ResNet-18, CIFAR-10 synthetic, batch 32, adam, f32): "
          f"100 steps, epoch losses {[round(x, 4) for x in losses]}, "
          f"accuracy {trainer.history[-1]['accuracy']:.4f}; warm epoch "
          f"{img_s:.1f} images/s, step {step_ms:.2f} ms; batches from "
          "SyntheticImages through the 2-process worker pool", flush=True)
    del trainer
    archive = write_cifar_archive(
        os.path.join(repo, "build", "chip_smoke", "cifar10"), seed)
    native.gather_images_u8.calls = 0
    trainer = cli(["--model", "resnet18", "--data-dir", archive,
                   "--steps-per-epoch", "20", "--seed", str(seed)])
    calls = native.gather_images_u8.calls
    check(trainer.state.step == 20 and calls == 20,
          f"R1 archive: 20 steps, native gathers {calls}")
    check(_finite(trainer.last_epoch_losses), "R1 archive: losses finite")
    img_s, step_ms = _warm_epoch_line(trainer, 20)
    print(f"image R1 archive (the same command reading a CIFAR-10 archive "
          f"of random bytes): 20 steps, native gathers {calls}, losses "
          f"{[round(x, 4) for x in trainer.last_epoch_losses]}, "
          f"{img_s:.1f} images/s", flush=True)
    del trainer

    # R2: ResNet-50 at ImageNet width (224 px, 1000 classes), bf16, batch
    # 128, sgd with momentum; 2 epochs of 20 steps, the second timed (each
    # epoch starts its worker pipeline empty).
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = cli(R2_ARGV + ["--seed", str(seed)])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in trainer.history]
    check(trainer.state.step == 40, "R2: 40 steps")
    check(_finite(losses) and _finite(trainer.last_epoch_losses),
          f"R2: losses finite ({losses})")
    img_s, step_ms = _warm_epoch_line(trainer, 20)
    figures["R2"] = (img_s, step_ms)
    flops = resnet_train_flops(torch, trainer.state.model, 224)
    print(f"image R2 (ResNet-50, 224 px, 1000 classes, bf16, batch 128, "
          f"sgd): 40 steps, epoch losses {[round(x, 4) for x in losses]}; "
          f"warm epoch {img_s:.1f} images/s/chip, step {step_ms:.1f} ms, "
          f"peak memory {peak_gb:.2f} GB, MFU "
          f"{flops * img_s / 989e12 * 100:.2f} % ({flops / 1e9:.2f} "
          "GFLOP an image trained, 989 TF/s dense bf16)", flush=True)
    del trainer
    torch.cuda.empty_cache()

    # R3: learnability. ResNet-18 on the procedural shapes, sgd lr 0.02
    # (the CLI's 0.1 first blows the loss up to ~6 and spends the run
    # recovering), batch 128, 150 steps; every step's loss is recorded.
    step_losses: list = []
    original = _recording_steps(step_losses)
    try:
        trainer = cli(["--model", "resnet18", "--dataset", "shapes",
                       "--optimizer", "sgd", "--learning-rate", "0.02",
                       "--batch-size", "128", "--steps-per-epoch", "150",
                       "--num-workers", "6", "--seed", str(seed)])
    finally:
        import pytorch_distributed_training_tpu_torch.train as train
        train.make_train_step = original
    values = [float(x) for x in step_losses]
    first, last = np.mean(values[:10]), np.mean(values[-10:])
    check(len(values) == 150 and _finite(values), "R3: 150 finite losses")
    check(last < first and last < math.log(10),
          f"R3: mean loss of the last 10 steps {last:.4f} below the first "
          f"10's {first:.4f} and chance, ln 10")
    img_s, _ = _warm_epoch_line(trainer, 150)
    print(f"image R3 (ResNet-18 on shapes, sgd lr 0.02, batch 128): 150 "
          f"steps, mean "
          f"loss first 10 {first:.4f}, last 10 {last:.4f}, accuracy at the "
          f"last log point {trainer.history[-1]['accuracy']:.4f}, "
          f"{img_s:.1f} images/s", flush=True)
    del trainer
    resnet_parity_phase(torch, seed)


def maxpool_tie_check(torch, seed: int) -> None:
    """The stem's 3x3/s2 max pool on post-ReLU input (half zeros, so many
    windows tie at 0): the gradient must reach the same position of each
    tied window on the card as on the host (flax's ``max_pool``, whose
    tie goes to one position, agrees with the host)."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(8, 16, 16, 16, generator=gen) - 0.5)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(8, 16, 8, 8, generator=gen)
    grads = []
    for dev in ("cpu", "cuda"):
        xt = x.to(dev).requires_grad_()
        y = F.max_pool2d(xt, 3, 2, 1)
        (g,) = torch.autograd.grad(y, xt, dy.to(dev))
        grads.append(g.cpu())
    # Each channel's 3x3 windows (padding below any value, as the pool's).
    windows = F.unfold(F.pad(x.contiguous(), (1, 1, 1, 1), value=-1.0), 3,
                       stride=2).view(8, 16, 9, -1)
    tied = int(((windows == 0).sum(2) > 1).logical_and(
        windows.amax(2) == 0).sum())
    same = torch.equal(grads[0], grads[1])
    check(same, f"R4: max-pool gradient at {tied} tied windows differs "
          "between card and host")
    print(f"image R4 max-pool ties: {tied} tied windows of "
          f"{y.numel()}, gradient positions equal card vs host: {same}",
          flush=True)


def resnet_parity_phase(torch, seed: int) -> None:
    """R4, TF32 off: the ImageNet stem's pieces on the card against the
    host (the s2d convolution against the plain 7x7 stride-2 conv, the max
    pool's tie positions), then a shallow f32 ResNet (BasicBlock, stage
    sizes (1, 1), 32 px, 10 classes, the fused norms) trains 3 sgd steps
    of batch 32 in 2 microbatches on the card and on the host from the
    same weights: losses, weights and running statistics within 1e-4.

    The training model takes the CIFAR stem, without the max pool: a
    pool's argmax is discontinuous, and a near-tie that the card's
    rounding tips the other way sends a gradient element elsewhere, which
    the three steps then amplify."""
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.models import resnet
    from pytorch_distributed_training_tpu_torch.ops.s2d_stem import s2d_conv

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        maxpool_tie_check(torch, seed)
        gen = torch.Generator().manual_seed(seed)
        x = torch.rand(16, 3, 224, 224, generator=gen).contiguous(
            memory_format=torch.channels_last)
        k = torch.randn(64, 3, 7, 7, generator=gen) * 0.1
        s2d_card = s2d_conv(x.cuda(), k.cuda()).cpu()
        err_plain = (s2d_card - F.conv2d(x.cuda(), k.cuda(), stride=2,
                                         padding=3).cpu()).abs().max().item()
        err_host = (s2d_card - s2d_conv(x, k)).abs().max().item()
        check(err_plain <= 1e-5 and err_host <= 1e-5,
              f"R4: s2d stem on the card {err_plain:.3g} from the 7x7 conv, "
              f"{err_host:.3g} from the host")
        print(f"image R4 s2d stem (224 px, f32): card vs the plain 7x7/s2 "
              f"conv {err_plain:.3g}, vs the host {err_host:.3g} (1e-5)",
              flush=True)
        host_model = resnet.resnet18(
            10, {"stage_sizes": (1, 1), "small_stem": True}, device="cpu",
            seed=seed)
        cl, loss_err, name, err = card_host_steps(torch, host_model, 32, 32,
                                                  seed, "R4")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    print(f"image R4 (shallow f32 ResNet, CIFAR stem, 3 sgd steps, card vs "
          f"host, TF32 off): losses {[round(x, 6) for x in cl]}, max loss diff "
          f"{loss_err:.3g} (1e-4), max weight/statistic diff "
          f"{err:.3g} at {name} (1e-4)", flush=True)


def card_host_steps(torch, host_model, batch: int, size: int, seed: int,
                    tag: str) -> tuple:
    """Three f32 sgd steps (lr 0.05, wd 1e-3, 2 microbatches) of a
    10-class ``host_model`` on the host and of its copy on the card from
    the same weights, on seeded batches of ``batch`` ``size``-px images;
    fails unless losses, weights and running statistics agree within
    1e-4.  Returns (card losses, max loss difference, the name of the
    tensor that differs most, its difference)."""
    import copy

    import numpy as np

    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, make_train_step,
    )

    card_model = copy.deepcopy(host_model).to("cuda")
    rng = np.random.default_rng(seed)
    batches = [(rng.random((batch, size, size, 3), np.float32),
                rng.integers(0, 10, batch).astype(np.int32))
               for _ in range(3)]
    policy = make_policy("f32")
    results = {}
    for where, model in (("host", host_model), ("card", card_model)):
        dev = next(model.parameters()).device
        state = create_train_state(
            model, build_optimizer("sgd", 0.05, weight_decay=1e-3),
            policy=policy)
        step = make_train_step(kind="image_classifier", policy=policy,
                               num_microbatches=2)
        losses = []
        for x, y in batches:
            state, m = step(state, {"image": torch.from_numpy(x).to(dev),
                                    "label": torch.from_numpy(y).to(dev)})
            losses.append(float(m["loss"]))
        results[where] = (losses, {
            k: v.detach().cpu() for k, v in
            {**state.params, **state.batch_stats}.items()})
    (hl, hp), (cl, cp) = results["host"], results["card"]
    loss_err = max(abs(a - b) for a, b in zip(hl, cl))
    worst = {k: (cp[k] - v).abs().max().item() for k, v in hp.items()}
    name = max(worst, key=worst.get)
    check(loss_err <= 1e-4, f"{tag}: losses {cl} vs host {hl}")
    check(worst[name] <= 1e-4,
          f"{tag}: max weight/statistic difference {worst[name]:.3g} "
          f"({name})")
    return cl, loss_err, name, worst[name]


def torchrun(repo: str, nproc: int, argv: list, timeout: float) -> str:
    """``python -m torch.distributed.run --standalone`` with ``nproc``
    ranks, in its own session: on a failure or at the time limit every
    process it started is killed.  Returns its stdout; a non-zero exit
    fails the run."""
    return torchrun_wait(torchrun_start(repo, nproc, argv), argv, timeout)


def torchrun_start(repo: str, nproc: int, argv: list):
    """Start ``torchrun`` (see ``torchrun``) without waiting for it."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), *argv], cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def torchrun_wait(proc, argv: list, timeout: float) -> str:
    """Wait for a ``torchrun_start`` process (see ``torchrun``)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None or proc.returncode != 0:
            torchrun_kill(proc)
    check(proc.returncode == 0,
          f"torchrun {' '.join(argv[:3])}: exit {proc.returncode}\n"
          f"{out[-4000:]}\n{err[-4000:]}")
    return out


def torchrun_kill(proc) -> None:
    """Kill every process of a ``torchrun_start`` session."""
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _records(path: str) -> list:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def cli_leg(out: str, argv: list) -> int:
    """One rank of a CLI leg under torchrun, or one CLI process
    (``--cli-leg OUT ARGV...``): runs the CLI with the flash kernels'
    launches counted and writes them to OUT with the plain flash and
    plain attention calls (which must be none) and the calls of the
    collectives ``psum`` and ``pmean`` (each ``pmean`` makes one ``psum``;
    the rest are sync-BN's); exits with the CLI's code (75 when it was
    preempted)."""
    import torch

    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pytorch_distributed_training_tpu_torch.cli.main import main as cli
    from pytorch_distributed_training_tpu_torch.comm import collectives
    from pytorch_distributed_training_tpu_torch.ops import attention as attn
    from pytorch_distributed_training_tpu_torch.ops import (
        flash_attention as fa,
    )

    entries = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    plain = {"flash_fwd_plain": 0, "_bwd_tiles": 0, "flash_bwd_plain": 0}
    xla = {"_xla_attention": 0, "_xla_attention_remat": 0}
    _count_calls(fa, list(plain), plain)
    _count_calls(attn, list(xla), xla)
    comm = {"psum": 0, "pmean": 0}
    _count_calls(collectives, list(comm), comm)
    for e in entries:
        e.launches = 0
    out = out.replace("{rank}", os.environ.get("RANK", "0"))
    code, steps = 0, None
    try:
        steps = cli(argv).state.step
    except SystemExit as e:      # the preemption exit (75)
        code = e.code
    with open(out, "w") as f:
        json.dump({"fwd": entries[0].launches, "dq": entries[1].launches,
                   "dkv": entries[2].launches, "plain": plain, "xla": xla,
                   "comm": comm, "steps": steps}, f)
    return code


def _timed_steps(torch, record: dict, grab: list | None = None):
    """Wrap the port's ``make_train_step`` so each step's loss, its MoE
    drop rate where the model has one (``record["drops"]``) and its own
    time (the card synchronized before and after it) go into ``record``;
    with ``grab`` ``[fragment, k]``, the parameters whose names hold the
    fragment, copied to the host before the first step and after the
    k-th (``record["grab"]``, outside the timed spans).  Returns the
    original for restoring."""
    import pytorch_distributed_training_tpu_torch.train as train

    original = train.make_train_step

    def grabbed(state) -> dict:
        return {n: p.detach().to("cpu", torch.float32, copy=True)
                for n, p in state.params.items() if grab[0] in n}

    def make(**kw):
        step = original(**kw)

        def timed(state, batch):
            if grab and "grab" not in record:
                record["grab"] = [grabbed(state)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            record["step_s"].append(time.perf_counter() - t0)
            record["losses"].append(float(metrics["loss"]))
            if "moe_drop_rate" in metrics:
                record.setdefault("drops", []).append(
                    float(metrics["moe_drop_rate"]))
            if grab and len(record["step_s"]) == grab[1]:
                record["grab"].append(grabbed(state))
            return state, metrics

        return timed

    train.make_train_step = make
    return original


def dp_phase(torch, seed: int, repo: str, figures: dict) -> dict:
    """Data parallelism (the reference's DDP): each leg is a
    ``torch.distributed.run`` of the port, read back through
    ``--metrics-jsonl``.  D1 configs[1]'s model on one card (R2's command
    with ``--distributed``: a one-rank NCCL group, sync-BN and the
    gradient all-reduce on the path); D2 configs[3] (T1's recipe with
    ``--distributed``, 2 x 8 steps, flash #4/#5 launches counted in the
    rank); D3 two ranks on the one card over gloo (NCCL takes one rank a
    card), f32 with TF32 off, a shallow ResNet (R4's shape) and a 2-layer
    GPT-2 with accumulation 2, 3 steps each: the ranks bit-identical, and
    within 1e-4 of one process on the whole global batch (GPT-2's key
    bias, whose gradient is zero in exact arithmetic, to Adam's bound).
    D1, D2 and V2 (the ViT's one-rank leg, checked in ``vit_phase``) run
    in one one-rank torchrun (``--cli-runs-leg ... --cli-joins``), the
    NCCL group the first joins kept across them: one process start for
    the three.  Returns D2's launches by row."""
    import numpy as np

    from pytorch_distributed_training_tpu_torch.tools import dp_check

    out_dir = os.path.join(repo, "build", "chip_smoke", "dp")
    os.makedirs(out_dir, exist_ok=True)

    script = os.path.join(repo, "chip_smoke.py")
    joined = "Process group initialized - WORLD_SIZE: 1, RANK: 0"
    t0 = time.monotonic()
    paths = {leg: os.path.join(out_dir, f"{leg}.jsonl")
             for leg in ("d1", "d2", "v2")}
    for path in paths.values():
        if os.path.exists(path):
            os.remove(path)
    vit = vit_records(repo, seed)
    legs = [
        {"label": "d1", "argv": [*R2_ARGV, "--distributed", "--seed",
                                 str(seed), "--metrics-jsonl", paths["d1"]]},
        {"label": "d2", "argv": [*T1_RECIPE, *TRAIN_COMMON, "--epochs", "2",
                                 "--steps-per-epoch", "8", "--total-steps",
                                 "16", "--distributed", "--seed", str(seed),
                                 "--metrics-jsonl", paths["d2"]]},
        {"label": "v2", "argv": [*vit_argv(vit), "--distributed", "--seed",
                                 str(seed), "--metrics-jsonl", paths["v2"]]},
    ]
    spec = os.path.join(out_dir, "legs.json")
    with open(spec, "w") as f:
        json.dump(legs, f)
    out = torchrun(repo, 1, [script, "--cli-runs-leg", out_dir, spec,
                             "--cli-joins"], timeout=780)
    check(out.count(joined) == 3
          and out.count("process 0/1 | backend=cuda | devices=1") == 3,
          "D1, D2, V2: each CLI run joined the one-rank group on the card")
    counts = {}
    for leg in ("d1", "d2", "v2"):
        with open(os.path.join(out_dir, f"{leg}.rank0.json")) as f:
            counts[leg] = json.load(f)
    figures["V2"] = (counts["v2"], _records(paths["v2"]))
    print(f"dp D1 + D2 + V2: one torchrun, {time.monotonic() - t0:.1f} s "
          f"(legs {counts['d1']['seconds']:.1f} + "
          f"{counts['d2']['seconds']:.1f} + {counts['v2']['seconds']:.1f} "
          "s of CLI time)", flush=True)
    comm = counts["d1"]["comm"]
    recs = _records(paths["d1"])
    check(len(recs) == 2 and recs[-1]["step"] == 40
          and _finite([r["loss"] for r in recs]),
          f"D1: 2 epochs, 40 steps, finite losses ({recs})")
    # ResNet-50 has 53 BatchNorms: one all-reduce each way a step.
    check(comm["pmean"] == 40 and comm["psum"] - comm["pmean"] == 106 * 40,
          f"D1: one gradient pmean and 106 sync-BN all-reduces a step "
          f"over 40 steps ({comm})")
    img_s, step_ms = recs[-1]["examples_per_sec"], \
        recs[-1]["elapsed_s"] / 20 * 1e3
    r2_img_s, r2_ms = figures["R2"]
    print(f"dp D1 (ResNet-50, 224 px, bf16, batch 128, sgd, --distributed, "
          f"NCCL world 1): warm epoch {img_s:.1f} images/s/chip, step "
          f"{step_ms:.1f} ms; R2 in this call {r2_img_s:.1f} images/s, "
          f"{r2_ms:.1f} ms; epoch losses "
          f"{[round(r['loss'], 4) for r in recs]}; {comm['pmean']} "
          f"gradient pmeans, {comm['psum'] - comm['pmean']} sync-BN "
          f"all-reduces; {counts['d1']['seconds']:.1f} s", flush=True)

    n = counts["d2"]
    recs = _records(paths["d2"])
    want = 12 * 2 * 16
    check(n["steps"] == 16 and len(recs) == 2
          and _finite([r["loss"] for r in recs]),
          f"D2: 16 steps, finite losses ({recs})")
    check(n["comm"] == {"psum": 16, "pmean": 16},
          f"D2: one gradient pmean a step and no other all-reduce "
          f"({n['comm']})")
    check(n["fwd"] == n["dq"] == n["dkv"] == want,
          f"D2: flash launches {n}, expected {want} each")
    check(not any(n["plain"].values()) and not any(n["xla"].values()),
          f"D2: attention outside the kernels {n}")
    tok_s = recs[-1]["examples_per_sec"] * 1024
    step_ms = recs[-1]["elapsed_s"] / 8 * 1e3
    t1_tok_s, t1_ms = figures["T1"]
    print(f"dp D2 (GPT-2 124M, L 1024, batch 16 = 2 x 8, adamw, "
          f"--distributed, NCCL world 1, #4/#5): warm epoch {tok_s:.0f} "
          f"tokens/s, step {step_ms:.1f} ms; T1 in this call {t1_tok_s:.0f} "
          f"tokens/s, {t1_ms:.1f} ms; epoch losses "
          f"{[round(r['loss'], 4) for r in recs]}; launches fwd {n['fwd']} "
          f"dq {n['dq']} dkv {n['dkv']}; {n['seconds']:.1f} s", flush=True)

    # D3: both pairs of ranks start at once; the one-process references
    # are computed while they run.
    legs = {"resnet": (["--batch", "32", "--image-size", "32",
                        "--small-stem", "--filters", "64"],
                       dict(batch=32, size=32, small_stem=True, filters=64)),
            "gpt2": (["--batch", "8"], dict(batch=8, size=0))}
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    procs = {}
    try:
        for model, (extra, _) in legs.items():
            argv = ["-m", DP_CHECK, "--model", model, "--device", "cuda",
                    "--backend", "gloo", "--out",
                    os.path.join(out_dir, f"d3_{model}"), "--seed",
                    str(seed), *extra]
            procs[model] = (torchrun_start(repo, 2, argv), argv)
        refs = {}
        for model, (_, kw) in legs.items():
            ref_model = dp_check.build_model(
                model, torch.device("cuda"), seed=seed,
                small_stem=kw.get("small_stem", False),
                filters=kw.get("filters", 8))
            batches = dp_check.global_batches(model, dp_check.STEPS,
                                              kw["batch"], kw["size"],
                                              seed + 1)
            losses, _, state = dp_check.run_steps(
                model, ref_model, batches, accum=dp_check.ACCUM,
                device="cuda")
            refs[model] = losses, {
                k: v.detach().cpu().numpy() for k, v in
                {**state.params, **state.batch_stats}.items()}
        for model in legs:
            proc, argv = procs.pop(model)
            torchrun_wait(proc, argv, timeout=180)
            out = os.path.join(out_dir, f"d3_{model}")
            ranks = []
            for r in range(2):
                with open(os.path.join(out, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
                ranks[r]["params"] = dict(np.load(
                    os.path.join(out, f"rank{r}.npz")))
            check(ranks[0]["checksums"] == ranks[1]["checksums"]
                  and ranks[0]["losses"] == ranks[1]["losses"],
                  f"D3 {model}: the two ranks bit-identical after every step")
            losses, ref = refs[model]
            loss_err = max(abs(a - b)
                           for a, b in zip(losses, ranks[0]["losses"]))
            worst, key_bias = {}, 0.0
            for k, v in ref.items():
                d = np.abs(ranks[0]["params"][k] - v)
                if k.endswith("qkv.bias"):
                    third = d.shape[0] // 3
                    key_bias = max(key_bias, float(d[third:2 * third].max()))
                    d = np.concatenate([d[:third], d[2 * third:]])
                worst[k] = float(d.max())
            name = max(worst, key=worst.get)
            check(loss_err <= 1e-4 and worst[name] <= 1e-4
                  and key_bias <= 2 * dp_check.STEPS * 3e-4,
                  f"D3 {model}: 2 ranks vs 1 process: losses {loss_err:.3g}, "
                  f"weights {worst[name]:.3g} at {name}, key bias "
                  f"{key_bias:.3g}")
            print(f"dp D3 {model} (2 ranks on one card over gloo, f32, TF32 "
                  f"off, accumulation 2, 3 steps): ranks bit-identical; "
                  f"losses {[round(x, 6) for x in ranks[0]['losses']]}, max "
                  f"diff to one process {loss_err:.3g} (1e-4); max weight/"
                  f"statistic diff {worst[name]:.3g} at {name} (1e-4)"
                  + (f", key bias {key_bias:.3g} (Adam's bound 1.8e-3)"
                     if model == "gpt2" else "")
                  + f"; {time.monotonic() - t0:.1f} s since both pairs "
                  "started", flush=True)
    finally:
        for proc, _ in procs.values():   # a check failed: stop the rest
            torchrun_kill(proc)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return {4: n["fwd"], 5: n["dq"] + n["dkv"]}


# Packed records for the ViT legs: 232 px (the pack size a 224 crop is
# taken from), 1000 classes; 1024 records are one 8-step epoch at batch
# 128 (165 MB, written at each run under build/chip_smoke/vit/).
VIT_RECORDS, VIT_RECORD_SIZE = 1024, 232
VIT_STEPS = VIT_RECORDS // 128    # a V1 epoch; V1, V2 and R2p run two


def vit_argv(path: str) -> list:
    """V1: ViT-B/16 at full width through the CLI, DeiT's per-GPU batch
    and lr rule (5e-4 x global batch / 512, not rescaled here)."""
    return ["--model", "vit_b16", "--dataset", f"packed-images:{path}",
            "--image-size", "224", "--precision", "bf16", "--batch-size",
            "128", "--optimizer", "adamw", "--learning-rate", "5e-4",
            "--weight-decay", "0.05", "--grad-clip", "1.0", "--epochs", "2",
            "--steps-per-epoch", str(VIT_STEPS)]


def vit_forward_flops(cfg, image_size: int) -> float:
    """Forward flops of one image, 2 per multiply-add: per token and
    layer 24 D^2 (qkv, proj, the 4D MLP) + 4 L D (scores and their
    product with v), the patch convolution and the head; norms, GELU and
    softmax not counted."""
    d, p = cfg.hidden_dim, cfg.patch_size
    patches = (-(-image_size // p)) ** 2
    tokens = patches + 1
    layers = cfg.depth * tokens * (8 * d * d + 4 * d * cfg.mlp_dim
                                   + 4 * tokens * d)
    return float(layers + 2 * patches * 3 * p * p * d
                 + 2 * d * cfg.num_classes)


def vit_records(repo: str, seed: int) -> str:
    """The ViT legs' packed file (``VIT_RECORDS`` random records from the
    seed and a 1000-class sidecar), written once a run; returns its
    path."""
    from pytorch_distributed_training_tpu_torch.data import (
        synthesize_packed_images,
    )

    out_dir = os.path.join(repo, "build", "chip_smoke", "vit")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train.pck")
    if os.path.exists(path + ".classes"):
        return path
    t0 = time.monotonic()
    synthesize_packed_images(path, n=VIT_RECORDS, size=VIT_RECORD_SIZE,
                             num_classes=1000, seed=seed)
    # Without a sidecar the classes are 0..max label, which 1024 random
    # labels may leave short of 1000; pack_image_folder writes one too.
    with open(path + ".classes", "w") as f:
        f.write("\n".join(str(i) for i in range(1000)))
    print(f"vit records: {VIT_RECORDS} x {VIT_RECORD_SIZE} px, 1000 "
          f"classes, {os.path.getsize(path) / 1e6:.1f} MB written in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return path


def vit_phase(torch, fa, seed: int, repo: str, figures: dict) -> dict:
    """The ViT path (BASELINE configs[2]) on packed records: V1 through
    the CLI, V2 with ``--distributed`` (run in the data-parallel phase's
    torchrun, ``figures["V2"]``, checked here beside V1), V3 forced flash
    against the kernel-free layouts, V4 card against host, R2p ResNet-50
    on the same records.  Returns V3's launches by row."""
    from pytorch_distributed_training_tpu_torch.cli.main import main as cli
    from pytorch_distributed_training_tpu_torch.data import native

    path = vit_records(repo, seed)

    # V1: the CLI at full width; every step's loss recorded.
    step_losses: list = []
    original = _recording_steps(step_losses)
    native.crop_resize_flip_u8.calls = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer = cli(vit_argv(path) + ["--seed", str(seed)])
    finally:
        import pytorch_distributed_training_tpu_torch.train as train
        train.make_train_step = original
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    crops = native.crop_resize_flip_u8.calls
    losses = [float(x) for x in step_losses]
    steps = 2 * VIT_STEPS
    check(trainer.state.step == steps and len(losses) == steps,
          f"V1: {steps} steps")
    check(_finite(losses), f"V1: losses finite ({losses})")
    # At init the head's lecun-normal logits have variance ~1 over the
    # unit-variance final LayerNorm output, so the first loss sits near
    # ln 1000 + 1/2 (the log-sum-exp of 1000 unit normals), not ln 1000.
    check(abs(losses[0] - (math.log(1000) + 0.5)) < 0.5,
          f"V1: first loss {losses[0]:.4f} near ln 1000 + 1/2 = 7.41")
    check(all(p.is_cuda for p in trainer.state.params.values()),
          "V1: parameters on the card")
    check(crops == steps, f"V1: native uint8 crops {crops}, one a step")
    img_s, step_ms = _warm_epoch_line(trainer, VIT_STEPS)
    cfg = trainer.state.model.cfg
    fwd = vit_forward_flops(cfg, 224)
    mfu = 3 * fwd * img_s / 989e12
    figures["V1"] = (img_s, step_ms)
    n_params = sum(p.numel() for p in trainer.state.params.values())
    check(n_params == 86_567_656, f"V1: ViT-B/16 at 224 px with 1000 "
          f"classes has 86,567,656 parameters ({n_params})")
    print(f"vit V1 (ViT-B/16, 224 px, 1000 classes, bf16, batch 128, adamw "
          f"lr 5e-4 wd 0.05 clip 1.0, packed uint8 records): {steps} steps, "
          f"{n_params} params, losses first {losses[0]:.4f} last "
          f"{losses[-1]:.4f}; warm epoch {img_s:.1f} images/s, step "
          f"{step_ms:.1f} ms, peak memory {peak_gb:.2f} GB, MFU "
          f"{mfu * 100:.2f} % ({fwd / 1e9:.2f} GFLOP forward an image, x3 "
          f"trained, 989 TF/s dense bf16); native u8 crops {crops}",
          flush=True)
    del trainer
    torch.cuda.empty_cache()

    # V2: V1 with --distributed, one NCCL rank (run in dp_phase's torchrun).
    n, recs = figures.pop("V2")
    check(n["steps"] == steps and len(recs) == 2
          and _finite([r["loss"] for r in recs]),
          f"V2: {steps} steps, finite losses ({recs})")
    check(n["comm"] == {"psum": steps, "pmean": steps},
          f"V2: one gradient pmean a step and no other all-reduce "
          f"({n['comm']})")
    check(n["fwd"] == n["dq"] == n["dkv"] == 0
          and not any(n["plain"].values()) and not any(n["xla"].values()),
          f"V2: the bhld2 layout reaches no attention entry ({n})")
    v2_img_s = recs[-1]["examples_per_sec"]
    print(f"vit V2 (V1 with --distributed, NCCL world 1): warm epoch "
          f"{v2_img_s:.1f} images/s, step "
          f"{recs[-1]['elapsed_s'] / VIT_STEPS * 1e3:.1f} ms; V1 in this "
          f"call {img_s:.1f} images/s ({v2_img_s / img_s:.3f}x); "
          f"{n['comm']['pmean']} gradient pmeans, "
          f"{n['comm']['psum'] - n['comm']['pmean']} other all-reduces; "
          f"{n['seconds']:.1f} s of CLI time", flush=True)

    launches = vit_flash_turns(torch, fa, seed)
    vit_parity_phase(torch, seed)

    # R2p: R2's ResNet-50 command on the same records (uint8, native crop).
    argv = list(R2_ARGV)
    argv[argv.index("synthetic-images")] = f"packed-images:{path}"
    argv[argv.index("--steps-per-epoch") + 1] = str(VIT_STEPS)
    native.crop_resize_flip_u8.calls = 0
    trainer = cli(argv + ["--seed", str(seed)])
    calls = native.crop_resize_flip_u8.calls
    check(trainer.state.step == steps and calls == steps
          and _finite(trainer.last_epoch_losses),
          f"R2p: {steps} steps, finite losses, {steps} native crops "
          f"({calls})")
    r2p_img_s, r2p_ms = _warm_epoch_line(trainer, VIT_STEPS)
    r2_img_s, r2_ms = figures["R2"]
    print(f"image R2p (R2's ResNet-50 command on the packed uint8 records): "
          f"{steps} steps, warm epoch {r2p_img_s:.1f} images/s, step "
          f"{r2p_ms:.1f} ms; R2 (synthetic f32 images, 6 workers) in this "
          f"call {r2_img_s:.1f} images/s, {r2_ms:.1f} ms "
          f"({r2p_img_s / r2_img_s:.3f}x)", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return launches


VIT_TURN_STEPS = 5        # steps a V3 turn; each variant runs two turns


def vit_flash_turns(torch, fa, seed: int) -> dict:
    """V3: ViT-B/16 built through the API with the ``auto`` layout, bf16,
    batch 128, 224 px, adamw, on uint8 batches already on the card.
    Three variants in turns (flash, bhld2, xla, xla, bhld2, flash; 5 steps
    each, after 2 warm-up steps each): ``auto`` under
    ``PDT_FORCE_ATTN=flash`` (the flash kernels at L 197), the default
    ``bhld2`` layout (no attention entry), ``auto`` under
    ``PDT_FORCE_ATTN=xla`` (the plain attention).  The flash turns must
    launch the forward, dq and dk/dv kernels once a layer a step each and
    run no attention outside them.  Returns the launches by row."""
    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer,
    )
    from pytorch_distributed_training_tpu_torch.data.transforms import (
        IMAGENET_MEAN, IMAGENET_STD,
    )
    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.ops import attention as attn
    from pytorch_distributed_training_tpu_torch.tools.train_profile import (
        VIT_ATTN, set_attn,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, make_train_step,
    )

    policy = make_policy("bf16")
    model = create_model("vit_b16", image_size=224, seed=seed,
                         cfg_overrides={"attn_layout": "auto"})
    state = create_train_state(
        model, build_optimizer("adamw", 5e-4, weight_decay=0.05,
                               grad_clip=1.0), policy=policy)
    step = make_train_step(kind="image_classifier", policy=policy,
                           input_normalize=(IMAGENET_MEAN, IMAGENET_STD))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = [{"image": torch.randint(0, 256, (128, 224, 224, 3),
                                       generator=gen, device="cuda",
                                       dtype=torch.uint8),
                "label": torch.randint(0, 1000, (128,), generator=gen,
                                       device="cuda")} for _ in range(2)]
    entries = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    plain = {"flash_fwd_plain": 0, "_bwd_tiles": 0, "flash_bwd_plain": 0}
    xla = {"_xla_attention": 0, "_xla_attention_remat": 0}
    saved = (_count_calls(fa, list(plain), plain),
             _count_calls(attn, list(xla), xla))
    env = os.environ.get("PDT_FORCE_ATTN")
    times: dict = {k: [] for k in VIT_ATTN}
    losses = []

    def run(name, n):
        nonlocal state
        set_attn(model, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            state, metrics = step(state, batches[i % 2])
        losses.append(float(metrics["loss"]))   # waits for the device
        return (time.perf_counter() - t0) / n * 1e3

    try:
        for name in ("flash", "bhld2", "xla"):
            run(name, 2)
        for e in entries:
            e.launches = 0
        for c in (plain, xla):
            for k in c:
                c[k] = 0
        # As timeit does: no garbage collection inside the timed turns
        # (a full pass over the objects of the earlier phases otherwise
        # lands in one of them).
        gc.collect()
        gc.disable()
        for name in ("flash", "bhld2", "xla", "xla", "bhld2", "flash"):
            before = [e.launches for e in entries] + [sum(xla.values())]
            times[name].append(run(name, VIT_TURN_STEPS))
            after = [e.launches for e in entries] + [sum(xla.values())]
            moved = [a - b for a, b in zip(after, before)]
            want = {"flash": [12 * VIT_TURN_STEPS] * 3 + [0],
                    "bhld2": [0, 0, 0, 0],
                    "xla": [0, 0, 0, 12 * VIT_TURN_STEPS]}[name]
            check(moved == want, f"V3 {name} turn: flash fwd/dq/dkv and "
                  f"plain attention calls {moved}, expected {want}")
        n_fwd, n_dq, n_dkv = (e.launches for e in entries)
    finally:
        gc.enable()
        for module, originals in zip((fa, attn), saved):
            for name, fn in originals.items():
                setattr(module, name, fn)
        if env is None:
            os.environ.pop("PDT_FORCE_ATTN", None)
        else:
            os.environ["PDT_FORCE_ATTN"] = env
    flash_steps = 2 * VIT_TURN_STEPS
    want = 12 * flash_steps
    check(n_fwd == n_dq == n_dkv == want,
          f"V3: flash launches fwd {n_fwd} dq {n_dq} dkv {n_dkv}, expected "
          f"{want} each (12 layers x {flash_steps} steps x 1 microbatch)")
    check(not any(plain.values()), f"V3: plain flash versions ran {plain}")
    check(_finite(losses), f"V3: losses finite ({losses})")
    ms = {k: statistics.median(v) for k, v in times.items()}
    print(f"vit V3 (ViT-B/16 through the API, bf16, batch 128, 224 px, "
          f"batches on the card, turns flash/bhld2/xla/xla/bhld2/flash of "
          f"{VIT_TURN_STEPS} steps): step ms flash (auto, PDT_FORCE_ATTN="
          f"flash, #{VIT_FLASH_ROWS[0]}/#{VIT_FLASH_ROWS[1]}) "
          f"{ms['flash']:.2f} {times['flash']}, bhld2 (default) "
          f"{ms['bhld2']:.2f} {times['bhld2']}, xla (auto, PDT_FORCE_ATTN="
          f"xla) {ms['xla']:.2f} {times['xla']}; flash / bhld2 "
          f"{ms['flash'] / ms['bhld2']:.3f}; launches fwd {n_fwd} dq {n_dq} "
          f"dkv {n_dkv}, plain attention {sum(xla.values())} calls in the "
          f"xla turns only", flush=True)
    del state, model, batches
    torch.cuda.empty_cache()
    return {VIT_FLASH_ROWS[0]: n_fwd, VIT_FLASH_ROWS[1]: n_dq + n_dkv}


def vit_parity_phase(torch, seed: int) -> None:
    """V4, TF32 off: a shallow f32 ViT (2 layers, width 64, 4 heads, MLP
    128, 32 px, 10 classes) trains 3 sgd steps of batch 8 in 2
    microbatches on the card and on the host from the same weights:
    losses and weights within 1e-4."""
    from pytorch_distributed_training_tpu_torch.models import create_model

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        host_model = create_model(
            "vit_b16", num_classes=10, image_size=32, device="cpu",
            seed=seed, cfg_overrides={"depth": 2, "hidden_dim": 64,
                                      "num_heads": 4, "mlp_dim": 128})
        cl, loss_err, name, err = card_host_steps(torch, host_model, 8, 32,
                                                  seed, "V4")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    print(f"vit V4 (shallow f32 ViT, 32 px, 3 sgd steps in 2 microbatches, "
          f"card vs host, TF32 off): losses {[round(x, 6) for x in cl]}, "
          f"max loss diff {loss_err:.3g} (1e-4), max weight diff "
          f"{err:.3g} at {name} (1e-4)", flush=True)


# The checkpoint phase: C0 what a save costs, C1 GPT-2 124M preempted and
# resumed (T1's recipe), C2 ResNet-50 under the supervisor (R2's recipe),
# C3 two nodes of one rank (configs[4]'s shape) and a restore at world 1.
C2_ARGV = [*R2_ARGV[:R2_ARGV.index("--epochs")], "--epochs", "2",
           "--steps-per-epoch", "6", *R2_ARGV[R2_ARGV.index("--num-workers"):]]


def _run_cli(repo: str, argv: list):
    """``python -m <the port's CLI> ARGV`` started in its own session;
    returns the process (stdout and stderr piped)."""
    return subprocess.Popen([sys.executable, "-m", CLI, *argv], cwd=repo,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def _finish(proc, what: str, timeout: float, code: int = 0) -> str:
    """Wait for ``proc``; fails the run (and kills its session) unless it
    exits ``code``.  Returns its stdout."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            torchrun_kill(proc)
    check(proc.returncode == code,
          f"{what}: exit {proc.returncode}, expected {code}\n{out[-3000:]}\n"
          f"{err[-3000:]}")
    return out


def _leaves(directory: str, step: int) -> dict:
    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )

    return CheckpointManager(directory).manifest(step)["leaves"]


def _distance(torch, dir_a: str, dir_b: str, step: int) -> tuple:
    """(max |a - b| over the float tensors of two steps, its tensor)."""
    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )

    a, b = (CheckpointManager(d).load_tensors(step) for d in (dir_a, dir_b))
    worst = {k: float((a[k].double() - b[k].double()).abs().max())
             for k in a if a[k].is_floating_point() and a[k].numel()}
    name = max(worst, key=worst.get)
    return worst[name], name


def _same_run(torch, label: str, run: str, ref: str, step: int,
              rerun) -> str:
    """The determinism rule: ``run``'s step ``step`` must equal the
    uninterrupted ``ref``'s on every tensor's crc32; where it does not,
    the tensors that differ are named and it is held to the distance
    between ``ref`` and a second uninterrupted run of the same command
    (``rerun()``, which makes it and returns its directory)."""
    got, want = _leaves(run, step), _leaves(ref, step)
    check(got.keys() == want.keys(), f"{label}: manifests' tensors differ")
    differ = sorted(k for k in want if got[k]["crc32"] != want[k]["crc32"])
    if not differ:
        return f"step {step} bitwise equal to the uninterrupted run " \
            f"({len(want)} tensors' crc32)"
    d1, at1 = _distance(torch, run, ref, step)
    d0, at0 = _distance(torch, rerun(), ref, step)
    check(d1 <= d0, f"{label}: resumed run {d1:.3g} from the uninterrupted "
          f"one (at {at1}), two uninterrupted runs {d0:.3g} apart (at {at0})")
    return (f"step {step} not bitwise: {len(differ)} of {len(want)} tensors "
            f"differ (first {differ[:3]}); max diff {d1:.3g} at {at1}, "
            f"within two uninterrupted runs' {d0:.3g} (at {at0})")


def save_costs(torch, label: str, state, template, scratch: str,
               step_ms: float) -> str:
    """C0 for one state: its bytes, ``save``'s host stall (3 async saves,
    median), the card's wait (CUDA events on the compute stream around
    ``save`` on an idle card: the staging copy, which the compute stream
    waits for before any later kernel), the commit (call to committed,
    median) and a restore of the newest into ``template``."""
    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from pytorch_distributed_training_tpu_torch.checkpoint.manager import (
        flatten_state,
    )

    tensors, _ = flatten_state(state)
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    mgr = CheckpointManager(scratch)
    stalls, waits, commits = [], [], []
    for i in range(3):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        mgr.save(state, step=1000 + i)
        stalls.append(time.perf_counter() - t0)
        e1.record()
        mgr.wait_until_finished()
        commits.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        waits.append(e0.elapsed_time(e1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = CheckpointManager(scratch).restore_latest(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(restored.step == 1002, f"C0 {label}: restored step 1002")
    stall, wait = statistics.median(stalls), statistics.median(waits)
    return (f"{nbytes / 1e9:.3f} GB; save stall {stall * 1e3:.2f} ms "
            f"(median of {[round(x * 1e3, 2) for x in stalls]} ms; "
            f"{stall * 1e3 / step_ms * 100:.2f} % of the {step_ms:.1f} ms "
            f"step), the card's wait for the staging copy {wait:.2f} ms "
            f"(median of {[round(x, 2) for x in waits]} ms; "
            f"{nbytes / wait / 1e6:.1f} GB/s; {wait / step_ms * 100:.2f} % "
            f"of the step), commit {statistics.median(commits):.2f} s "
            f"(median of {[round(x, 2) for x in commits]}), restore "
            f"{restore_s:.2f} s")


def save_in_flight(torch, state, step_fn, batch, scratch: str,
                   steps: int = 24):
    """What an async save costs T1's training: windows of ``steps`` T1
    steps (GPT-2 124M, B 16, L 1024, 2 microbatches) with a save at the
    start of the window or without, in the order plain, save, save,
    plain.  Per window: the first step's device time (CUDA events; the
    save's staging copy lands in it), the window's host time up to its
    last step's end, and the commit's time left at that point.  Returns
    (state, line)."""
    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )

    mgr = CheckpointManager(scratch)
    for _ in range(2):
        state, _ = step_fn(state, batch)
    first, window, left = {False: [], True: []}, {False: [], True: []}, []
    for i, saving in enumerate((False, True, True, False)):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        if saving:
            mgr.save(state, step=2000 + i)
        state, _ = step_fn(state, batch)
        e1.record()
        for _ in range(steps - 1):
            state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mgr.wait_until_finished()
        window[saving].append(t1 - t0)
        first[saving].append(e0.elapsed_time(e1))
        if saving:
            left.append(time.perf_counter() - t1)
    f0, f1 = (statistics.mean(first[k]) for k in (False, True))
    w0, w1 = (statistics.mean(window[k]) for k in (False, True))
    return state, (
        f"{steps}-step windows, plain/save/save/plain: first step "
        f"{f0:.2f} ms without a save, {f1:.2f} ms with one in flight "
        f"(+{f1 - f0:.2f} ms; {[round(x, 2) for x in first[False]]} / "
        f"{[round(x, 2) for x in first[True]]}); window "
        f"{w0 * 1e3:.1f} ms without, {w1 * 1e3:.1f} ms with "
        f"(+{(w1 - w0) * 1e3:.1f} ms a save, "
        f"{(w1 - w0) / w0 * 100:.2f} %; "
        f"{[round(x * 1e3, 1) for x in window[False]]} / "
        f"{[round(x * 1e3, 1) for x in window[True]]}); the commit still "
        f"ran {[round(x * 1e3, 1) for x in left]} ms past the window")


def checkpoint_phase(torch, seed: int, repo: str, figures: dict) -> dict:
    """C0: what a save of T1's state (GPT-2 124M: f32 master, adamw, 1.49
    GB) and of R2's (ResNet-50, sgd) costs, the torn-save check on the
    card (an async save, a step at once, the committed bytes equal to
    the state at the save), and T1's steps with a save in flight.  C1: T1's command preempted by
    ``sigterm@4`` under step checkpoints every 2 (exit 75, steps 2, 4, 5
    committed), then resumed (``resumed from step 5 (epoch 0, skipping 5
    consumed batches)``, step 8 committed); the flash launches of the two
    processes equal T1's, and the step-8 checkpoint equals T1's.  C2:
    R2's command for 2 x 6 steps under ``--elastic`` with ``crash@7``:
    one restart, step 12 equal to the uninterrupted run's.  C3: two
    ``torch.distributed.run`` nodes of one rank (static rendezvous, gloo
    on the one card) train D3's shallow f32 ResNet 4 steps, saving step
    2; one process restores it bit for bit and takes steps 3-4 within
    1e-4 of the two nodes.  Returns C1's launches by flash row."""
    import shutil
    import socket

    import numpy as np

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
    from pytorch_distributed_training_tpu_torch.tools import dp_check
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, make_train_step,
    )

    card = card_line()
    dev = torch.device("cuda")
    t1_dir = os.path.join(CKPT, "t1")
    policy = make_policy("bf16")

    def gpt2_state(s):
        model = create_model("gpt2", dtype=policy.param_dtype, device=dev,
                             seed=s)
        # T1's recipe with a longer horizon: at T1's step 8 its rate has
        # decayed to 0, and the torn-save check needs a step that moves
        # the weights.
        lr = build_schedule("warmup-cosine", 6e-4, total_steps=16,
                            warmup_steps=2)
        return create_train_state(model, build_optimizer(
            "adamw", lr, weight_decay=0.1, grad_clip=1.0), policy=policy)

    def resnet_state(s):
        model = create_model("resnet50", num_classes=1000,
                             dtype=policy.param_dtype, device=dev, seed=s)
        return create_train_state(model, build_optimizer(
            "sgd", 0.1, weight_decay=1e-3), policy=policy)

    # --- C0 -----------------------------------------------------------------
    t0 = time.monotonic()
    state = gpt2_state(seed + 7)
    torch.cuda.synchronize()
    t_r = time.perf_counter()
    state = CheckpointManager(t1_dir).restore_latest(state)
    torch.cuda.synchronize()
    t1_restore = time.perf_counter() - t_r
    check(state is not None and state.step == 8, "C0: T1's step 8 restores")
    line = save_costs(torch, "GPT-2", state, gpt2_state(seed + 8),
                      os.path.join(CKPT, "c0_gpt2"), figures["T1"][1])
    print(f"ckpt C0 GPT-2 124M (T1's state: f32 master, adamw; {card}): "
          f"{line}; T1's step-8 restore {t1_restore:.2f} s", flush=True)
    # The torn-save check: an async save, then at once a step that
    # updates the parameters and moments in place.
    step_fn = make_train_step(kind="lm", policy=policy)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, VOCAB, (2, 1024), device=dev,
                                     generator=gen)}
    at_save = {k: v.detach().clone()
               for k, v in flatten_state(state)[0].items()}
    mgr = CheckpointManager(os.path.join(CKPT, "c0_torn"))
    mgr.save(state, step=8)
    state, _ = step_fn(state, batch)
    mgr.wait_until_finished()
    saved = mgr.load_tensors(8)
    torn = [k for k, v in at_save.items() if not torch.equal(saved[k],
                                                             v.cpu())]
    moved = not torch.equal(state.params["wte"], at_save["params/wte"])
    check(not torn and moved, f"C0 torn-save check: {len(torn)} tensors "
          f"differ from the state at the save (first {torn[:3]}); the step "
          f"moved the weights: {moved}")
    del at_save, saved, mgr
    tokens = torch.randint(0, VOCAB, (16, 1024), device=dev, generator=gen)
    state, line = save_in_flight(
        torch, state, make_train_step(kind="lm", policy=policy,
                                      num_microbatches=2),
        {"tokens": tokens}, os.path.join(CKPT, "c0_flight"))
    print(f"ckpt C0 GPT-2 124M, T1's step with an async save in flight "
          f"({card}): {line}", flush=True)
    del state, tokens
    gc.collect()
    torch.cuda.empty_cache()
    line = save_costs(torch, "ResNet-50", resnet_state(seed),
                      resnet_state(seed + 1),
                      os.path.join(CKPT, "c0_resnet50"), figures["R2"][1])
    print(f"ckpt C0 ResNet-50 (R2's state: f32 master, sgd momentum, "
          f"batch_stats; {card}): {line}; torn-save check: the committed "
          f"bytes equal the state at the save after an in-place step; "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    for name in ("c0_gpt2", "c0_torn", "c0_flight", "c0_resnet50"):
        shutil.rmtree(os.path.join(CKPT, name))
    gc.collect()
    torch.cuda.empty_cache()

    # --- C2 and C3 start; C1 runs meanwhile -----------------------------------
    t0 = time.monotonic()
    script = os.path.join(repo, "chip_smoke.py")
    c2 = {name: os.path.join(CKPT, name) for name in
          ("c2_ref", "c2_ref2", "c2")}

    def uninterrupted(argv: list, directory: str, what: str):
        """A second uninterrupted run, made only when the determinism
        rule needs it."""
        def run():
            _finish(_run_cli(repo, [*argv, "--checkpoint-dir", directory]),
                    what, 300)
            return directory
        return run

    procs = {}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    c3 = os.path.join(CKPT, "c3")
    c3_argv = ["-m", DP_CHECK, "--model", "resnet", "--device", "cuda",
               "--backend", "gloo", "--out", os.path.join(c3, "out"),
               "--steps", "4", "--save-at", "2", "--batch", "32",
               "--image-size", "32", "--small-stem", "--filters", "64",
               "--seed", str(seed)]
    c2_argv = [*C2_ARGV, "--seed", str(seed)]
    try:
        procs["c2_ref"] = _run_cli(repo, [*c2_argv, "--checkpoint-dir",
                                          c2["c2_ref"]])
        procs["c2"] = _run_cli(repo, [
            *c2_argv, "--elastic", "--max-restarts",
            "1", "--checkpoint-dir", c2["c2"], "--ckpt-every-steps", "3",
            "--inject-faults", "crash@7"])
        for node in range(2):
            procs[f"c3_{node}"] = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--nnodes",
                 "2", "--nproc_per_node", "1", "--node_rank", str(node),
                 "--master_addr", "localhost", "--master_port", str(port),
                 *c3_argv, "--checkpoint-dir",
                 os.path.join(c3, f"node{node}")],
                cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, start_new_session=True)

        # --- C1 ---------------------------------------------------------------
        t1_argv = [*T1_RECIPE, "--steps-per-epoch", "8", *TRAIN_COMMON,
                   "--seed", str(seed)]
        c1 = os.path.join(CKPT, "c1")
        argv = [*t1_argv, "--checkpoint-dir", c1, "--ckpt-every-steps", "2",
                "--inject-faults", "sigterm@4"]
        # Telemetry on both processes; the resumed one profiles steps 5-6.
        c1_tm = [os.path.join(CKPT, f"c1_tm{i}") for i in range(2)]
        c1_prof = os.path.join(CKPT, "c1_prof")
        counts = []
        for i, extra in enumerate(([], ["--resume", "--profile-dir", c1_prof,
                                        "--profile-steps", "5:7"])):
            out_json = os.path.join(CKPT, f"c1_{i}.json")
            proc = subprocess.Popen(
                [sys.executable, script, "--cli-leg", out_json, *argv,
                 *extra, "--metrics-dir", c1_tm[i], "--trace", "--goodput"],
                cwd=repo, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, start_new_session=True)
            out = _finish(proc, f"C1 process {i + 1}", 300,
                          code=75 if i == 0 else 0)
            with open(out_json) as f:
                counts.append(json.load(f))
            steps = CheckpointManager(c1).all_steps()
            if i == 0:
                check("preempted at step 5; checkpoint committed; exiting 75"
                      in out and steps == [2, 4, 5],
                      f"C1: exit 75 at step 5, steps 2, 4, 5 committed "
                      f"({steps})")
            else:
                check("resumed from step 5 (epoch 0, skipping 5 consumed "
                      "batches)" in out and steps[-1] == 8,
                      f"C1: resumed from step 5, step 8 committed ({steps})"
                      f"\n{out[-2000:]}")
        want = 12 * 2 * 8
        n = {k: counts[0][k] + counts[1][k] for k in ("fwd", "dq", "dkv")}
        check(n == {"fwd": want, "dq": want, "dkv": want},
              f"C1: flash launches of the two processes {n}, expected "
              f"{want} each (T1's)")
        check(not any(v for c in counts for v in [*c["plain"].values(),
                                                  *c["xla"].values()]),
              f"C1: attention outside the kernels {counts}")
        verdict = _same_run(torch, "C1", c1, t1_dir, 8, uninterrupted(
            t1_argv, os.path.join(CKPT, "t1_2"), "C1: T1 again"))
        c1_telemetry(c1_tm, c1_prof, figures["T1"][1])
        print(f"ckpt C1 (GPT-2 124M, T1's recipe, #4/#5; sigterm@4, step "
              f"checkpoints every 2): exit 75 with steps 2, 4, 5; resumed "
              f"from step 5 (epoch 0, skipping 5 consumed batches) to step "
              f"8; flash launches {counts[0]['fwd']} + {counts[1]['fwd']} "
              f"fwd, {counts[0]['dq']} + {counts[1]['dq']} dq, "
              f"{counts[0]['dkv']} + {counts[1]['dkv']} dkv = T1's {want} "
              f"each; {verdict}; {time.monotonic() - t0:.1f} s", flush=True)

        # --- C2 ---------------------------------------------------------------
        _finish(procs.pop("c2_ref"), "C2 uninterrupted", 300)
        out = _finish(procs.pop("c2"), "C2 under --elastic", 300)
        check("supervisor: finished after 1 restarts (0 hang kills, 0 "
              "preemptions), exit 0" in out,
              f"C2: one restart under the supervisor\n{out[-3000:]}")
        resumed = re.search(r"resumed from step (\d+) \(epoch (\d+), "
                            r"skipping (\d+) consumed batches\)", out)
        check(resumed is not None and resumed.group(1) in ("3", "6"),
              f"C2: the relaunch resumed from step 6 or 3\n{out[-3000:]}")
        verdict = _same_run(torch, "C2", c2["c2"], c2["c2_ref"], 12,
                            uninterrupted(c2_argv, c2["c2_ref2"],
                                          "C2 uninterrupted again"))
        leaves = _leaves(c2["c2"], 12)
        check(any(k.startswith("batch_stats/") for k in leaves)
              and any(k.startswith("opt_state/") for k in leaves),
              "C2: the step-12 manifest covers batch_stats and momentum")
        print(f"ckpt C2 (ResNet-50, R2's recipe, 2 x 6 steps, --elastic "
              f"--max-restarts 1, step checkpoints every 3, crash@7): exit "
              f"13 before step 7, {resumed.group(0)}, supervisor: finished "
              f"after 1 restarts; {verdict}; {time.monotonic() - t0:.1f} s "
              "since C1 started", flush=True)

        # --- C3 ---------------------------------------------------------------
        outs = [_finish(procs.pop(f"c3_{node}"), f"C3 node {node}", 180)
                for node in range(2)]
        for node, out in enumerate(outs):
            check(f"RANK {node} LOCAL_RANK 0 GROUP_RANK {node}" in out,
                  f"C3 node {node}: torchrun's identity\n{out[-2000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(c3, "out", f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        check(ranks[0]["checksums"] == ranks[1]["checksums"],
              "C3: the two nodes' ranks bit-identical after every step")
        node1 = os.path.join(c3, "node1")
        check(not os.path.exists(node1) or not os.listdir(node1),
              "C3: node 1's checkpoint directory stays empty")
        saved = dict(np.load(os.path.join(c3, "out", "rank0.npz")))
        saved_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            model = dp_check.build_model("resnet", dev, seed=seed + 1,
                                         small_stem=True, filters=64)
            batches = dp_check.global_batches("resnet", 4, 32, 32, seed + 1)
            losses, sums, state = dp_check.run_steps(
                "resnet", model, batches, accum=dp_check.ACCUM,
                device="cuda", resume=True,
                checkpoint=CheckpointManager(os.path.join(c3, "node0")))
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved_tf32
        check(sums[0] == ranks[0]["checksums"][1],
              "C3: the one-process restore is bitwise the two nodes' step 2")
        loss_err = max(abs(a - b) for a, b in zip(losses,
                                                  ranks[0]["losses"][2:]))
        worst = {k: float(np.abs(v.detach().cpu().numpy() - saved[k]).max())
                 for k, v in {**state.params, **state.batch_stats}.items()}
        name = max(worst, key=worst.get)
        check(loss_err <= 1e-4 and worst[name] <= 1e-4,
              f"C3: steps 3-4 at world 1 vs the two nodes: losses "
              f"{loss_err:.3g}, weights {worst[name]:.3g} at {name}")
        print(f"ckpt C3 (configs[4]'s shape: 2 torchrun nodes of 1 rank, "
              f"static rendezvous, gloo on the one card; D3's shallow f32 "
              f"ResNet, TF32 off, 4 steps, step 2 saved by rank 0 alone): "
              f"ranks bit-identical; node 1's directory empty; world-1 "
              f"restore bitwise (the manifest verified), steps 3-4 losses "
              f"within {loss_err:.3g}, weights within {worst[name]:.3g} at "
              f"{name} (1e-4); NCCL across two hosts is not measurable on "
              f"one card; {time.monotonic() - t0:.1f} s since C1 started",
              flush=True)
    finally:
        for proc in procs.values():   # a check failed: stop the rest
            torchrun_kill(proc)
        shutil.rmtree(CKPT, ignore_errors=True)
    return {4: n["fwd"], 5: n["dq"] + n["dkv"]}

# C1's telemetry: T1's step counted on meta tensors against the analytic
# count of PERF.md section 2 (6 N a token + 12 layers L d, GPT-2 124M's N
# with tied embeddings), and the flash forward launches a profiled step
# makes (12 layers x 2 microbatches).
T1_PARAMS = 124_439_808
T1_ANALYTIC_FLOPS = (6 * T1_PARAMS + 12 * 12 * 1024 * 768) * 16 * 1024
C1_FLOPS_BOUND = 0.10
C1_PROFILED = (5, 7)


def c1_telemetry(tm_dirs: list, prof_dir: str, t1_ms: float) -> None:
    """C1's two processes ran under ``--metrics-dir --trace --goodput``:
    both logs pass the port's ``validate_events``; each process's goodput
    ledger sums to its wall exactly with no ``rework`` (a preemption
    commits synchronously), the preempted one charging ``ckpt_save`` and
    the resumed one ``ckpt_restore``; each ``compiled_cost`` holds T1's
    step FLOPs within ``C1_FLOPS_BOUND`` of the analytic count, the
    allocator's peaks and the card's data-sheet peak; the resumed
    process's ``torch.profiler`` trace of steps 5-6 holds their step
    markers and 48 ``flash_fwd_kernel`` device events.  Prints the
    preempted process's warm step time beside T1's in this call: the
    ledger's ``step_compute`` over its step intervals (steps 1-4,
    telemetry on, the saves in their own category), and where its first
    seconds went: start-up to the first epoch (the flop probe included)
    and the first step."""
    from pytorch_distributed_training_tpu_torch import obs

    ledgers, costs, marks_t = [], [], []
    for i, directory in enumerate(tm_dirs):
        events = obs.read_events(os.path.join(directory,
                                              "events.rank00000.jsonl"))
        obs.validate_events(events)
        check(events[-1]["kind"] == "summary",
              f"C1 process {i + 1}: the log is closed with its summary")
        (led,) = [e for e in events if e.get("record") == "goodput_ledger"]
        cats = led["categories_ns"]
        check(led["identity_ok"] and sum(cats.values()) == led["wall_ns"]
              and cats["rework"] == 0,
              f"C1 process {i + 1}: ledger categories sum to the wall "
              f"exactly, no rework ({cats}, wall {led['wall_ns']})")
        ledgers.append(led)
        (cost,) = [e for e in events if e["kind"] == "compiled_cost"]
        check("error" not in cost and abs(cost["flops"] / T1_ANALYTIC_FLOPS
                                          - 1) <= C1_FLOPS_BOUND
              and cost["memory"]["peak_allocated_bytes"] > 0
              and cost["peak_flops"] == 989e12,
              f"C1 process {i + 1}: compiled_cost {cost} against the "
              f"analytic {T1_ANALYTIC_FLOPS:.4g} FLOPs a step")
        costs.append(cost)
        first = {}
        for e in events:
            key = e.get("phase") or e["kind"]
            if key in ("meta", "epoch_start", "step"):
                first.setdefault(key, e["t"])
        marks_t.append(first)
    check(ledgers[0]["categories_ns"]["ckpt_save"] > 0
          and ledgers[1]["categories_ns"]["ckpt_restore"] > 0,
          "C1: the preempted process charged ckpt_save, the resumed one "
          "ckpt_restore")
    with open(os.path.join(prof_dir, "trace.rank0.json")) as f:
        trace = json.load(f)["traceEvents"]
    marks = {e["name"] for e in trace if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("train#")}
    flash = [e for e in trace if e.get("cat") == "kernel"
             and "flash_fwd_kernel" in e.get("name", "")]
    want = {f"train#{s}" for s in range(*C1_PROFILED)}
    check(marks == want and len(flash) == 12 * 2 * 2,
          f"C1: the profiled window holds {sorted(marks)} (want "
          f"{sorted(want)}) and {len(flash)} flash_fwd_kernel device "
          "events (want 48)")
    led = ledgers[0]
    warm = (led["categories_ns"]["step_compute"]
            + led["categories_ns"]["grad_sync"]) \
        / led["step_intervals"]["step_compute"] / 1e6
    start = marks_t[0]
    print(f"ckpt C1 telemetry: logs valid; goodput "
          f"{ledgers[0]['goodput_fraction']:.4f} / "
          f"{ledgers[1]['goodput_fraction']:.4f} of "
          f"{ledgers[0]['wall_s']:.2f} / {ledgers[1]['wall_s']:.2f} s "
          f"(ckpt_save {ledgers[0]['seconds']['ckpt_save']:.3f} s, "
          f"ckpt_restore {ledgers[1]['seconds']['ckpt_restore']:.3f} s, "
          f"compile {ledgers[0]['seconds']['compile']:.3f} / "
          f"{ledgers[1]['seconds']['compile']:.3f} s, rework 0); "
          f"compiled_cost {costs[0]['flops']:.6g} FLOPs a step "
          f"({costs[0]['flops'] / T1_ANALYTIC_FLOPS:.4f} of the analytic "
          f"{T1_ANALYTIC_FLOPS:.6g}), peak allocated "
          f"{costs[0]['memory']['peak_allocated_bytes'] / 1e9:.2f} GB; "
          f"profiled steps 5-6: {len(flash)} flash_fwd_kernel events; "
          f"warm step (the ledger's step_compute over steps 1-4, "
          f"telemetry on) {warm:.1f} ms, T1 in this call {t1_ms:.1f} ms "
          f"(its 8 steps' mean); process 1: start-up to the first epoch "
          f"(the flop probe included) "
          f"{start['epoch_start'] - start['meta']:.2f} s, first step "
          f"{start['step'] - start['epoch_start']:.2f} s", flush=True)


# The device-cache and skip-gate legs write under here (removed at the end).
DC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                  "chip_smoke", "dc")
R1_BASE = ["--model", "resnet18", "--dataset", "cifar10", "--synthetic-data"]
R1_ARGV = R1_BASE + ["--epochs", "2", "--steps-per-epoch", "50"]
T1_TWO_EPOCHS = T1_RECIPE + ["--epochs", "2", "--steps-per-epoch", "8"]


def _hooked_steps(after):
    """Wrap the port's ``make_train_step`` so ``after(i, state, metrics)``
    runs after the process's i-th step; returns the original for
    restoring."""
    import pytorch_distributed_training_tpu_torch.train as train

    original = train.make_train_step

    def make(**kw):
        step, count = original(**kw), iter(range(1 << 62))

        def hooked(state, batch):
            state, metrics = step(state, batch)
            after(next(count), state, metrics)
            return state, metrics

        return hooked

    train.make_train_step = make
    return original


class _Window:
    """A ``torch.profiler`` window over steps ``first`` .. ``first +
    count - 1`` of a CLI run, each with the batch fetch before it: started
    on an idle card after step ``first - 1``, stopped after a synchronize.
    ``figures()``: wall and busy time, host-to-device copies and bytes, a
    step."""

    def __init__(self, torch, first: int, count: int, trace: str):
        self.torch, self.first, self.count, self.trace = (torch, first,
                                                          count, trace)
        self.prof = self.t0 = self.wall = None

    def __call__(self, i, state, metrics):
        torch = self.torch
        if i == self.first - 1:
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif i == self.first + self.count - 1:
            torch.cuda.synchronize()
            self.wall = time.perf_counter() - self.t0
            self.prof.stop()

    def figures(self) -> dict:
        from pytorch_distributed_training_tpu_torch.tools.train_profile import (
            busy_seconds,
        )

        check(self.wall is not None, "profiler window ran")
        self.prof.export_chrome_trace(self.trace)
        with open(self.trace) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.trace)
        h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
               and "HtoD" in e.get("name", "")]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        check(bool(kernels), "the profiler saw the card's kernels")
        n = self.count
        return {"step_ms": self.wall / n * 1e3,
                "busy": busy_seconds(self.prof.events()) / self.wall,
                "h2d": len(h2d) / n,
                "h2d_bytes": sum(e.get("args", {}).get("bytes", 0)
                                 for e in h2d) / n}


def _caches_built(created: list):
    """Record each device cache the CLI builds; returns the originals."""
    import pytorch_distributed_training_tpu_torch.data as data

    originals = {}
    for name in ("DeviceCachedImages", "DeviceCachedTokens"):
        cls = originals[name] = getattr(data, name)

        def build(*a, _cls=cls, **kw):
            created.append(_cls(*a, **kw))
            return created[-1]

        setattr(data, name, build)
    return originals


def _leg(torch, cli, argv, window=None, after=None):
    """One in-process CLI run with optional step hooks; returns (trainer,
    caches built)."""
    import pytorch_distributed_training_tpu_torch.data as data
    import pytorch_distributed_training_tpu_torch.train as train

    hooks = [h for h in (window, after) if h is not None]
    created: list = []
    originals = _caches_built(created)
    original = _hooked_steps(lambda *a: [h(*a) for h in hooks])
    try:
        trainer = cli(argv)
    finally:
        train.make_train_step = original
        for name, cls in originals.items():
            setattr(data, name, cls)
    return trainer, created


def _line(label: str, trainer, steps: int, win: dict, per: float,
          unit: str, caches: list) -> str:
    rate, step_ms = _warm_epoch_line(trainer, steps)
    cache = (f"; cache {sum(c.nbytes for c in caches) / 1e6:.1f} MB on the "
             "card" if caches else "")
    return (f"{label}: warm epoch {rate * per:.1f} {unit}, step "
            f"{step_ms:.2f} ms; profiled window {win['step_ms']:.2f} ms a "
            f"step, busy {win['busy'] * 100:.1f} %, H2D {win['h2d']:g} "
            f"copies / {win['h2d_bytes']:.0f} bytes a step{cache}")


def _pair(torch, cli, label, argv, steps, first, count, per, unit,
          order=("loader", "cache")):
    """The loader runs and the ``--device-cache`` runs of ``argv`` in
    ``order``, each with a profiler window; the cache's must copy nothing
    from the host."""
    for mode in order:
        win = _Window(torch, first, count, os.path.join(DC, "trace.json"))
        extra = ["--device-cache"] if mode == "cache" else []
        trainer, caches = _leg(torch, cli, argv + extra, window=win)
        figs = win.figures()
        losses = [h["loss"] for h in trainer.history]
        check(_finite(losses), f"{label} {mode}: losses finite ({losses})")
        if mode == "cache":
            check(len(caches) == 1, f"{label}: the run built its cache")
            check(figs["h2d"] == 0,
                  f"{label}: {figs['h2d']} host-to-device copies a warm "
                  "step with the cache, expected 0")
        print(_line(f"{label} {mode}", trainer, steps, figs, per, unit,
                    caches), flush=True)
        del trainer
        torch.cuda.empty_cache()


def _flash_entries(fa) -> tuple:
    return fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv


def _reset_flash(fa) -> None:
    for e in _flash_entries(fa):
        e.launches = 0


def gate_turns(torch, seed: int, steps: int = 5) -> None:
    """T1's step (GPT-2 124M, bf16 policy, B 16 = 2 x 8, L 1024, adamw
    under warmup-cosine, clip 1.0) with and without the gate, on one
    batch on the card, in turns off / on / on / off twice (``steps`` a
    turn, garbage collection off): the gate's cost a step; then one
    profiled step of each: kernels launched and device time.  Before the
    turns, one warm gated step under the sync debug mode "error": the
    gate must not wait for the device."""
    import dataclasses

    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer, build_schedule,
    )
    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.resilience import (
        AnomalyPolicy, init_resilience_state,
    )
    from pytorch_distributed_training_tpu_torch.tools.train_profile import (
        busy_seconds,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, make_train_step,
    )

    dev = torch.device("cuda")
    policy = make_policy("bf16")
    runs = {}
    for gate in ("off", "on"):
        model = create_model("gpt2", dtype=policy.param_dtype, device=dev,
                             seed=seed)
        state = create_train_state(model, build_optimizer(
            "adamw", build_schedule("warmup-cosine", 6e-4, total_steps=8,
                                    warmup_steps=2),
            weight_decay=0.1, grad_clip=1.0), policy=policy)
        if gate == "on":
            state = dataclasses.replace(
                state, resilience=init_resilience_state(dev))
        runs[gate] = [state, make_train_step(
            kind="lm", policy=policy, num_microbatches=2, seed=seed + 1,
            anomaly_policy=AnomalyPolicy() if gate == "on" else None)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, VOCAB, (16, 1024), generator=gen,
                                     device=dev)}

    def turn(gate, n):
        state, step = runs[gate]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        runs[gate][0] = state
        return (time.perf_counter() - t0) / n * 1e3

    for gate in runs:
        turn(gate, 2)
    # A warm gated step waits for nothing: under the sync debug mode
    # "error" any host sync raises (the counts and the optimizer's tables
    # went up once, in the first gated step).
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs["on"][0], _ = runs["on"][1](runs["on"][0], batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("G1: a warm gated step of T1 under torch.cuda.set_sync_debug_mode"
          "('error'): no host sync", flush=True)
    times = {"off": [], "on": []}
    gc.disable()
    try:
        for gate in ("off", "on", "on", "off") * 2:
            times[gate].append(turn(gate, steps))
    finally:
        gc.enable()
    prof = {}
    for gate in runs:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as p:
            turn(gate, 1)
        events = [e for e in p.events() if e.device_type.name == "CUDA"]
        prof[gate] = (len(events), busy_seconds(events) * 1e3)
    off, on = (statistics.median(times[g]) for g in ("off", "on"))
    print(f"G1 turns (T1's step on one batch on the card, {steps} steps a "
          f"turn, off / on / on / off x 2): off "
          f"{' / '.join(f'{x:.2f}' for x in times['off'])} ms, on "
          f"{' / '.join(f'{x:.2f}' for x in times['on'])} ms; medians "
          f"{off:.2f} / {on:.2f} ms: the gate costs {on - off:+.2f} ms "
          f"({(on / off - 1) * 100:+.2f} %) a step; one step's kernels "
          f"{prof['off'][0]} / {prof['on'][0]} "
          f"({prof['on'][0] - prof['off'][0]:+d}), device time "
          f"{prof['off'][1]:.2f} / {prof['on'][1]:.2f} ms "
          f"({prof['on'][1] - prof['off'][1]:+.2f})", flush=True)
    del runs
    torch.cuda.empty_cache()


def cache_guard_phase(torch, fa, seed: int, repo: str) -> dict:
    """The device-resident datasets and the skip gate through the CLI.
    DC1 R1 without and with ``--device-cache`` (loader, cache), DC2 R2p's ResNet-50 and V1's ViT-B/16 on V1's packed
    records, DC3 T1 on a token file written from the seed (flash #4/#5):
    each warm epoch's rate and step, and a profiled window's busy share
    and host-to-device copies a step, which must be 0 with the cache.
    G1 T1 with ``--skip-bad-steps`` against T1 without, off / on:
    bitwise the same trajectory (flash #4/#5); then ``gate_turns``,
    the gate's cost a step.  G2 R1's loader command (float batches) with the gate,
    ``nan_batch@3`` and ``spike_batch@6:1e4``: the NaN step skipped, the
    parameters bitwise unchanged across it, the norms around the spike.
    G3 R1's loader command with a spike threshold below G2's clean norms
    under ``--elastic --max-restarts 1``: a rollback, an abort, the
    supervisor's relaunch failing the same way (a subprocess, beside
    DC4).  DC4 DC1's cached command preempted by ``sigterm@4`` under
    step checkpoints every 2 and resumed (epoch-end checkpoints), cuDNN
    held to its deterministic algorithms: bitwise on the uninterrupted
    cached run at step 100.  Returns DC3's and G1's flash launches by row."""
    import shutil

    import numpy as np

    from pytorch_distributed_training_tpu_torch.checkpoint.manager import (
        checksum_manifest,
    )
    from pytorch_distributed_training_tpu_torch.cli.main import main as cli
    from pytorch_distributed_training_tpu_torch.data.lm_corpus import (
        synthesize_token_bin,
    )

    shutil.rmtree(DC, ignore_errors=True)
    os.makedirs(DC)
    seed_argv = ["--seed", str(seed)]
    launches = {4: 0, 5: 0}

    # DC1: the reference's run, loader then cache (one pair: the ABBA
    # quartet's spread is on record, and its second pair pays for the
    # serving fleet's legs); warm steps 20-24 of the first epoch are
    # profiled, the second epoch is timed unprofiled.
    _pair(torch, cli, "DC1 R1", R1_ARGV + seed_argv, 50, 20, 5, 1,
          "images/s")
    # DC2: the packed records of the ViT legs (232 px, cropped to 224).
    packed = os.path.join(repo, "build", "chip_smoke", "vit", "train.pck")
    r2p = list(R2_ARGV)
    r2p[r2p.index("synthetic-images")] = f"packed-images:{packed}"
    r2p[r2p.index("--steps-per-epoch") + 1] = str(VIT_STEPS)
    _pair(torch, cli, "DC2 R2p", r2p + seed_argv, VIT_STEPS, 3, 3, 1,
          "images/s")
    _pair(torch, cli, "DC2 V1", vit_argv(packed) + seed_argv, VIT_STEPS, 3,
          3, 1, "images/s")
    # DC3: T1 on a token file of 4M ids from the seed (a GPT-2 vocabulary).
    tokens = os.path.join(DC, "train.bin")
    synthesize_token_bin(tokens, n_tokens=4_000_000, vocab_size=50257,
                         seed=seed)
    t1_file = [a if a != "synthetic-tokens" else f"token-file:{tokens}"
               for a in T1_TWO_EPOCHS + TRAIN_COMMON] + seed_argv
    _reset_flash(fa)
    _pair(torch, cli, "DC3 T1", t1_file, 8, 3, 3, 1024, "tokens/s")
    fwd, dq, dkv = (e.launches for e in _flash_entries(fa))
    check(fwd == dq == dkv == 2 * 12 * 2 * 16,
          f"DC3: flash launches fwd {fwd} dq {dq} dkv {dkv}, expected "
          f"{2 * 12 * 2 * 16} each (two runs of 16 steps)")
    launches[4] += fwd
    launches[5] += dq + dkv

    # G1: T1 without the gate, then with it; every step's loss bits and
    # the end weights' crc32 must agree.  (Two turns, not four since the
    # serving tier joined the script: gate_turns times the gate's cost.)
    runs = []
    _reset_flash(fa)
    for gate in (False, True):
        losses: list = []
        trainer, _ = _leg(torch, cli, T1_TWO_EPOCHS + TRAIN_COMMON + seed_argv
                          + (["--skip-bad-steps"] if gate else []),
                          after=lambda i, s, m: losses.append(m["loss"]))
        bits = [float(x) for x in losses]
        crc = {n: v["crc32"] for n, v in checksum_manifest(
            {n: p.detach().cpu() for n, p in
             trainer.state.params.items()}).items()}
        runs.append((gate, bits, crc, _warm_epoch_line(trainer, 8)[1]))
        if gate:
            check(int(trainer.state.resilience.skipped_total) == 0,
                  "G1: nothing skipped")
        del trainer
        torch.cuda.empty_cache()
    fwd, dq, dkv = (e.launches for e in _flash_entries(fa))
    check(fwd == dq == dkv == 2 * 12 * 2 * 16,
          f"G1: flash launches fwd {fwd} dq {dq} dkv {dkv}, expected "
          f"{2 * 12 * 2 * 16} each (two runs of 16 steps)")
    launches[4] += fwd
    launches[5] += dq + dkv
    ref = runs[0]
    for gate, bits, crc, _ in runs[1:]:
        check(bits == ref[1], f"G1: losses {bits} against {ref[1]}")
        check(crc == ref[2], "G1: end weights bitwise equal")
    off = [r[3] for r in runs if not r[0]]
    on = [r[3] for r in runs if r[0]]
    print(f"G1 T1 --skip-bad-steps (off / on, 2 x 8 steps): "
          f"16 losses and {len(ref[2])} weights bitwise equal; warm step "
          f"off {' / '.join(f'{x:.2f}' for x in off)} ms, on "
          f"{' / '.join(f'{x:.2f}' for x in on)} ms", flush=True)
    gate_turns(torch, seed)

    # G2: R1's loader command, 10 steps, with the gate and two faults.
    metrics: list = []
    seen: dict = {}

    def g2(i, state, m):
        metrics.append({k: v.detach().clone() for k, v in m.items()})
        if state.step == 3:        # the params after step 2 (global 0-2)
            seen["before"] = {n: p.detach().clone()
                              for n, p in state.params.items()}
        elif state.step == 4:
            seen["same"] = all(torch.equal(p, seen["before"][n])
                               for n, p in state.params.items())

    g2_argv = R1_BASE + ["--epochs", "1", "--steps-per-epoch", "10",
                              "--skip-bad-steps", "--inject-faults",
                              "nan_batch@3,spike_batch@6:1e4"] + seed_argv
    trainer, _ = _leg(torch, cli, g2_argv, after=g2)
    skipped = [int(m["skipped"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    total = int(trainer.state.resilience.skipped_total)
    check(skipped[3] == 1 and total >= 1 and seen.get("same"),
          f"G2: the NaN step skipped (skipped {skipped}, total {total}, "
          f"params unchanged {seen.get('same')})")
    check(all(s == (not math.isfinite(g)) for s, g in zip(skipped, norms)),
          f"G2: skipped exactly the non-finite steps ({skipped}, {norms})")
    print(f"G2 R1 --skip-bad-steps nan_batch@3 spike_batch@6:1e4 (10 "
          f"steps): skipped {skipped}, skipped_total {total}, parameters "
          f"bitwise unchanged across step 3; grad norms steps 4-8 "
          f"{[round(g, 4) for g in norms[4:9]]} (step 6 scaled by 1e4: "
          f"{'skipped' if skipped[6] else 'finite and applied'}), clean "
          f"norms {min(n for n, s in zip(norms, skipped) if not s):.4f}-"
          f"{max(n for n, s in zip(norms, skipped) if not s):.4f}",
          flush=True)
    clean = min(n for n, s in zip(norms, skipped) if not s)
    del trainer

    # G3: in the background, beside DC4 (both check outcomes, not times).
    g3_dir = os.path.join(DC, "g3")
    g3 = _run_cli(repo, R1_BASE + [
        "--epochs", "1", "--steps-per-epoch", "101", "--skip-bad-steps",
        "--grad-spike-threshold", f"{clean / 10:g}", "--rollback-after", "2",
        "--max-rollbacks", "1", "--elastic", "--max-restarts", "1",
        "--checkpoint-dir", g3_dir] + seed_argv)

    # DC4: the cached R1 run preempted before step 4 and resumed, against
    # the uninterrupted cached run, both with epoch-end checkpoints.
    # cuDNN may pick convolution algorithms that accumulate in a varying
    # order, which R1 (f32, adam lr 0.1) amplifies from one run to the
    # next: DC4's runs take the deterministic ones, so that what is
    # compared is the resume.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def dc1_run(directory):
        trainer, _ = _leg(torch, cli, R1_ARGV + seed_argv + [
            "--device-cache", "--checkpoint-dir", directory])
        check(trainer.state.step == 100, "DC4 reference: 100 steps")

    ref_dir, run_dir = os.path.join(DC, "ref"), os.path.join(DC, "dc4")
    dc1_run(ref_dir)
    dc4 = R1_ARGV + seed_argv + ["--device-cache", "--checkpoint-dir",
                                 run_dir]
    try:
        cli(dc4 + ["--ckpt-every-steps", "2", "--inject-faults",
                   "sigterm@4"])
        code = 0
    except SystemExit as e:
        code = e.code
    check(code == 75, f"DC4: preempted run exit {code}, expected 75")
    # The resumed run commits the epochs' ends only, as the reference
    # does (a save every 2 steps of R1 bounds the run by its writes).
    trainer = cli(dc4 + ["--resume"])
    check(trainer.state.step == 100, "DC4: resumed to step 100")
    reruns = iter(range(1 << 30))

    def rerun():
        directory = os.path.join(DC, f"rerun{next(reruns)}")
        dc1_run(directory)
        return directory

    verdict = _same_run(torch, "DC4", run_dir, ref_dir, 100, rerun)
    torch.backends.cudnn.deterministic = deterministic
    print(f"DC4 R1 --device-cache sigterm@4 (exit 75 at step 5, resumed; "
          f"cuDNN's deterministic algorithms): {verdict}", flush=True)
    del trainer

    try:
        out, err = g3.communicate(timeout=600)
    finally:
        if g3.poll() is None:
            torchrun_kill(g3)
    staged = re.findall(r"staged in ([0-9.]+) ms", err)
    check(g3.returncode == 1
          and err.count("recovery: rollback 1 at step 50") == 2
          and err.count("recovery: abort at step 100") == 2
          and "supervisor: finished after 1 restarts" in out,
          f"G3: exit {g3.returncode}\n{out[-2000:]}\n{err[-3000:]}")
    print(f"G3 R1 --grad-spike-threshold {clean / 10:g} --rollback-after 2 "
          f"--max-rollbacks 1 --elastic --max-restarts 1 (101 steps): each "
          f"process rolled back once at step 50 and aborted at step 100 "
          f"(RecoveryAborted); the supervisor relaunched once, exit "
          f"{g3.returncode}; snapshot staging {' / '.join(staged)} ms",
          flush=True)
    shutil.rmtree(DC, ignore_errors=True)
    return launches


# --- the two-tier gradient sync (--grad-sync) --------------------------------

GS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                  "chip_smoke", "grad_sync")
# JAX's documented parameter tolerances (tests/test_hier_sync.py:39-44);
# H1 holds each mode's weights to 10x them against flat.
PARAM_ATOL = {"hier": 1e-6, "hier-bf16": 5e-3, "hier-int8": 2e-2,
              "hier-int4": 5e-2, "hier-topk": 2e-2}
# H1: (label, mode, extra GradSyncConfig fields).  Buckets of 0.05 MB make
# the 2-layer model's ~0.5 MB of gradient several buckets, so the
# pipelined walk has waves to overlap.
H1_RUNS = (("flat", "flat", {}), ("hier", "hier", {}),
           ("hier-bf16", "hier-bf16", {}), ("hier-int8", "hier-int8", {}),
           ("hier-int4", "hier-int4", {}), ("hier-topk", "hier-topk", {}),
           ("hier-int8-sp", "hier-int8", {"stripe": 2,
                                          "phase_overlap": True}))
H1_BUCKET_MB, H1_BATCH, H1_LR = 0.05, 8, 3e-4
# H2: the step-3 loss of hier-int8 against flat (PERF.md, written before
# the first run).
H2_INT8_LOSS_BOUND = 2e-2
H2_ARGS = ["--model", "gpt2_124m", "--batch", "16", "--accum", "2",
           "--steps", "3", "--device", "cuda", "--backend", "gloo"]
H2_RUNS = (("flat", []), ("hier-int8", [
    "--grad-sync", "hier-int8", "--grad-sync-slices", "2",
    "--grad-sync-stripe", "auto", "--grad-sync-overlap", "on"]))


def grad_sync_leg(out: str, seed: int) -> int:
    """One rank of the grad-sync phase's torchrun (``--grad-sync-leg OUT
    SEED``), gloo on the one card: H1's runs (``h1_runs``), then H2's
    (``h2_runs``), then the elastic episodes EL0 and EL1 (``el_legs``),
    in one group."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pytorch_distributed_training_tpu_torch.comm import init as comm_init

    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    group = comm_init.initialize(device, backend="gloo")
    try:
        h1_runs(torch, os.path.join(out, "h1"), seed, device, group)
        h2_runs(out, seed)
        el_legs(torch, out, seed, device, group)
    finally:
        comm_init.shutdown()
    return 0


def h2_runs(out: str, seed: int) -> None:
    """H2 on this rank: ``tools/dp_check.py`` for each of ``H2_RUNS`` in
    turn, in the group this process joined (``group_kept``), each
    writing ``OUT/h2_<label>/rank<r>.json``; the flash counts start at 0
    for each."""
    from pytorch_distributed_training_tpu_torch.comm import collectives
    from pytorch_distributed_training_tpu_torch.ops import (
        flash_attention as fa,
    )
    from pytorch_distributed_training_tpu_torch.tools import dp_check

    argv = sys.argv
    try:
        with group_kept():
            for label, extra in H2_RUNS:
                for e in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
                    e.launches = 0
                sys.argv = ["dp_check", *H2_ARGS, "--seed", str(seed),
                            "--out", os.path.join(out, f"h2_{label}"),
                            *extra]
                dp_check.main()
                collectives.barrier()
    finally:
        sys.argv = argv


def h1_runs(torch, out: str, seed: int, device, group) -> None:
    """H1 on this rank: every run of ``H1_RUNS`` over ``group``,
    ``tools/dp_check.py``'s 2-layer GPT-2 in f32 with TF32 off (restored
    after), accumulation 2, 3 steps; writes ``OUT/<label>.rank<r>.json``
    (losses, checksums, the residual's largest magnitude) and rank 0's
    weights ``OUT/<label>.npz``."""
    import numpy as np

    from pytorch_distributed_training_tpu_torch.comm import (
        GradSyncConfig, collectives, init as comm_init,
    )
    from pytorch_distributed_training_tpu_torch.tools import dp_check

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        rank, world = comm_init.process_index(), comm_init.process_count()
        batches = dp_check.global_batches("gpt2", dp_check.STEPS, H1_BATCH,
                                          0, seed + 1)
        for label, mode, extra in H1_RUNS:
            cfg = None if mode == "flat" else GradSyncConfig(
                mode=mode, n_slices=2, bucket_mb=H1_BUCKET_MB, **extra)
            model = dp_check.build_model("gpt2", device, seed=seed)
            figures: dict = {}
            losses, sums, state = dp_check.run_steps(
                "gpt2", model, batches, accum=dp_check.ACCUM, device=device,
                group=group, rank=rank, world=world, grad_sync=cfg,
                figures=figures)
            with open(os.path.join(out, f"{label}.rank{rank}.json"),
                      "w") as f:
                json.dump({"losses": losses, "checksums": sums,
                           "residual_max": figures.get("residual_max", []),
                           "n_buckets": figures.get("n_buckets"),
                           "stripe": figures.get("stripe")}, f)
            if rank == 0:
                np.savez(os.path.join(out, f"{label}.npz"), **{
                    k: v.detach().cpu().numpy()
                    for k, v in state.params.items()})
        collectives.barrier(group)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def torchrun_logged(repo: str, nproc: int, argv: list, log_dir: str):
    """``torchrun_start`` with each rank's stdout and stderr also written
    under ``log_dir`` (torchrun's ``--log-dir``), for ``rank_tails``."""
    import shutil

    shutil.rmtree(log_dir, ignore_errors=True)
    return torchrun_start(repo, nproc, ["--log-dir", log_dir, "--tee", "3",
                                        *argv])


def rank_tails(log_dir: str, n: int = 1500) -> str:
    """The last ``n`` characters of each rank's stderr under ``log_dir``."""
    import glob

    tails = []
    for path in sorted(glob.glob(os.path.join(log_dir, "**", "stderr.log"),
                                 recursive=True)):
        with open(path, errors="replace") as f:
            tails.append(f"--- {os.path.relpath(path, log_dir)}\n"
                         f"{f.read()[-n:]}")
    return "\n".join(tails) or "(no rank wrote a stderr log)"


def wait_ranks(proc, argv: list, timeout: float, log_dir: str, what: str):
    """``torchrun_wait`` that, when the leg fails, prints the tail of each
    rank's stderr before the failure ends the run."""
    try:
        return torchrun_wait(proc, argv, timeout)
    except BaseException:
        print(f"{what} failed; each rank's stderr:\n{rank_tails(log_dir)}",
              flush=True)
        raise


def _codec_ms(torch, fn, n_buckets: int) -> float:
    """Device time of ``fn`` over every bucket, per bucket (CUDA events)."""
    return time_ms(torch, fn, reps=10) / n_buckets


def grad_sync_codecs(torch, seed: int) -> None:
    """H0: the grad-sync codecs on the card against the host, bitwise, on
    seeded (n_buckets, shard) f32 at GPT-2 124M's auto layout under
    hier-int8 (H2's: 4 ranks, 2 slices); top-k also on a row of ties.
    Prints each encode's and decode's device time per bucket."""
    from pytorch_distributed_training_tpu_torch.comm import compress as cc
    from pytorch_distributed_training_tpu_torch.models import create_model

    t0 = time.monotonic()
    model = create_model("gpt2", device="meta")
    params = dict(model.named_parameters())
    total = 4 * sum(p.numel() for p in params.values())
    mb = cc.auto_bucket_mb(total, mode="hier-int8", phase_overlap=True)
    layout = cc._BucketLayout.build(params, bucket_mb=mb, divisor=4)
    nb, shard = layout.n_buckets, layout.bucket_elems // 2
    gen = torch.Generator().manual_seed(seed)
    host = torch.randn((nb, shard), generator=gen) * 1e-3
    host[0, :4096] = torch.round(host[0, :4096] * 1e4) / 1e4   # ties
    host[-1, -4096:] = 0.0                                    # padding
    card = host.cuda()

    def same(a, b):
        return all(torch.equal(x.cpu(), y) for x, y in zip(a, b))

    lines = []
    for name, enc, dec in (
            ("int8", cc.encode_int8, cc.decode_int8),
            ("int4", cc.encode_int4, cc.decode_int4),
            ("topk", lambda x: cc.encode_topk(x, 0.1),
             lambda b, q, s: cc.decode_topk(b, q, s, shard))):
        on_card, on_host = enc(card), enc(host)
        check(same(on_card, on_host), f"H0: {name} payload card == host")
        check(torch.equal(dec(*on_card).cpu(), dec(*on_host)),
              f"H0: {name} decode card == host")
        enc_ms = _codec_ms(torch, lambda: enc(card), nb)
        dec_ms = _codec_ms(torch, lambda: dec(*on_card), nb)
        lines.append(f"{name} encode {enc_ms:.3f} / decode {dec_ms:.3f} ms")
    ties = torch.tensor([[1.0, -1.0, 0.5, -0.5] * 16]).repeat(2, 1)
    check(same(cc.encode_topk(ties.cuda(), 0.25), cc.encode_topk(ties, 0.25)),
          "H0: top-k on a row of ties card == host (lower index first)")
    bits = card.to(torch.bfloat16).view(torch.int16)
    check(torch.equal(bits.cpu(), host.to(torch.bfloat16).view(torch.int16)),
          "H0: the bf16 payload's int16 view card == host")
    print(f"grad sync H0 (codecs, card vs host bitwise, {nb} buckets x "
          f"{shard} f32 = GPT-2 124M's hier-int8 auto layout at {mb} MB, "
          f"4 ranks in 2 slices): per bucket {'; '.join(lines)}; "
          f"{time.monotonic() - t0:.1f} s", flush=True)


def _h1_check(out: str) -> None:
    import numpy as np

    runs = {}
    for label, mode, _ in H1_RUNS:
        ranks = []
        for r in range(4):
            with open(os.path.join(out, f"{label}.rank{r}.json")) as f:
                ranks.append(json.load(f))
        check(all(x["checksums"] == ranks[0]["checksums"]
                  and x["losses"] == ranks[0]["losses"] for x in ranks),
              f"H1 {label}: the 4 ranks bit-identical after every step")
        runs[label] = (ranks, dict(np.load(os.path.join(out,
                                                        f"{label}.npz"))))
    flat_losses, flat = runs["flat"][0][0]["losses"], runs["flat"][1]
    parts = []
    for label, mode, _ in H1_RUNS[1:]:
        ranks, params = runs[label]
        # The step-1 loss is the forward on the same weights, which no
        # sync mode touches (JAX's check); later losses follow weights
        # that the lossy codecs move apart, so only hier (f32 over the
        # hop) holds all three to 1e-5.
        diffs = [abs(a - b) for a, b in zip(ranks[0]["losses"],
                                            flat_losses)]
        loss_err = max(diffs) if mode == "hier" else diffs[0]
        worst, key_bias = 0.0, 0.0
        for k, v in flat.items():
            d = np.abs(params[k] - v)
            if k.endswith("qkv.bias"):
                third = d.shape[0] // 3
                key_bias = max(key_bias, float(d[third:2 * third].max()))
                d = np.concatenate([d[:third], d[2 * third:]])
            worst = max(worst, float(d.max()))
        tol = 10 * PARAM_ATOL[mode]
        check(loss_err <= 1e-5 and worst <= tol
              and key_bias <= 2 * 3 * H1_LR,
              f"H1 {label} vs flat: losses {diffs} (1e-5), weights "
              f"{worst:.3g} ({tol:g}), key bias {key_bias:.3g}")
        if mode in ("hier-int8", "hier-int4", "hier-topk"):
            check(all(m > 0 for m in ranks[0]["residual_max"]),
                  f"H1 {label}: the EF residual is non-zero "
                  f"({ranks[0]['residual_max']})")
        parts.append(f"{label} {diffs[0]:.2g}, {max(diffs):.2g}/"
                     f"{worst:.2g}")
    sp, serial = runs["hier-int8-sp"], runs["hier-int8"]
    check(sp[0][0]["stripe"] == 2 and sp[0][0]["n_buckets"] > 1
          and sp[0][0]["checksums"] == serial[0][0]["checksums"],
          "H1: hier-int8 striped 2 and pipelined bitwise hier-int8 serial")
    print(f"grad sync H1 (4 ranks on one card over gloo, 2 slices x 2, "
          f"2-layer GPT-2 f32, TF32 off, accumulation 2, 3 steps, "
          f"{sp[0][0]['n_buckets']} buckets): ranks bit-identical; diff to "
          f"flat of the step-1 loss, of any step's loss / of the weights "
          f"after 3 steps: {'; '.join(parts)}; striped + pipelined int8 "
          f"bitwise serial", flush=True)


def _h2_ranks(directory: str) -> list:
    ranks = []
    for r in range(4):
        with open(os.path.join(directory, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def grad_sync_phase(torch, seed: int, repo: str) -> dict:
    """The two-tier gradient sync: H0 the codecs card vs host; H1 four
    ranks on the card over gloo (NCCL takes one rank a card) in 2 slices
    of 2, the five modes against flat on a 2-layer GPT-2, striping and
    the phase pipeline bitwise the serial schedule; H2 GPT-2 124M (T1's
    recipe, L 1024, 16 = 2 x 8 rows a step, 2 rows a rank a microbatch)
    under flat and under hier-int8 with stripe auto and the phase
    pipeline, 3 steps each: first loss near ln 50257, the step-3 losses
    within ``H2_INT8_LOSS_BOUND``, ranks bit-identical, flash #4/#5
    counted.  Its times are gloo's on one card: no NCCL figure and no
    network's.  Returns the flash launches by row."""
    import shutil

    shutil.rmtree(GS, ignore_errors=True)
    os.makedirs(GS)
    script = os.path.join(repo, "chip_smoke.py")
    t0 = time.monotonic()
    h1_out, logs = os.path.join(GS, "h1"), os.path.join(GS, "logs")
    os.makedirs(h1_out)
    argv = [script, "--grad-sync-leg", GS, str(seed)]
    proc = torchrun_logged(repo, 4, argv, logs)
    try:
        grad_sync_codecs(torch, seed)
        wait_ranks(proc, argv, 900, logs, "H1 + H2 + EL0 + EL1")
    finally:
        torchrun_kill(proc)
    print(f"grad sync H1 + H2 + EL0 + EL1 torchrun: "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    _h1_check(h1_out)

    runs = {}
    for label, _ in H2_RUNS:
        ranks = _h2_ranks(os.path.join(GS, f"h2_{label}"))
        check(all(x["checksums"] == ranks[0]["checksums"]
                  and x["losses"] == ranks[0]["losses"] for x in ranks),
              f"H2 {label}: the 4 ranks bit-identical after every step")
        losses = ranks[0]["losses"]
        check(_finite(losses) and 10.0 <= losses[0] <= 12.0,
              f"H2 {label}: first loss {losses[0]} near ln 50257 = 10.8")
        runs[label] = ranks
        steps = [statistics.median(x["step_s"][1:]) * 1e3 for x in ranks]
        line = (f"grad sync H2 {label} (GPT-2 124M, bf16, L 1024, 16 = 2 x "
                f"8 rows, 4 ranks in 2 slices x 2 on one card over gloo, 3 "
                f"steps): losses {[round(x, 4) for x in losses]}; step "
                f"(median of steps 2-3, by rank) "
                f"{[round(x, 1) for x in steps]} ms; peak memory by rank "
                f"{[round(x['peak_mem_gb'], 2) for x in ranks]} GB")
        if label != "flat":
            sync_ms = [sum(x["sync_s"][x["syncs_per_step"]:]) * 1e3
                       / (len(x["step_s"]) - 1) for x in ranks]
            check(all(m > 0 for m in ranks[0]["residual_max"]),
                  f"H2 {label}: the EF residual is non-zero")
            first = ranks[0]
            line += (f"; sync a step, issue + wait (steps 2-3, card "
                     f"synchronized around each) "
                     f"{[round(x, 1) for x in sync_ms]} ms; "
                     f"{first['n_buckets']} buckets of {first['bucket_mb']} "
                     f"MB ({first['bucket_policy']}), stripe "
                     f"{first['stripe']}, {first['syncs_per_step']} syncs a "
                     f"step; analytic bytes a sync: DCN "
                     f"{first['dcn_bytes_per_sync']}, ICI "
                     f"{first['ici_bytes_per_sync']}")
        print(line, flush=True)
    diff = abs(runs["hier-int8"][0]["losses"][-1]
               - runs["flat"][0]["losses"][-1])
    check(diff <= H2_INT8_LOSS_BOUND,
          f"H2: step-3 loss hier-int8 vs flat {diff:.3g} within "
          f"{H2_INT8_LOSS_BOUND}")
    print(f"grad sync H2: step-3 loss hier-int8 vs flat {diff:.4g} (bound "
          f"{H2_INT8_LOSS_BOUND}); timings are gloo's on one card, not "
          "NCCL's and not a network's", flush=True)
    fwd = sum(x["flash"]["fwd"] for r in runs.values() for x in r)
    bwd = sum(x["flash"]["dq"] + x["flash"]["dkv"]
              for r in runs.values() for x in r)
    want = 12 * 2 * 3 * 4 * 2
    check(fwd == want and bwd == 2 * want,
          f"H2: flash launches fwd {fwd}, dq + dkv {bwd}; expected {want} "
          f"and {2 * want}")
    el = _el_check(GS, seed)
    shutil.rmtree(GS, ignore_errors=True)
    return {4: fwd + el[4], 5: bwd + el[5]}


# --- elastic resizing (--elastic-resize), in the grad-sync torchrun ----------

# EL0: the JAX package's own episode (its tiny f32 GPT-2, 12 steps); EL1:
# GPT-2 124M at L 1024 under T1's bf16 policy, global batch 16 (2 rows a
# rank a microbatch: flash #4/#5 at the kernel table's B 2), 9 steps.
EL_RUNS = {"EL0": ("slice_lost@4:1,slice_return@9", 12),
           "EL1": ("slice_lost@2:1,slice_return@6", 9)}
EL1_BATCH, EL1_SEQ, EL1_ACCUM = 16, 1024, 2
EL1_LOSS_BOUND = 0.02
# (transition, step, world from, world to) at 4 ranks in 2 slices.
EL_TRANSITIONS = {
    "EL0": [["shrink", 7, 4, 2], ["peer_restore", 7, 2, 2],
            ["grow", 9, 2, 4]],
    "EL1": [["shrink", 5, 4, 2], ["peer_restore", 5, 2, 2],
            ["grow", 6, 2, 4]],
}
# The goodput ledger's categories in seconds, each one exact integer in
# ns: EL0's are the JAX package's pins (tests/test_elastic.py); EL1's
# follow from the same virtual-clock constants (resilience/elastic.py):
# compile 2 + one step interval + two reshapes, 7 fresh and 2 rework step
# intervals of 0.375, 11 pulls, 6 commits, one restore, one backoff, the
# grow sync and the tail.
EL_LEDGER = {
    "EL0": dict(compile=3.375, step_compute=3.75, grad_sync=0.0,
                data_wait=1.75, ckpt_save=1.75, ckpt_restore=0.25,
                rework=0.75, supervisor_backoff=0.5, other=0.375),
    "EL1": dict(compile=3.375, step_compute=2.625, grad_sync=0.0,
                data_wait=1.375, ckpt_save=1.5, ckpt_restore=0.25,
                rework=0.75, supervisor_backoff=0.5, other=0.375),
}


def _el1_reference(torch, cfg, policy, seed: int, device, group,
                   rank: int) -> dict:
    """EL1's uninterrupted run: the same 9 global batches on the same 4
    ranks, accumulation 2.  Returns its losses, and on rank 0 host copies
    of its last two parameter sets and final Adam slots."""
    from pytorch_distributed_training_tpu_torch.resilience import elastic
    from pytorch_distributed_training_tpu_torch.train import make_train_step

    steps = EL_RUNS["EL1"][1]
    state = elastic.episode_state(cfg, policy, seed, device, group)
    step = make_train_step(kind="lm", policy=policy,
                           num_microbatches=EL1_ACCUM, process_group=group)
    out: dict = {"losses": []}
    for g in range(steps):
        rows = elastic.episode_rows(
            g, seed=seed, global_batch=EL1_BATCH, seq_len=EL1_SEQ,
            vocab=cfg.vocab_size, rank=rank, world=4, accum=EL1_ACCUM)
        if rank == 0 and g == steps - 1:
            out["prev"] = {n: p.detach().to("cpu", copy=True)
                           for n, p in state.params.items()}
        state, metrics = step(state, {"tokens": torch.from_numpy(rows).to(
            device)})
        out["losses"].append(float(metrics["loss"]))
    if rank == 0:
        adam = state.opt_state[0]
        names = list(state.params)
        out["params"] = {n: p.detach().cpu() for n, p in state.params.items()}
        out["mu"] = dict(zip(names, (t.cpu() for t in adam.mu)))
        out["nu"] = dict(zip(names, (t.cpu() for t in adam.nu)))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _el1_distance(torch, ref: dict, state) -> tuple:
    """``_state_distance``'s measures on the episode's final state against
    the uninterrupted run's: the parameters' L2 distance over the
    reference's last update, and the worst Adam slot's relative L2
    distance, with its name."""
    f64 = torch.float64
    dist = step = 0.0
    for n, p in state.params.items():
        x = p.detach().to(f64)
        y = ref["params"][n].to(x.device, f64)
        dist += float((x - y).square().sum())
        step += float((y - ref["prev"][n].to(x.device, f64)).square().sum())
    worst, worst_name = 0.0, None
    adam = state.opt_state[0]
    for slot in ("mu", "nu"):
        for n, t in zip(state.params, getattr(adam, slot)):
            y = ref[slot][n].to(t.device, f64)
            if float(y.norm()) > 0:
                rel = float((t.to(f64) - y).norm() / y.norm())
                if rel >= worst:
                    worst, worst_name = rel, f"opt_state/0/{slot}/{n}"
    return (dist / step) ** 0.5 if step > 0 else float("inf"), worst, \
        worst_name


def el_legs(torch, out: str, seed: int, device, group) -> None:
    """EL0 and EL1 on this rank (``grad_sync_phase``): each episode of
    ``resilience/elastic.py`` over the 4 ranks as 2 slices of 2, on the
    card.  EL1 first runs its uninterrupted reference, then the episode
    with its flash launches counted (the kernels' own counts, reset just
    before it; the plain flash versions and the plain attention path
    wrapped by ``_count_calls``).  Every rank writes ``OUT/el.rank<r>
    .json`` (its launches); rank 0 adds the reports, the episode's
    losses, step, put, restore and grow times, the reference's losses and
    the final state's distance."""
    from pytorch_distributed_training_tpu_torch.comm import collectives
    from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2Config
    from pytorch_distributed_training_tpu_torch.ops import attention as attn
    from pytorch_distributed_training_tpu_torch.ops import (
        flash_attention as fa,
    )
    from pytorch_distributed_training_tpu_torch.resilience import elastic
    from pytorch_distributed_training_tpu_torch.train import make_policy

    rank = torch.distributed.get_rank()
    res: dict = {}
    faults, steps = EL_RUNS["EL0"]
    t0 = time.monotonic()
    res["EL0"] = {"report": elastic.run_elastic_episode(
        faults=faults, n_steps=steps, device=device, process_group=group,
        seed=seed)}
    res["EL0"]["s"] = time.monotonic() - t0

    t0 = time.monotonic()
    cfg = GPT2Config(max_seq_len=EL1_SEQ)
    policy = make_policy("bf16")
    ref = _el1_reference(torch, cfg, policy, seed, device, group, rank)
    ref_s = time.monotonic() - t0
    entries = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    plain = {"flash_fwd_plain": 0, "_bwd_tiles": 0, "flash_bwd_plain": 0}
    xla = {"_xla_attention": 0, "_xla_attention_remat": 0}
    saved = (_count_calls(fa, list(plain), plain),
             _count_calls(attn, list(xla), xla))
    for e in entries:
        e.launches = 0
    faults, steps = EL_RUNS["EL1"]
    profile: dict = {}
    t1 = time.monotonic()
    try:
        report = elastic.run_elastic_episode(
            faults=faults, n_steps=steps, device=device,
            process_group=group, seed=seed, accum=EL1_ACCUM,
            global_batch=EL1_BATCH, seq_len=EL1_SEQ, model_config=cfg,
            policy=policy, profile=profile)
    finally:
        for module, originals in zip((fa, attn), saved):
            for name, fn in originals.items():
                setattr(module, name, fn)
    episode_s = time.monotonic() - t1
    mine = {"fwd": entries[0].launches, "dq": entries[1].launches,
            "dkv": entries[2].launches, "plain": plain, "xla": xla,
            "micro": sum(s["accum"] for s in profile["steps"]),
            "rank_steps": len(profile["steps"])}
    if rank == 0:
        res["EL1"] = {
            "report": report, "s": time.monotonic() - t0, "ref_s": ref_s,
            "episode_s": episode_s, "ref_losses": ref["losses"],
            "steps": profile["steps"], "put": profile["put"],
            "restore": profile["restore"], "grow": profile["grow"],
            "distance": _el1_distance(torch, ref, profile["state"]),
        }
        mine.update(res)
    with open(os.path.join(out, f"el.rank{rank}.json"), "w") as f:
        json.dump(mine, f)
    del profile, ref
    gc.collect()
    torch.cuda.empty_cache()
    collectives.barrier(group)


def _el_report_check(label: str, report: dict, vocab: int, seq: int,
                     rows: int, seed: int) -> None:
    faults, steps = EL_RUNS[label]
    kinds = [[t["transition"], t["step"], t["world_from"], t["world_to"]]
             for t in report["transitions"]]
    check(kinds == EL_TRANSITIONS[label],
          f"{label} ({faults}): transitions {kinds}")
    check(report["restore_bit_identical"] is True,
          f"{label}: the peer restore bit-identical to the committed "
          f"snapshot ({report['restore_bit_identical']})")
    from pytorch_distributed_training_tpu_torch.resilience import elastic

    oracle = elastic.oracle_batch_digests(steps, seed=seed, rows=rows,
                                          seq_len=seq, vocab=vocab)
    check(all(r["digest"] == oracle[r["step"]] for r in report["steps"])
          and report["final_step"] == steps,
          f"{label}: every step's batch the oracle's, final step "
          f"{report['final_step']}")
    check(all(r["accum"] == (4 if r["world"] == 2 else 2)
              for r in report["steps"]),
          f"{label}: accumulation 2 at world 4, 4 at world 2")
    led = report["ledger"]
    want = {k: int(v * 1_000_000_000) for k, v in EL_LEDGER[label].items()}
    check(led["identity_ok"] and led["categories_ns"] == want
          and sum(want.values()) == led["wall_ns"],
          f"{label}: the ledger's integer-ns categories "
          f"{led['categories_ns']} == {want}")


def _el_check(out: str, seed: int) -> dict:
    """EL0's and EL1's checks (``el_legs`` wrote them); prints each leg's
    line and returns EL1's flash launches by row."""
    ranks = []
    for r in range(4):
        with open(os.path.join(out, f"el.rank{r}.json")) as f:
            ranks.append(json.load(f))
    el0, el1 = ranks[0]["EL0"], ranks[0]["EL1"]
    _el_report_check("EL0", el0["report"], 128, 16, 16, seed)
    rep = el0["report"]
    print(f"elastic EL0 (the JAX package's episode: tiny f32 GPT-2, "
          f"{EL_RUNS['EL0'][0]}, 12 steps, 4 ranks in 2 slices on one card "
          f"over gloo): transitions {EL_TRANSITIONS['EL0']}, restore "
          f"bit-identical, digests the oracle's, ledger exact "
          f"({rep['ledger']['wall_ns'] / 1e9} s virtual wall); counters "
          f"{rep['counters']}; {el0['s']:.1f} s", flush=True)

    rep = el1["report"]
    _el_report_check("EL1", rep, VOCAB, EL1_SEQ, EL1_BATCH, seed)
    losses = [s["loss"] for s in el1["steps"]]
    ref = el1["ref_losses"]
    check(_finite(losses) and 10.0 <= losses[0] <= 12.0,
          f"EL1: step-0 loss {losses[0]} near ln 50257 = 10.8, all finite")
    diffs = [abs(s["loss"] - ref[s["step"]]) for s in el1["steps"]]
    check(max(diffs) <= EL1_LOSS_BOUND,
          f"EL1: each step's loss within {EL1_LOSS_BOUND} of the "
          f"uninterrupted run's ({max(diffs):.3g})")
    d = el1["distance"]
    check(d[0] <= M1_STATE_BOUND and d[1] <= M1_STATE_BOUND,
          f"EL1: final state against the uninterrupted run's: "
          f"{_distance_text(d)} (bound {M1_STATE_BOUND})")
    executed = sum(x["rank_steps"] for x in ranks)
    fwd = sum(x["fwd"] for x in ranks)
    bwd = sum(x["dq"] + x["dkv"] for x in ranks)
    # Each rank's microbatches: 2 a step at world 4, 4 at world 2.
    micro = sum(x["micro"] for x in ranks)
    want = LAYERS * micro
    check(fwd == want and bwd == 2 * want
          and not any(v for x in ranks for c in (x["plain"], x["xla"])
                      for v in c.values()),
          f"EL1: flash launches fwd {fwd}, dq + dkv {bwd} over {executed} "
          f"rank-steps ({micro} microbatches); expected {want} and "
          f"{2 * want}, no plain attention")

    def med(world):
        xs = [s["s"] * 1e3 for s in el1["steps"][1:] if s["world"] == world]
        return statistics.median(xs) if xs else float("nan")

    put = [p for p in el1["put"] if p["wire_bytes"]]
    degraded = [p for p in el1["put"] if not p["wire_bytes"]]
    rest, grow = el1["restore"][0], el1["grow"][0]
    print(f"elastic EL1 (GPT-2 124M, bf16, L 1024, 16 = 2 x 8 rows, "
          f"{EL_RUNS['EL1'][0]}, 9 steps, 4 ranks in 2 slices on one card "
          f"over gloo): transitions {EL_TRANSITIONS['EL1']}, restore "
          f"bit-identical, digests the oracle's, ledger exact; losses "
          f"{[round(x, 4) for x in losses]}, the uninterrupted run's "
          f"{[round(x, 4) for x in ref]} (worst diff {max(diffs):.3g}); "
          f"final state {_distance_text(d)}; flash fwd {fwd}, dq + dkv "
          f"{bwd}", flush=True)
    print(f"elastic EL1 times (host, rank 0): step median at world 4 "
          f"{med(4):.1f} ms, at world 2 {med(2):.1f} ms; peer put "
          f"{[round(p['s'], 3) for p in put]} s (row {put[0]['row_bytes']} "
          f"B, wire {put[0]['wire_bytes']} B a commit), degraded put "
          f"{[round(p['s'], 3) for p in degraded]} s; restore "
          f"{rest['s']:.3f} s ({rest['gathered_bytes']} B gathered); grow "
          f"transfer {grow['s']:.3f} s ({grow['bytes']} B); leg "
          f"{el1['s']:.1f} s (reference {el1['ref_s']:.1f} s, episode "
          f"{el1['episode_s']:.1f} s)", flush=True)
    return {4: fwd, 5: bwd}


# --- sharded training (--fsdp, --tensor-parallel, --zero1, SP) --------------

SH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                  "chip_smoke", "sharded")
# M1's flat run's checkpoints, kept for P1 (the same run: T1's recipe at 4
# ranks committing steps 2 and 3); removed by the pipeline phase.
M1_FLAT_CKPT = os.path.join(os.path.dirname(SH), "m1_flat_ckpt")
# M0: (label, model, sharding_config kwargs, GradSyncConfig kwargs or None).
# The tiny GPT-2 is JAX's parity model (4 heads); min_size 1 shards its
# every leaf, as JAX's own FSDP and ZeRO-1 tests do.
M0_RUNS = [
    ("fsdp4", "gpt2_tiny4", dict(fsdp=4, min_size=1), None),
    ("data2_fsdp2", "gpt2_tiny4", dict(fsdp=2, min_size=1), None),
    ("tp2", "gpt2_tiny4", dict(tensor=2), None),
    ("tp4", "gpt2_tiny4", dict(tensor=4), None),
    ("zero1", "gpt2_tiny4", dict(zero1=True, min_size=1), None),
    ("zero1_hier_int8", "gpt2_tiny4", dict(zero1=True, min_size=1),
     dict(mode="hier-int8", n_slices=2, bucket_mb=0.05, overlap=False)),
    ("hier_int8", "gpt2_tiny4", dict(),
     dict(mode="hier-int8", n_slices=2, bucket_mb=0.05, overlap=False)),
    ("ring2", "gpt2_tiny4", dict(sequence=2), None),
    ("ulysses2", "gpt2_tiny4", dict(sequence=2, mode="ulysses"), None),
    ("ring2_tp2", "gpt2_tiny4", dict(sequence=2, tensor=2), None),
    ("ulysses2_tp2", "gpt2_tiny4", dict(sequence=2, tensor=2,
                                        mode="ulysses"), None),
    ("resnet_fsdp2", "resnet", dict(fsdp=2), None),
]
M0_BATCH = {"gpt2_tiny4": 8, "resnet": 32}
# JAX's tolerances (tests/test_parallel.py): logits, loss, grads
# (rtol, atol) by kind; ZeRO-1's relative L2 for the weights after 3 steps.
M0_TOL = {"tp": (2e-4, 1e-5, (2e-3, 2e-5)), "fsdp": (2e-4, 1e-5, (2e-4, 1e-5)),
          "sp": (2e-4, 1e-5, (5e-4, 1e-5))}
M0_REL = 1e-4
# The weight update's relative L2 against the reference (the CPU test's
# 1e-2).  The hier-int8 runs' quantized gradients keep them from one
# process's weights by up to Adam's 2 lr a step; ZeRO-1 under hier-int8
# is held at M0_REL and M0_UPDATE_REL to data parallelism under the same
# sync (M0_INT8_REF: overlap off in both, so the same quantized sums).
M0_UPDATE_REL = 1e-2
M0_LR = 1e-3      # gpt2_tiny4's adamw (tools/dp_check.py)
M0_INT8_REF = "hier_int8"
# M1: T1's recipe through the CLI at 4 ranks over gloo.  The loss bound and
# the state predictions were written in PERF.md before the first run.
M1_RUNS = [("flat", []), ("fsdp4", ["--fsdp", "4"]), ("zero1", ["--zero1"]),
           ("tp2", ["--tensor-parallel", "2"]),
           ("ulysses2", ["--sequence-parallel", "2",
                         "--sequence-parallel-mode", "ulysses"])]
M1_LOSS_BOUND = 0.02
# The step-3 checkpoint against flat's (M1) and the uninterrupted run's
# (M2): the parameters' L2 distance over the reference's step-3 update,
# and each Adam slot leaf's relative L2 distance (the worst leaf).  The
# bound is 3x the largest of the layouts on the H100 (TP 2's 0.084: its
# bf16 partial sums) and under a third of what a fault gives (a data
# group's sum left out of the small leaves' gradients: 0.82 / 0.87 on
# the tiny GPT-2); PERF.md has the figures.
M1_STATE_BOUND = 0.25
# Parameters and Adam slots a rank at GLOO_LAYERS blocks (67,736,832
# parameters, 12 bytes each whole: f32 master, mu, nu): flat and Ulysses
# whole, FSDP 4 a quarter, ZeRO-1 the slots a quarter, TP 2 the blocks'
# matrices and their biases halved (28,348,416 of the parameters).
M1_STATE_GB = {"flat": 0.813, "fsdp4": 0.203, "zero1": 0.406, "tp2": 0.643,
               "ulysses2": 0.813}
# Flash launches a rank: GLOO_LAYERS blocks x 2 microbatches a step.
M1_FLASH = GLOO_LAYERS * 2 * 3
# E0: JAX's expert-parallel test model (tests/test_moe.py:127-130), f32,
# TF32 off, 3 adamw steps of 2 microbatches against one process at M0's
# tolerances and learning rate (at JAX's test's 1e-2 Adam turns the
# rounding noise of near-zero gradients into weight steps of up to lr:
# weights 3.7e-5 to 7.4e-5 from one process, within 3x of M0_REL).  (label, mesh axes or None for plain data parallelism,
# dispatch, capacity factor); dp4_drop's capacity drops tokens, which
# holds the routing over the global batch.
E0_CFG = dict(vocab_size=128, max_seq_len=16, num_layers=2, num_heads=2,
              hidden_dim=32, num_experts=4)
E0_RUNS = [("ep4", dict(expert=4), "einsum", 1.25),
           ("d2e2", dict(expert=2), "einsum", 1.25),
           ("e2t2", dict(expert=2, tensor=2), "einsum", 1.25),
           ("dp4_drop", None, "scatter", 0.5)]
E0_BATCH, E0_STEPS, E0_LR = 8, 3, M0_LR


def _m0_tol(label: str):
    if "ring" in label or "ulysses" in label:
        return M0_TOL["sp"]
    if "tp" in label:
        return M0_TOL["tp"]
    return M0_TOL["fsdp"]


def sharded_leg(out: str, seed: int) -> int:
    """One rank of the sharded phase's 4-rank torchrun (``--sharded-leg
    OUT SEED``), gloo on the one card.  M0: every run of ``M0_RUNS``, f32,
    TF32 off, accumulation 2, 3 steps, through ``tools/dp_check.py``'s
    ``run_steps`` (the first batch probed before the update), writing
    ``OUT/m0/<label>.rank<r>.json`` and rank 0's whole weights and probe
    ``OUT/m0/<label>.npz``; then E0 (``_expert_legs``, into ``OUT/e``);
    then M1's CLI runs (``cli_runs`` of ``OUT/m1.json``)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pytorch_distributed_training_tpu_torch.comm import (
        GradSyncConfig, collectives, init as comm_init,
    )
    from pytorch_distributed_training_tpu_torch.tools import dp_check

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    group = comm_init.initialize(device, backend="gloo")
    m1_out, out = out, os.path.join(out, "m0")
    try:
        rank, world = comm_init.process_index(), comm_init.process_count()
        for label, kind, shard, sync in M0_RUNS:
            model = dp_check.build_model(kind, device, seed=seed,
                                         small_stem=True, filters=64,
                                         image_size=32)
            batches = dp_check.global_batches(kind, 3, M0_BATCH[kind], 32,
                                              seed + 1)
            # The probe gathers a sharded state's gradients whole; the
            # data-parallel reference leg has no layout to gather with.
            probe = {} if kind.startswith("gpt2") and shard else None
            losses, sums, state = dp_check.run_steps(
                kind, model, batches, accum=2, device=device, group=group,
                rank=rank, world=world, probe_out=probe,
                grad_sync=None if sync is None else GradSyncConfig(**sync),
                sharding=dp_check.sharding_config(**shard))
            params = dp_check.whole(state)
            with open(os.path.join(out, f"{label}.rank{rank}.json"),
                      "w") as f:
                json.dump({"losses": losses, "checksums": sums}, f)
            if rank == 0:
                np.savez(os.path.join(out, f"{label}.npz"), **{
                    **{f"p/{k}": v.detach().cpu().numpy()
                       for k, v in params.items()},
                    **{f"probe/{k}": v for k, v in (probe or {}).items()}})
        collectives.barrier()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        _expert_legs(torch, seed, os.path.join(m1_out, "e"), group, rank,
                     world)
        with open(os.path.join(m1_out, "m1.json")) as f:
            cli_runs(torch, m1_out, json.load(f), rank)
        collectives.barrier()
    finally:
        comm_init.shutdown()
    return 0


def moe_steps(torch, *, cfg, axes, dispatch, cf, batches, accum, lr,
              precision, seed, group=None, rank=0, world=1) -> dict:
    """Train the MoE GPT-2 (``gpt2_moe`` with ``cfg`` over it, drawn from
    ``seed`` on the card) on rank ``rank``'s rows of ``batches``: plain
    data parallelism over ``group`` when ``axes`` is None, else the
    sharded state on the mesh of ``axes`` (the ``gpt2_moe`` rules: the
    expert leaves over ``expert`` and ``tensor``), one process without a
    group.  Returns the losses, drop rates, step times (card
    synchronized), state bytes a rank, peak memory and the whole
    parameters."""
    import numpy as np

    from pytorch_distributed_training_tpu_torch.comm.mesh import (
        MeshConfig, make_mesh,
    )
    from pytorch_distributed_training_tpu_torch.data.loader import rank_rows
    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.parallel.sharded import (
        state_bytes,
    )
    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        shard_batch, tp_rules_for,
    )
    from pytorch_distributed_training_tpu_torch.tools import dp_check
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, make_train_step, optim,
    )

    policy = make_policy(precision)
    model = create_model("gpt2_moe", device="cuda", seed=seed, cfg_overrides={
        **cfg, "moe_dispatch": dispatch, "moe_capacity_factor": cf})
    tx = optim.adamw(lr, weight_decay=0.1)
    mesh = None
    if axes is not None:
        mesh = make_mesh(MeshConfig(data=-1, **axes), world=world)
        state = create_train_state(model, tx, policy=policy, mesh=mesh,
                                   rules=tp_rules_for("gpt2_moe"))
        kw = dict(state_shardings=state.shardings)
    else:
        state = create_train_state(model, tx, policy=policy,
                                   process_group=group)
        kw = dict(process_group=group)
    step = make_train_step(kind="lm", policy=policy, num_microbatches=accum,
                           **kw)
    torch.cuda.reset_peak_memory_stats()
    rec: dict = {"losses": [], "drops": [], "step_s": []}
    for b in batches:
        local = (shard_batch({"tokens": b}, mesh, num_microbatches=accum)
                 if mesh is not None else
                 {"tokens": rank_rows(b, rank, world, accum)})
        local = {"tokens": torch.from_numpy(np.asarray(
            local["tokens"])).long().cuda()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, local)
        rec["losses"].append(float(m["loss"]))
        rec["step_s"].append(time.perf_counter() - t0)
        rec["drops"].append(float(m["moe_drop_rate"]))
    rec["state_bytes"] = state_bytes(state)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["params"] = {k: v.detach().float().cpu().numpy().copy()
                     for k, v in dp_check.whole(state).items()}
    return rec


def _e0_batches(seed: int):
    import numpy as np

    return np.random.default_rng(seed + 7).integers(
        0, E0_CFG["vocab_size"], (E0_STEPS, E0_BATCH, E0_CFG["max_seq_len"]))


def _expert_legs(torch, seed: int, out: str, group, rank: int,
                 world: int) -> None:
    """E0 (f32, TF32 off) on this rank: ``OUT/<label>.rank<r>.json``
    (losses, drop rates, step times, state bytes, peak memory), rank 0's
    weights ``OUT/<label>.npz``."""
    import numpy as np

    from pytorch_distributed_training_tpu_torch.comm import collectives

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for label, axes, dispatch, cf in E0_RUNS:
            rec = moe_steps(torch, cfg=E0_CFG, axes=axes, dispatch=dispatch,
                            cf=cf, batches=_e0_batches(seed), accum=2,
                            lr=E0_LR, precision="f32", seed=seed,
                            group=group, rank=rank, world=world)
            params = rec.pop("params")
            with open(os.path.join(out, f"e0_{label}.rank{rank}.json"),
                      "w") as f:
                json.dump(rec, f)
            if rank == 0:
                np.savez(os.path.join(out, f"e0_{label}.npz"), **params)
            collectives.barrier()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _e0_references(torch, seed: int) -> dict:
    """One process for each (dispatch, cf) of E0 on the whole batch."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    refs = {}
    try:
        for _, _, dispatch, cf in E0_RUNS:
            if (dispatch, cf) not in refs:
                refs[(dispatch, cf)] = moe_steps(
                    torch, cfg=E0_CFG, axes=None, dispatch=dispatch, cf=cf,
                    batches=_e0_batches(seed), accum=2, lr=E0_LR,
                    precision="f32", seed=seed)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return refs


def _expert_check(out: str, refs: dict) -> None:
    """E0 against one process."""
    import numpy as np

    parts = []
    for label, axes, dispatch, cf in E0_RUNS:
        ranks = _run_ranks(out, f"e0_{label}")
        ref = refs[(dispatch, cf)]
        mine = ranks[0]
        check(all(x["losses"] == mine["losses"] for x in ranks),
              f"E0 {label}: every rank's losses the same")
        got = dict(np.load(os.path.join(out, f"e0_{label}.npz")))
        names = sorted(ref["params"])
        a = np.concatenate([got[n].ravel() for n in names])
        b = np.concatenate([ref["params"][n].ravel() for n in names])
        lrel = max(abs(x - y) / abs(y) for x, y in zip(mine["losses"],
                                                        ref["losses"]))
        derr = max(abs(x - y) for x, y in zip(mine["drops"], ref["drops"]))
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        check(lrel <= 1e-5 and derr <= 1e-6 and rel <= M0_REL,
              f"E0 {label}: losses rel {lrel:.3g} (1e-5), drop rates "
              f"{derr:.3g} (1e-6), weights rel L2 {rel:.3g} ({M0_REL})")
        if cf < 1.0:
            check(min(mine["drops"]) > 0, f"E0 {label}: tokens dropped "
                  f"({mine['drops']})")
        parts.append(f"{label} ({dispatch}, cf {cf}) losses {lrel:.2g}, "
                     f"drop rates {[round(x, 4) for x in mine['drops']]}, "
                     f"weights {rel:.2g}, state a rank "
                     f"{mine['state_bytes']} B")
    print("sharded E0 (the tiny MoE GPT-2 of JAX's test: 2 layers, width "
          "32, 2 heads, vocab 128, L 16, E 4; 4 ranks on one card over gloo,"
          " f32, TF32 off, 3 adamw steps of 2 microbatches against one "
          "process): " + "; ".join(parts), flush=True)


def _m0_references(torch, seed: int) -> dict:
    """The one-process runs M0 is held to, on the card (f32, TF32 off):
    each model on the whole batch, probed before its first update."""
    from pytorch_distributed_training_tpu_torch.tools import dp_check

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs = {}
    try:
        for kind in M0_BATCH:
            model = dp_check.build_model(kind, "cuda", seed=seed,
                                         small_stem=True, filters=64,
                                         image_size=32)
            batches = dp_check.global_batches(kind, 3, M0_BATCH[kind], 32,
                                              seed + 1)
            probe = {} if kind.startswith("gpt2") else None
            init = {k: v.detach().cpu().numpy().copy()
                    for k, v in model.state_dict().items()}
            losses, _, state = dp_check.run_steps(
                kind, model, batches, accum=2, device="cuda",
                probe_out=probe)
            refs[kind] = (losses, {k: v.detach().cpu().numpy() for k, v in
                                   dp_check.whole(state).items()}, probe,
                          init)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return refs


def _m0_check(out: str, refs: dict) -> None:
    import numpy as np

    parts = []
    for label, kind, shard, sync in M0_RUNS:
        ranks = []
        for r in range(4):
            with open(os.path.join(out, f"{label}.rank{r}.json")) as f:
                ranks.append(json.load(f))
        check(all(x["checksums"] == ranks[0]["checksums"] for x in ranks),
              f"M0 {label}: the 4 ranks' whole states identical after every "
              "step")
        got = dict(np.load(os.path.join(out, f"{label}.npz")))
        losses, params, probe, init = refs[kind]
        mine = ranks[0]["losses"]
        note = ""
        if probe and shard:
            t_logits, t_loss, (g_rtol, g_atol) = _m0_tol(label)
            check(abs(float(got["probe/loss"]) - float(probe["loss"]))
                  <= t_loss * abs(float(probe["loss"])),
                  f"M0 {label}: probe loss {float(got['probe/loss'])} vs "
                  f"{float(probe['loss'])} (rtol {t_loss})")
            lerr = np.abs(got["probe/logits"] - probe["logits"])
            check(bool((lerr <= t_logits + t_logits
                        * np.abs(probe["logits"])).all()),
                  f"M0 {label}: logits max err {lerr.max():.3g}")
            gworst = 0.0
            for k, v in probe.items():
                if not k.startswith("grad/"):
                    continue
                e = np.abs(got[f"probe/{k}"] - v)
                check(bool((e <= g_atol + g_rtol * np.abs(v)).all()),
                      f"M0 {label}: {k} max err {e.max():.3g} (rtol "
                      f"{g_rtol}, atol {g_atol})")
                gworst = max(gworst, float(e.max()))
            note = (f"logits {lerr.max():.2g}, grads {gworst:.2g}, ")
        names = sorted(params)
        a = np.concatenate([got[f"p/{n}"].ravel() for n in names])
        b = np.concatenate([params[n].ravel() for n in names])
        if kind != "resnet":
            p0 = np.concatenate([init[n].ravel() for n in names])
            urel = float(np.linalg.norm(a - b) / np.linalg.norm(b - p0))
        if sync is not None:
            # Quantized gradients: the step-1 loss, each weight within
            # Adam's 2 lr a step of one process's.
            lerr = abs(mine[0] - losses[0])
            werr = float(np.abs(a - b).max())
            check(lerr <= 1e-5 * abs(losses[0])
                  and werr <= 2 * M0_LR * len(losses),
                  f"M0 {label}: step-1 loss {lerr:.3g} (rel 1e-5), weights "
                  f"{werr:.3g} ({2 * M0_LR * len(losses):.3g})")
            text = (f"{label} {note}step-1 loss {lerr:.2g}, weights "
                    f"{werr:.2g}, update {urel:.2g} vs one process")
            if label != M0_INT8_REF:
                ref = np.load(os.path.join(out, f"{M0_INT8_REF}.npz"))
                r = np.concatenate([ref[f"p/{n}"].ravel() for n in names])
                zrel = float(np.linalg.norm(a - r) / np.linalg.norm(r))
                zurel = float(np.linalg.norm(a - r) / np.linalg.norm(r - p0))
                check(zrel <= M0_REL and zurel <= M0_UPDATE_REL,
                      f"M0 {label} vs {M0_INT8_REF}: weights rel L2 "
                      f"{zrel:.3g} ({M0_REL}), update rel L2 {zurel:.3g} "
                      f"({M0_UPDATE_REL})")
                text += (f"; vs {M0_INT8_REF} weights {zrel:.2g}, update "
                         f"{zurel:.2g}")
            parts.append(text)
            continue
        if kind == "resnet":
            # D3's bounds: sync-BN's sums over the batch group against one
            # process's.
            lerr = max(abs(x - y) for x, y in zip(mine, losses))
            werr = float(np.abs(a - b).max())
            check(lerr <= 1e-4 and werr <= 1e-4,
                  f"M0 {label}: losses {lerr:.3g}, weights {werr:.3g} (1e-4)")
            parts.append(f"{label} losses {lerr:.2g}, weights {werr:.2g}")
            continue
        lrel = max(abs(x - y) / abs(y) for x, y in zip(mine, losses))
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        check(lrel <= 1e-5 and rel <= M0_REL and urel <= M0_UPDATE_REL,
              f"M0 {label}: losses rel {lrel:.3g} (1e-5), weights rel L2 "
              f"{rel:.3g} ({M0_REL}), update rel L2 {urel:.3g} "
              f"({M0_UPDATE_REL})")
        parts.append(f"{label} {note}losses {lrel:.2g}, weights {rel:.2g}, "
                     f"update {urel:.2g}")
    print("sharded M0 (4 ranks on one card over gloo, f32, TF32 off, 3 "
          "steps of 2 microbatches against one process; tiny GPT-2 4 heads "
          "and the shallow ResNet): ranks identical; " + "; ".join(parts),
          flush=True)


def _m1_argv(extra: list) -> list:
    return [*T1_RECIPE, *GLOO_DEPTH, *TRAIN_COMMON, "--distributed",
            "--steps-per-epoch", "3", *extra]


def _ref_steps(ref: str) -> tuple:
    """``ref``'s committed steps 3 and 2 (``_state_distance``'s
    reference, loaded once for every run held to it)."""
    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )

    mgr = CheckpointManager(ref)
    return mgr.load_tensors(3), mgr.load_tensors(2)


def _state_distance(ref: tuple, other: str, what: str) -> tuple:
    """The step-3 checkpoint in ``other`` against the reference's
    (``_ref_steps``; gathered whole, a pipelined GPT-2's stage tensors
    merged and split into the reference's layout):
    ``(w, worst, name)``, the parameters' L2 distance over the
    reference's step-3 update (step 2 to 3) and the worst Adam slot
    leaf's relative L2 distance, with its name (``_check_distance`` holds
    them to ``M1_STATE_BOUND``)."""
    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from pytorch_distributed_training_tpu_torch.parallel.gpt2_pipeline \
        import relayout_checkpoint

    a3, a2 = ref
    b3 = relayout_checkpoint(CheckpointManager(other).load_tensors(3), {
        k: tuple(v.shape) for k, v in a3.items()})
    check(a3.keys() == b3.keys(), f"{what}: the step-3 checkpoint holds "
          f"the reference's tensors ({sorted(a3.keys() ^ b3.keys())[:4]})")
    import torch

    # The f64 sums on the card when there is one: a GPT-2 124M state is
    # 1.5 GB of f32.
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    dist = step = 0.0
    worst, worst_name = 0.0, None
    for k, y in a3.items():
        if not y.is_floating_point() or y.dim() == 0:
            continue
        y, x = y.to(dev, torch.float64), b3[k].to(dev, torch.float64)
        if k.startswith("params/"):
            dist += float((x - y).square().sum())
            step += float((y - a2[k].to(dev, torch.float64)).square().sum())
        elif k.startswith("opt_state/") and float(y.norm()) > 0:
            rel = float((x - y).norm() / y.norm())
            if rel >= worst:
                worst, worst_name = rel, k
    w = (dist / step) ** 0.5 if step > 0 else float("inf")
    return w, worst, worst_name


def _distance_text(d: tuple) -> str:
    return f"weights {d[0]:.3g}, worst slot {d[1]:.3g} ({d[2]})"


def _check_distance(d: tuple, what: str) -> None:
    check(d[0] <= M1_STATE_BOUND and d[1] <= M1_STATE_BOUND,
          f"{what}: step-3 checkpoint {_distance_text(d)} (bound "
          f"{M1_STATE_BOUND})")


def _m1_check(refs, e_refs, m0_out, e_out, ckpts, t0) -> tuple:
    """The sharded phase's checks of M0, E0 and M1 (``sharded_phase``'s
    docstring) on the torchrun's records; returns (M1's records by
    label, flash #4 launches, #5 launches)."""
    import statistics as st

    _m0_check(m0_out, refs)
    _expert_check(e_out, e_refs)
    with open(os.path.join(SH, "flat.rank0.json")) as f:
        m1_seconds = sum(json.load(open(os.path.join(SH, f"{lb}.rank0.json"))
                         )["seconds"] for lb, _ in M1_RUNS + [("m2_fsdp4",
                                                               None)])
    print(f"sharded M0 + E0 + M1 torchrun: "
          f"{time.monotonic() - t0:.1f} s (M1's CLI runs {m1_seconds:.1f} s"
          ")", flush=True)
    runs, fwd, bwd = {}, 0, 0
    for label, extra in M1_RUNS:
        ranks = _run_ranks(SH, label)
        losses = ranks[0]["losses"]
        check(len(losses) == 3 and _finite(losses)
              and 10.0 <= losses[0] <= 12.0
              and all(x["losses"] == losses for x in ranks),
              f"M1 {label}: 3 equal losses on every rank, the first near "
              f"ln 50257 = 10.8: {[x['losses'] for x in ranks]}")
        for x in ranks:
            check(x["fwd"] == x["dq"] == x["dkv"] == M1_FLASH
                  and not any(x["plain"].values())
                  and not any(x["xla"].values()),
                  f"M1 {label}: flash fwd/dq/dkv launches {x['fwd']}/"
                  f"{x['dq']}/{x['dkv']} ({M1_FLASH} each: {GLOO_LAYERS} "
                  f"layers x 2 microbatches x 3 steps), no plain path "
                  f"{x['plain']} {x['xla']}")
            fwd += x["fwd"]
            bwd += x["dq"] + x["dkv"]
        gb = [x["state_bytes"] / 1e9 for x in ranks]
        want = M1_STATE_GB[label]
        check(all(abs(g - want) <= 0.1 * want for g in gb),
              f"M1 {label}: state {gb} GB a rank within 10 % of {want}")
        runs[label] = ranks
        step_ms = [st.median(x["step_s"][1:]) * 1e3 for x in ranks]
        print(f"sharded M1 {label} (GPT-2 124M's widths at {GLOO_LAYERS} "
              f"layers, T1's recipe through the CLI, bf16, L 1024, 16 = 2 "
              f"x 8 rows, 4 ranks on one card over gloo, 3 steps): losses "
              f"{[round(x, 5) for x in losses]}; parameters + slots a rank "
              f"{[round(g, 4) for g in gb]} GB (predicted {want}); peak "
              f"memory by rank {[round(x['peak_mem_gb'], 2) for x in ranks]}"
              f" GB; step (median of steps 2-3, by rank) "
              f"{[round(x, 1) for x in step_ms]} ms; flash fwd/dq/dkv "
              f"{M1_FLASH} each a rank; {ranks[0]['seconds']:.1f} s",
              flush=True)
    flat = runs["flat"][0]["losses"]
    parts, held = [], []
    flat_ref = _ref_steps(ckpts["flat"])
    for label, ranks in runs.items():
        if label == "flat":
            continue
        d1 = abs(ranks[0]["losses"][0] - flat[0])
        d3 = abs(ranks[0]["losses"][2] - flat[2])
        dist = _state_distance(flat_ref, ckpts[label], f"M1 {label}")
        parts.append(f"{label} {d1:.3g} / {d3:.3g}, {_distance_text(dist)}")
        held.append((label, d1, d3, dist))
    del flat_ref
    ratio = runs["fsdp4"][0]["state_bytes"] / runs["flat"][0]["state_bytes"]
    print(f"sharded M1: step-1 / step-3 loss vs flat (bound "
          f"{M1_LOSS_BOUND}), step-3 checkpoint vs flat's (bound "
          f"{M1_STATE_BOUND}): {'; '.join(parts)}; fsdp 4 state "
          f"{ratio:.4f} of flat's; "
          "times are gloo's on one card, not NCCL's or NVLink's",
          flush=True)
    for label, d1, d3, dist in held:
        check(d1 <= M1_LOSS_BOUND and d3 <= M1_LOSS_BOUND,
              f"M1 {label}: step-1 / step-3 loss vs flat {d1:.3g} / "
              f"{d3:.3g} within {M1_LOSS_BOUND}")
        _check_distance(dist, f"M1 {label}")
    check(ratio <= 0.30, f"M1: fsdp 4 state {ratio:.3f} of flat's (<= 0.30)")
    return runs, fwd, bwd


def sharded_phase(torch, seed: int, repo: str, carry: dict) -> dict:
    """Sharded training, every leg 4 torchrun ranks on the one card over
    gloo (NCCL takes one rank a card).  M0: parity of each layout against
    one process (``M0_RUNS``).  M1: T1's recipe at ``GLOO_LAYERS`` blocks
    through the CLI under
    flat data parallelism, ``--fsdp 4``, ``--zero1``, ``--tensor-parallel
    2`` and Ulysses ``--sequence-parallel 2``, 3 steps each: losses
    against flat within ``M1_LOSS_BOUND``, the step-3 checkpoint against
    flat's within ``M1_STATE_BOUND`` (``_state_distance``), each rank's
    state bytes within 10 % of ``M1_STATE_GB``, peak memory and step time
    printed, flash #4/#5 counted.  M2: M1's ``--fsdp 4`` checkpoint of
    step 2 resumed under ``--zero1`` at world 2 (loss and step-3
    checkpoint within the bounds) and under ``--fsdp 4`` (bitwise).  M1's
    runs and M2's ``--fsdp 4`` resume run one after another in one
    torchrun, M2's ``--zero1`` resume in a torchrun of 2 (``cli_runs``
    both), started once the ``--fsdp 4`` run committed its step 3, beside
    the first torchrun's last runs and the checks of M0, E0 and M1
    (``_m1_check``).  E0 (``_expert_check``): the MoE GPT-2 under expert
    parallelism.  M0, E0, M1 and M2's ``--fsdp 4`` resume share one
    4-rank torchrun (``sharded_leg``).  M1's flat run and its checkpoint
    stay for P1 (``carry["m1_flat"]``, ``M1_FLAT_CKPT``).  Its times are
    gloo's on one card.  Returns the flash launches by row."""
    import shutil

    shutil.rmtree(SH, ignore_errors=True)
    os.makedirs(SH)
    script = os.path.join(repo, "chip_smoke.py")
    t0 = time.monotonic()
    m0_out, e_out = os.path.join(SH, "m0"), os.path.join(SH, "e")
    os.makedirs(m0_out)
    os.makedirs(e_out)
    ckpts = {label: os.path.join(SH, f"m1_{label}_ckpt")
             for label, _ in M1_RUNS}
    ckpt = ckpts["fsdp4"]
    # M0, E0, then M1's runs and M2's --fsdp 4 resume, in one 4-rank
    # torchrun (``sharded_leg``; the CLI runs one after another by
    # ``cli_runs``); every M1 run commits step 3 (the epoch's end), flat
    # and fsdp 4 step 2 too, the references' step-3 update and M2's
    # start.
    spec = [dict(label=label, argv=_m1_argv(
        extra + ["--checkpoint-dir", ckpts[label]]
        + (["--ckpt-every-steps", "2"] if label in ("flat", "fsdp4")
           else []))) for label, extra in M1_RUNS]
    m2_fsdp4 = os.path.join(SH, "m2_fsdp4_ckpt")
    spec.append(dict(label="m2_fsdp4", copy=[ckpt, 2, m2_fsdp4],
                     argv=_m1_argv(["--fsdp", "4", "--checkpoint-dir",
                                    m2_fsdp4, "--resume"])))
    with open(os.path.join(SH, "m1.json"), "w") as f:
        json.dump(spec, f)
    logs = os.path.join(SH, "logs")
    argv = [script, "--sharded-leg", SH, str(seed)]
    directory = os.path.join(SH, "m2_zero1_ckpt")
    m2_spec = os.path.join(SH, "m2.json")
    with open(m2_spec, "w") as f:
        json.dump([dict(label="m2_zero1", copy=[ckpt, 2, directory],
                        argv=_m1_argv(["--zero1", "--checkpoint-dir",
                                       directory, "--resume"]))], f)
    m2_logs = os.path.join(SH, "m2_logs")
    m2_argv = [script, "--cli-runs-leg", SH, m2_spec]
    # M2's --zero1 resume at world 2 starts once M1's --fsdp 4 run has
    # committed its last step (its step 2 is M2's start): beside the
    # torchrun's last runs and the checks of M0, E0 and M1.
    marker = os.path.join(ckpt, "manifest-3.json")
    proc = torchrun_logged(repo, 4, argv, logs)
    m2_proc = None
    try:
        refs = _m0_references(torch, seed)
        e_refs = _e0_references(torch, seed)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            done = pool.submit(wait_ranks, proc, argv, 900, logs,
                               "M0 + E0 + M1")
            while not (done.done() or os.path.exists(marker)):
                time.sleep(0.5)
            if os.path.exists(marker):
                t2 = time.monotonic()
                m2_proc = torchrun_logged(repo, 2, m2_argv, m2_logs)
            done.result()
        check(m2_proc is not None,
              f"M1's --fsdp 4 run committed its step 3 ({marker})")
        runs, fwd, bwd = _m1_check(refs, e_refs, m0_out, e_out, ckpts, t0)
        del refs, e_refs
        wait_ranks(m2_proc, m2_argv, 300, m2_logs, "M2 zero1")
    finally:
        torchrun_kill(proc)
        if m2_proc is not None:
            torchrun_kill(m2_proc)
    m2 = {"m2_zero1": _run_ranks(SH, "m2_zero1", 2),
          "m2_fsdp4": _run_ranks(SH, "m2_fsdp4")}
    src = runs["fsdp4"][0]["losses"][2]
    for label, ranks in m2.items():
        check(all(x["steps"] == 3 and len(x["losses"]) == 1 for x in ranks),
              f"{label}: resumed at step 2, one step to 3")
        for x in ranks:
            check(x["fwd"] == x["dq"] == x["dkv"] == M1_FLASH // 3,
                  f"{label}: flash launches {x['fwd']}/{x['dq']}/{x['dkv']}"
                  f" ({M1_FLASH // 3} each)")
            fwd += x["fwd"]
            bwd += x["dq"] + x["dkv"]
    d_zero1 = abs(m2["m2_zero1"][0]["losses"][0] - src)
    m2_dist = _state_distance(_ref_steps(ckpt), directory, "M2 zero1")
    print(f"sharded M2 (M1's --fsdp 4 checkpoint of step 2): resumed under "
          f"--zero1 at world 2, step-3 loss {m2['m2_zero1'][0]['losses'][0]}"
          f" vs {src} ({d_zero1:.3g}, bound {M1_LOSS_BOUND}), step-3 "
          f"checkpoint vs the uninterrupted run's {_distance_text(m2_dist)} "
          f"(bound {M1_STATE_BOUND}); under --fsdp 4 "
          f"{m2['m2_fsdp4'][0]['losses'][0]} (bitwise: loss and step-3 "
          f"checkpoint); {time.monotonic() - t2:.1f} s since the --zero1 "
          "resume's launch (beside the torchrun's last runs and the checks "
          "of M0, E0 and M1)", flush=True)
    check(d_zero1 <= M1_LOSS_BOUND,
          f"M2: --fsdp 4 step 2 resumed under --zero1 at world 2, step-3 "
          f"loss {m2['m2_zero1'][0]['losses'][0]} vs {src} ({d_zero1:.3g}, "
          f"bound {M1_LOSS_BOUND})")
    _check_distance(m2_dist, "M2 zero1")
    same = m2["m2_fsdp4"][0]["losses"][0] == src
    check(same and _leaves(m2_fsdp4, 3) == _leaves(ckpt, 3),
          "M2: --fsdp 4 resumed under --fsdp 4 bitwise the uninterrupted "
          "run (step-3 loss and step-3 checkpoint)")
    shutil.rmtree(M1_FLAT_CKPT, ignore_errors=True)
    shutil.move(ckpts["flat"], M1_FLAT_CKPT)
    carry["m1_flat"] = runs["flat"]
    shutil.rmtree(SH, ignore_errors=True)
    return {4: fwd, 5: bwd}


# The pipeline phase: P0 parity of each pipelined layout against
# one process, P1 T1's recipe through the CLI under the three schedules,
# P2 a PP 4 checkpoint resumed in other layouts.
PP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "chip_smoke", "pipeline")
# JAX's pipeline-test GPT-2 (tests/test_pipeline.py:99-100), 8 layers for
# interleaved at PP 4 (4 stages x 2 chunks).
P0_CFG = dict(vocab_size=128, max_seq_len=32, num_layers=4, num_heads=4,
              hidden_dim=32)
P0_BATCH, P0_SEQ, P0_MICRO, P0_LR, P0_STEPS = 8, 32, 4, 1e-3, 3
# (label, schedule, stages, chunks, layers, --pp-compress, stripe, the
# other mesh axes, width); data takes the rest of the 4 ranks.  PP x FSDP
# runs at JAX's width for it (tests/test_pipeline.py's 256), where the big
# kernels reach MIN_FSDP_SIZE.
P0_RUNS = [
    ("gpipe_pp4", "gpipe", 4, 1, 4, "none", 1, {}, 32),
    ("1f1b_pp4", "1f1b", 4, 1, 4, "none", 1, {}, 32),
    ("interleaved_pp4", "interleaved", 4, 2, 8, "none", 1, {}, 32),
    ("gpipe_pp2d2", "gpipe", 2, 1, 4, "none", 1, {}, 32),
    ("1f1b_pp2d2", "1f1b", 2, 1, 4, "none", 1, {}, 32),
    ("interleaved_pp2d2", "interleaved", 2, 2, 4, "none", 1, {}, 32),
    *[(f"{s}_{m}", s, 2, 2 if s == "interleaved" else 1, 4, m, 1, {}, 32)
      for s in ("gpipe", "1f1b", "interleaved") for m in ("bf16", "int8")],
    *[(f"{s}_int8_stripe2", s, 2, 2 if s == "interleaved" else 1, 4,
       "int8", 2, {}, 32) for s in ("gpipe", "1f1b", "interleaved")],
    *[(f"{s}_pp2_fsdp2", s, 2, 1, 4, "none", 1, {"fsdp": 2}, 256)
      for s in ("gpipe", "1f1b")],
    *[(f"{s}_pp2_tp2", s, 2, 1, 4, "none", 1, {"tensor": 2}, 32)
      for s in ("gpipe", "1f1b")],
    ("gpipe_pp2_ring2", "gpipe", 2, 1, 4, "none", 1, {"sequence": 2}, 32),
]
# JAX's tolerances (tests/test_pipeline.py): loss, gradients, three steps;
# the compressed runs within JAX's int8 / bf16 band of the uncompressed
# step (test_pp_compress_int8_matches_uncompressed).
P0_LOSS_RTOL, P0_GRAD_TOL, P0_BAND = 1e-5, (2e-4, 1e-5), 5e-3
# P1: T1's recipe (no accumulation: the pipeline owns microbatching).
# Its flat reference is M1's flat run (``carry["m1_flat"]``, the same
# run).  A second flat run that closed an ABBA pair for the times was cut
# to pay for the elastic legs (EL0, EL1).
P1_RUNS = [
    ("gpipe", ["--pipeline-parallel", "4", "--pipeline-microbatches", "8"]),
    ("gpipe_remat", ["--pipeline-parallel", "4",
                     "--pipeline-microbatches", "8", "--remat"]),
    ("1f1b", ["--pipeline-parallel", "4", "--pipeline-microbatches", "8",
              "--pipeline-schedule", "1f1b", "--ckpt-every-steps", "2"]),
    ("interleaved_pp2d2", ["--pipeline-parallel", "2",
                           "--pipeline-schedule", "interleaved",
                           "--pipeline-chunks", "2"]),
    ("1f1b_int8", ["--pipeline-parallel", "4", "--pipeline-microbatches",
                   "8", "--pipeline-schedule", "1f1b", "--pp-compress",
                   "int8"]),
    ("1f1b_pp2d2", ["--pipeline-parallel", "2", "--pipeline-schedule",
                    "1f1b"]),
]
# Flash launches a rank over 3 steps: (fwd, dq = dkv).  GPipe runs its
# stage's layers on the M ticks that carry a microbatch (a bubble tick
# passes its arrival on) and backpropagates them (remat: the forward
# again); 1F1B runs each microbatch's forward twice (the tick and the
# recompute) and its backward once.  A rank holds GLOO_LAYERS / S of the
# blocks over 32 / S microbatches of a step's 3 (M 8 at PP 4, 4 at PP 2),
# so a run's backward count is 6 x GLOO_LAYERS; a resume takes one step.
P1_FLASH = {label: (fwd * GLOO_LAYERS, bwd * GLOO_LAYERS)
            for label, fwd, bwd in (
                ("gpipe", 6, 6), ("gpipe_remat", 12, 6), ("1f1b", 12, 6),
                ("interleaved_pp2d2", 12, 6), ("1f1b_int8", 12, 6),
                ("1f1b_pp2d2", 12, 6), ("resume_pp4", 4, 2),
                ("resume_pp2d2", 4, 2))}
P1_LOSS_BOUND = 0.02          # M1's
# P3: GPipe x MoE through the CLI, gpt2_moe on T1's recipe: PP 2 x data 2
# (4 microbatches of 2 rows a data rank, each routing its own rows, as
# JAX's pipeline does) against T6's one-process scatter run (the same
# batches, each microbatch of 8 rows routed whole, as a flat data-4 run
# routes them: its step-3 loss sat 0.0012 from T6's, PERF.md), step-3
# loss within M1's bound.  PP 4 is refused: 12 / 4 = 3 layers a stage
# is odd.
P3_RUNS = [("moe_pp2d2", ["--pipeline-parallel", "2"])]
P3_FLASH = {"moe_pp2d2": (72, 72)}
P1_TOKENS = 16 * 1024         # a step's global tokens
# The P1 run that writes its rank logs (``p1_telemetry``).
P1_TM_RUN = "1f1b_int8"
P1_TM = os.path.join(PP_DIR, "p1_tm")


def p1_telemetry() -> None:
    """P1's ``1f1b_int8`` run under ``--metrics-dir``: four rank logs,
    each valid, whose steps ``merge_timeline`` aligns with no rank
    missing; every rank's ``pp_compress_model`` record and its
    ``pp_boundary_bytes`` counter on each of the 3 steps equal
    ``_pp_bytes``' model."""
    from pytorch_distributed_training_tpu_torch import obs

    logs = obs.load_rank_logs(P1_TM)
    check(sorted(logs) == [0, 1, 2, 3], f"P1 telemetry: four rank logs "
          f"({sorted(logs)})")
    want = _pp_bytes(P1_TM_RUN)
    for rank, events in logs.items():
        obs.validate_events(events)
        (rec,) = [e for e in events if e.get("record") == "pp_compress_model"]
        steps = [e["counters"]["pp_boundary_bytes"] for e in events
                 if e["kind"] == "step"]
        check(rec["pp_boundary_bytes_per_step"] == want
              and rec["mode"] == "int8" and rec["num_stages"] == 4
              and steps == [want] * 3,
              f"P1 telemetry rank {rank}: pp_compress_model {rec} and the "
              f"step counters {steps} against the model's {want}")
    timeline = obs.merge_timeline(logs)
    check([row["step"] for row in timeline] == [0, 1, 2]
          and not any(row["missing_ranks"] for row in timeline),
          f"P1 telemetry: merge_timeline aligns steps 0-2 on 4 ranks "
          f"({[(r['step'], r['missing_ranks']) for r in timeline]})")
    skew = obs.straggler_report(timeline)
    print(f"pipeline P1 telemetry ({P1_TM_RUN}): 4 rank logs, steps 0-2 "
          f"aligned, pp_compress_model and pp_boundary_bytes {want} a step "
          f"on every rank; per-rank median step "
          f"{[round(v * 1e3, 1) for v in skew['per_rank_median_dt_s'].values()]}"
          f" ms, stragglers {skew['stragglers']}", flush=True)


def _p0_model(torch, seed: int, layers: int, width: int):
    from pytorch_distributed_training_tpu_torch.models import (
        GPT2, GPT2Config,
    )

    model = GPT2(GPT2Config(**{**P0_CFG, "num_layers": layers,
                               "hidden_dim": width}), device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    return model


def _p0_batches(seed: int):
    import numpy as np

    return np.random.default_rng(seed + 1).integers(
        0, 128, (P0_STEPS, P0_BATCH, P0_SEQ))


def _p0_references(torch, seed: int) -> dict:
    """One process on the card (f32, TF32 off) for each depth: the first
    batch's loss and gradients, and three adamw steps of 4 microbatches
    (losses, whole weights)."""
    from pytorch_distributed_training_tpu_torch.ops.losses import (
        cross_entropy_loss,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_train_step, optim,
    )

    batches = _p0_batches(seed)
    refs = {}
    for layers, width in sorted({(r[4], r[8]) for r in P0_RUNS}):
        model = _p0_model(torch, seed, layers, width)
        params = dict(model.named_parameters())
        t0 = torch.from_numpy(batches[0]).cuda()
        logits = torch.func.functional_call(model, params, (t0,))
        loss = cross_entropy_loss(logits[:, :-1], t0[:, 1:])
        grads = torch.autograd.grad(loss, list(params.values()))
        init = {n: p.detach().cpu().numpy().copy()
                for n, p in params.items()}
        state = create_train_state(model, optim.adamw(P0_LR,
                                                      weight_decay=0.1))
        step = make_train_step(kind="lm", num_microbatches=P0_MICRO)
        losses = []
        for b in batches:
            state, m = step(state, {"tokens": torch.from_numpy(b).cuda()})
            losses.append(float(m["loss"]))
        refs[layers, width] = dict(
            loss=float(loss.detach()), losses=losses, init=init,
            grads={n: g.cpu().numpy() for n, g in zip(params, grads)},
            params={n: p.detach().cpu().numpy()
                    for n, p in state.params.items()})
    return refs


def _p0_leg(torch, seed: int, out: str, rank: int) -> None:
    """P0 on this rank: every run of ``P0_RUNS`` (the first batch's loss
    and gradients, then three steps), rank 0 writing the whole gradients
    and weights under the plain model's names."""
    import numpy as np

    from pytorch_distributed_training_tpu_torch.comm.mesh import (
        MeshConfig, make_mesh,
    )
    from pytorch_distributed_training_tpu_torch.parallel.gpt2_pipeline import (
        PipelinedGPT2, make_pipeline_grad_fn, to_plain,
    )
    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        shard_batch,
    )
    from pytorch_distributed_training_tpu_torch.tools import dp_check
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_train_step, optim,
    )

    batches = _p0_batches(seed)
    for label, sched, S, V, layers, mode, stripe, axes, width in P0_RUNS:
        plain = _p0_model(torch, seed, layers, width)
        mesh = make_mesh(MeshConfig(data=-1, pipeline=S, **axes), world=4)
        pp = PipelinedGPT2(plain.cfg, mesh, num_microbatches=P0_MICRO,
                           schedule=sched, num_chunks=V, pp_compress=mode,
                           pp_stripe=stripe, device="cuda")
        pp.load_plain(dict(plain.named_parameters()))
        state = create_train_state(pp, optim.adamw(P0_LR, weight_decay=0.1),
                                   mesh=mesh, rules=pp.rules())

        def local(b):
            return shard_batch({"tokens": torch.from_numpy(b).cuda()}, mesh,
                               num_microbatches=P0_MICRO)

        loss, grads = pp.value_and_grad(state.params,
                                        local(batches[0])["tokens"])
        grads = to_plain({n: state.shardings.gather_full(f"params/{n}", g)
                          for n, g in grads.items()})
        step = make_train_step(kind="lm", grad_fn=make_pipeline_grad_fn(pp))
        losses, sums = [], []
        for b in batches:
            state, m = step(state, local(b))
            losses.append(float(m["loss"]))
            sums.append(dp_check.checksum(state))
        params = to_plain(dp_check.whole(state))
        with open(os.path.join(out, f"{label}.rank{rank}.json"), "w") as f:
            json.dump({"loss": float(loss), "losses": losses,
                       "checksums": sums}, f)
        if rank == 0:
            np.savez(os.path.join(out, f"{label}.npz"), **{
                **{f"g/{k}": v.cpu().numpy() for k, v in grads.items()},
                **{f"p/{k}": v.detach().cpu().numpy()
                   for k, v in params.items()}})


@contextlib.contextmanager
def group_kept():
    """The port's ``comm.init.shutdown`` held off inside: a gloo group
    joined once (``comm.init.initialize`` returns it to every later
    caller) serves several runs of the CLI or ``tools/dp_check.py`` in
    one process; the caller shuts it down."""
    from pytorch_distributed_training_tpu_torch.comm import init as comm_init

    shutdown, comm_init.shutdown = comm_init.shutdown, lambda: None
    try:
        yield
    finally:
        comm_init.shutdown = shutdown


def cli_runs(torch, out: str, runs: list, rank: int) -> dict:
    """Several CLI legs in turn in this process, a gloo group it joined
    kept across them (``group_kept``; with no group, as T6 runs, they
    simply follow each other): the records ``cli_leg`` writes, one
    ``OUT/<label>.rank<r>.json`` a run (flash launches, plain calls,
    collectives, the steps' losses, drop rates and times with the card
    synchronized around each, state bytes, this rank's parameters, the
    model's ``moe_dispatch``, peak memory, the run's seconds).  ``runs``:
    ``{"label", "argv", "copy", "grab"}``, ``copy`` a ``[directory,
    step, target]`` whose committed step rank 0 copies into ``target``
    before the run (a resume), ``grab`` ``_timed_steps``' (the returned
    record's, not the file's).  One process start and one CUDA context
    for all of them.  Returns the records by label."""
    import gc
    import shutil

    from pytorch_distributed_training_tpu_torch.cli.main import main as cli
    from pytorch_distributed_training_tpu_torch.comm import collectives
    from pytorch_distributed_training_tpu_torch.ops import attention as attn
    from pytorch_distributed_training_tpu_torch.ops import (
        flash_attention as fa,
    )
    from pytorch_distributed_training_tpu_torch.parallel.sharded import (
        state_bytes,
    )
    import pytorch_distributed_training_tpu_torch.train as train

    entries = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    plain = {"flash_fwd_plain": 0, "_bwd_tiles": 0, "flash_bwd_plain": 0}
    xla = {"_xla_attention": 0, "_xla_attention_remat": 0}
    comm = {"psum": 0, "pmean": 0}
    counted = ((fa, _count_calls(fa, list(plain), plain)),
               (attn, _count_calls(attn, list(xla), xla)),
               (collectives, _count_calls(collectives, list(comm), comm)))
    original = train.make_train_step
    records = {}
    try:
        with group_kept():
            for run in runs:
                if run.get("serve"):
                    if torch.distributed.is_initialized():
                        collectives.barrier()
                    records[run["label"]] = serve_run(torch, out, run, rank)
                    continue
                if run.get("copy") and rank == 0:
                    src, step, target = run["copy"]
                    shutil.rmtree(target, ignore_errors=True)
                    os.makedirs(target)
                    shutil.copytree(os.path.join(src, str(step)),
                                    os.path.join(target, str(step)))
                    shutil.copy(os.path.join(src, f"manifest-{step}.json"),
                                target)
                if torch.distributed.is_initialized():
                    collectives.barrier()
                for e in entries:
                    e.launches = 0
                for d in (plain, xla, comm):
                    d.update({k: 0 for k in d})
                record = {"losses": [], "step_s": []}
                _timed_steps(torch, record, run.get("grab"))
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.monotonic()
                trainer = cli(run["argv"])
                record.update(
                    steps=trainer.state.step, fwd=entries[0].launches,
                    dq=entries[1].launches, dkv=entries[2].launches,
                    plain=dict(plain), xla=dict(xla), comm=dict(comm),
                    state_bytes=state_bytes(trainer.state),
                    params=sum(p.numel()
                               for p in trainer.state.params.values()),
                    dispatch=getattr(getattr(trainer.state.model, "cfg",
                                             None), "moe_dispatch", None),
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                    seconds=time.monotonic() - t0)
                train.make_train_step = original
                del trainer
                grab = record.pop("grab", None)
                with open(os.path.join(
                        out, f"{run['label']}.rank{rank}.json"), "w") as f:
                    json.dump(record, f)
                records[run["label"]] = {**record, "grab": grab}
    finally:
        train.make_train_step = original
        for module, originals in counted:
            for name, fn in originals.items():
                setattr(module, name, fn)
    return records


def serve_run(torch, out: str, run: dict, rank: int) -> dict:
    """One ``cli_runs`` spec with ``"serve": true``: the CLI serving in
    this rank (``--serve-tp`` over the group this process joined), its
    record ``OUT/<label>.rank<r>.json``: each attention kernel's launches
    (#9, #10, #11, #12 verify, #12 prefill), the engine's decode ticks and
    this rank's prefill forwards, the heads the model's caches were made
    at, the lockstep's broadcasts (the leader), the summary and tokens
    (the leader) and the seconds; rank 0's first prefill logits go to
    ``OUT/<label>.logits.pt``."""
    from pytorch_distributed_training_tpu_torch.cli.main import main as cli
    from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2
    from pytorch_distributed_training_tpu_torch.ops import (
        decode_attention as da, paged_attention as pa,
    )
    from pytorch_distributed_training_tpu_torch.serve import ServingEngine

    entries = (da.decode_attention, da.decode_attention_multi,
               pa.paged_decode_attention, pa.paged_decode_attention_multi,
               pa.paged_prefill_attention)
    for e in entries:
        e.launches = 0
    heads: set = set()
    local_heads = GPT2.local_heads

    def counted(self):
        n = local_heads(self)
        heads.add(n)
        return n

    box: dict = {}
    # This rank's forwards: its engines' counters, plus what each reset
    # (a respawn) zeroed (rank 0's summary sums every replica's).
    made: list = []
    zeroed = {"decode_ticks": 0, "prefill_ticks": 0}
    init, reset = ServingEngine.__init__, ServingEngine.reset

    def kept(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    def counted_reset(self):
        for key in zeroed:
            zeroed[key] += getattr(self, key)
        reset(self)

    GPT2.local_heads = counted
    ServingEngine.__init__, ServingEngine.reset = kept, counted_reset
    t0 = time.monotonic()
    try:
        with first_logits(torch, box, "logits"):
            res = cli(run["argv"])
    finally:
        GPT2.local_heads = local_heads
        ServingEngine.__init__, ServingEngine.reset = init, reset
    record = dict(
        launches=[e.launches for e in entries],
        **{key: n + sum(getattr(e, key) for e in made)
           for key, n in zeroed.items()},
        heads=sorted(heads), summary=res["summary"], tokens=res["tokens"],
        tp=res.get("tp"), remote=res.get("remote"),
        router=res.get("router"), ticks=res.get("ticks"),
        seconds=time.monotonic() - t0)
    if rank == 0:
        torch.save(box["logits"], os.path.join(out,
                                               f"{run['label']}.logits.pt"))
    with open(os.path.join(out, f"{run['label']}.rank{rank}.json"),
              "w") as f:
        json.dump(record, f)
    return record


# The pipeline phase's torchrun serves GPT-2 124M at full width, bf16,
# SERVE_ARGV with speculative decoding (k = 4) over the first TP_REQUESTS
# of its requests with budgets up to 32 (a tick costs ~140 ms over gloo
# on one card: 24 host-staged all-reduces): --serve-tp 4 contiguous, then
# --serve-tp 2 --serve-replicas 2 paged (rank 0's router over its group
# and the other group's leader), then the same with replica 1 crashing at
# tick 6.  The trace's first 8 prompts, so the first prefill tick, are the
# 16-request runs'; its logits are held to theirs (serving_phase,
# paged_serving_phase) within TP_LOGITS_ATOL, row by row for the requests
# group 0 holds (the router alternates them: rows 0-3 are requests 0, 2,
# 4, 6): the row-parallel sums change bf16 roundings.
TP_RUNS = (("tp4_contig", ["--serve-tp", "4"]),
           ("tp2x2_paged", ["--serve-tp", "2", "--serve-replicas", "2",
                            "--serve-paged"]),
           ("tp2x2_crash", ["--serve-tp", "2", "--serve-replicas", "2",
                            "--serve-paged", "--serve-inject-faults",
                            "replica_crash@6:1"]))
TP_GROUP_ROWS = [0, 2, 4, 6]
TP_REQUESTS = 8
TP_LOGITS_ATOL = 5e-2
# The JAX tests' tiny GPT-2 (tests/test_serve_tp.py) at TP 2, and its
# widths at 4 heads for TP 4, f32 with TF32 off: greedy tokens equal to
# one process's on the card.
TP_TINY = {2: dict(num_layers=2, hidden_dim=32, num_heads=2, vocab_size=61,
                   max_seq_len=48),
           4: dict(num_layers=2, hidden_dim=32, num_heads=4, vocab_size=61,
                   max_seq_len=48)}
TP_TINY_ENGINES = {
    "contig": dict(num_slots=3, max_len=48, prefill_chunk=4,
                   temperature=0.0),
    "paged_spec": dict(num_slots=2, max_len=48, prefill_chunk=4,
                       temperature=0.0, paged=True, block_size=8, spec_k=3),
}


def _tp_runs(seed: int) -> list:
    return [dict(label=label, serve=True, argv=[
        *SERVE_ARGV, "--seed", str(seed), "--serve-spec", "--serve-spec-k",
        "4", "--serve-requests", str(TP_REQUESTS), "--serve-max-new", "32",
        *extra]) for label, extra in TP_RUNS]


# The tiny fleet (tp_tiny_leg): TP 2 x 2 behind rank 0's router against
# one process's 2-replica router, paged with host tiers, on a trace whose
# shared prefix warms one replica and whose burst the affinity cap
# rebalances with a sibling fetch; the crash run kills replica 1 while it
# holds work (the router's VirtualClock advances TINY_FLEET_DT a tick).
TINY_FLEET_ENGINE = dict(num_slots=2, max_len=48, prefill_chunk=4,
                         temperature=0.0, paged=True, block_size=4,
                         num_blocks=24, kv_host_mb=2.0)
TINY_FLEET_CRASH = "replica_crash@23:1"
TINY_FLEET_DT = 0.05


def _tiny_fleet_prompt(seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.concatenate([(np.arange(8, dtype=np.int32) * 5) % 61,
                           rng.integers(0, 61, (3,)).astype(np.int32)])


def _tiny_fleet(engines, crash: bool) -> dict:
    """The tiny fleet's trace through a router over ``engines`` (two
    unsharded engines, or rank 0's group engines): tokens, routing
    counters, the failover block, each record's outcome (JSON-ready)."""
    import numpy as np

    from pytorch_distributed_training_tpu_torch.resilience import (
        ServeFaultInjector,
    )
    from pytorch_distributed_training_tpu_torch.serve import (
        FailoverController, ReplicaRouter, Request, VirtualClock,
    )
    from pytorch_distributed_training_tpu_torch.utils.backoff import (
        BackoffPolicy,
    )

    clock = VirtualClock()
    toks: dict = {}
    for e in engines:
        e.stream_cb = lambda rid, t: toks.setdefault(str(rid), []).append(
            int(t))
    kw = {}
    if crash:
        kw = dict(chaos=ServeFaultInjector.from_spec(TINY_FLEET_CRASH),
                  failover=FailoverController(
                      miss_threshold=2,
                      backoff=BackoffPolicy(base_s=0.05, jitter=0.0)))
    router = ReplicaRouter(engines, clock=clock, affinity_queue_cap=1, **kw)
    pending = [Request(0, _tiny_fleet_prompt(99), 2, arrival_time=0.0)] + [
        Request(i, _tiny_fleet_prompt(i), 6, arrival_time=1.0)
        for i in range(1, 7)] + [
        Request(9, np.asarray([2, 4, 6, 8], np.int32), 6, arrival_time=1.0)]
    i = ticks = 0
    while i < len(pending) or not router.idle:
        while i < len(pending) and pending[i].arrival_time <= clock():
            router.submit(pending[i])
            i += 1
        router.tick()
        clock.advance(TINY_FLEET_DT)
        ticks += 1
        check(ticks < 2000, "TP tiny fleet: the trace converged")
    st = router.stats()
    return json.loads(json.dumps({
        "tokens": toks, "ticks": ticks, "failover": st.get("failover"),
        "router": {k: st[k] for k in ("routed", "affinity_hits",
                                      "rebalanced", "rejected",
                                      "sibling_fetches",
                                      "sibling_fetch_blocks")},
        "records": {str(r["id"]): [r["finish_reason"], r.get("retries"),
                                   r.get("replica_history")]
                    for r in router.completed},
    }))


def _tiny_requests(seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 61, (int(rng.integers(3, 9)),))
               .astype(np.int32) for _ in range(5)]
    return prompts, [6, 4, 8, 5, 7]


def _drive_engine(engine, prompts, budgets) -> dict:
    """FIFO admission into free slots and raw engine ticks; the tokens."""
    out = {i: [] for i in range(len(prompts))}
    engine.stream_cb = lambda rid, tok: out[rid].append(tok)
    pend = list(range(len(prompts)))
    while pend or engine.busy:
        while pend and engine.has_free_slot and engine.can_admit(
                prompts[pend[0]], budgets[pend[0]]):
            i = pend.pop(0)
            engine.start(i, prompts[i], budgets[i])
        engine.step()
    engine.stream_cb = None
    return out


def tp_tiny_leg(torch, out: str, seed: int, rank: int,
                device: str = "cuda") -> None:
    """The tiny f32 models of ``TP_TINY`` (TF32 off) served by
    ``TP_TINY_ENGINES`` at TP 2 (data 2 x tensor 2: two groups, each led
    by its first rank) and TP 4 over the 4 ranks, and by one process on
    each leader from the same weights; then the 2-head model as TP 2 x 2
    replicas behind rank 0's router (``_tiny_fleet``, with and without a
    crash) against one process's 2-replica router: ``OUT/tiny.rank<r>
    .json`` holds each case's tensor-parallel and one-process results
    (leaders), ``OUT/tiny_prefix.rank<r>.npz`` each rank's shard of the
    fetched prefix blocks."""
    import copy

    from pytorch_distributed_training_tpu_torch.comm.mesh import (
        MeshConfig, make_mesh,
    )
    from pytorch_distributed_training_tpu_torch.models import (
        GPT2, GPT2Config,
    )
    from pytorch_distributed_training_tpu_torch.parallel import (
        shard_for_serving,
    )
    import numpy as np

    from pytorch_distributed_training_tpu_torch.comm import collectives
    from pytorch_distributed_training_tpu_torch.serve import (
        LockstepEngine, ServingEngine, follow, hash_prompt_blocks,
    )
    from pytorch_distributed_training_tpu_torch.serve.tp import (
        ReplicaFabric, run_fleet_rank, serving_groups,
    )

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    record: dict = {}
    try:
        for tp, cfg in TP_TINY.items():
            mesh = make_mesh(MeshConfig(data=4 // tp, tensor=tp))
            ctl, leader = serving_groups(mesh)
            whole = GPT2(GPT2Config(**cfg), device=device)
            whole.init_weights(torch.Generator(device=device).manual_seed(
                seed))
            whole.eval()
            for label, kw in TP_TINY_ENGINES.items():
                trace = _tiny_requests(seed)
                model = shard_for_serving(copy.deepcopy(whole), mesh)
                engine = ServingEngine(model, device=device, **kw)
                if rank != leader:
                    follow(engine, ctl, leader)
                    continue
                lock = LockstepEngine(engine, ctl, leader)
                try:
                    got = _drive_engine(lock, *trace)
                except BaseException as e:
                    lock.close(e)
                    raise
                lock.close()
                ref = _drive_engine(ServingEngine(whole, device=device,
                                                  **kw), *trace)
                record[f"tp{tp}/{label}"] = {"tp": got, "one": ref}
        # The fleet: TP 2 x 2 behind rank 0's router (serve/tp.py) against
        # one process's 2-replica router over the whole model.
        mesh = make_mesh(MeshConfig(data=2, tensor=2))
        fabric = ReplicaFabric(mesh)
        whole = GPT2(GPT2Config(**TP_TINY[2]), device=device)
        whole.init_weights(torch.Generator(device=device).manual_seed(seed))
        whole.eval()
        for label, crash in (("fleet", False), ("fleet_crash", True)):
            engine = ServingEngine(
                shard_for_serving(copy.deepcopy(whole), mesh), device=device,
                **TINY_FLEET_ENGINE)
            got = run_fleet_rank(fabric, engine,
                                 lambda engines: _tiny_fleet(engines, crash))
            if rank == 0:
                ref = _tiny_fleet([ServingEngine(whole, device=device,
                                                 **TINY_FLEET_ENGINE)
                                   for _ in range(2)], crash)
                record[label] = {"tp": got, "one": ref}
            if not crash:
                blocks = engine.pool.blocks
                chain = hash_prompt_blocks(_tiny_fleet_prompt(99),
                                           blocks.block_size)
                np.savez(os.path.join(out, f"tiny_prefix.rank{rank}.npz"),
                         **{f"b{i}_{j}": a for i, h in enumerate(chain)
                            if (arrays := blocks.read_block_bytes(h))
                            is not None
                            for j, a in enumerate(arrays)})
            collectives.barrier()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    with open(os.path.join(out, f"tiny.rank{rank}.json"), "w") as f:
        json.dump(record, f)


def tp_check(out: str, carry: dict) -> dict:
    """The tensor-parallel runs (``TP_RUNS``): on every rank the kernels
    launched 12 times a tick at its local heads (3 under --serve-tp 4, 6
    under --serve-tp 2; contiguous: #9 + #10 = 12 x decode ticks, no
    paged kernel; paged: #11 + #12 = 12 x decode ticks and #12 prefill =
    12 x the rank's prefill forwards, no contiguous kernel), a group's
    ranks the same ticks, every request completed on rank 0 with tokens
    inside the vocabulary; the first prefill tick's logits within
    ``TP_LOGITS_ATOL`` of one process's (the rows of the requests group 0
    holds; token agreement printed as information); the crash run's
    failover block F1's (one death, work drained and requeued, one
    respawn); the remote calls and their host time a tick printed; the
    tiny f32 models (``tp_tiny_leg``) equal to one process's.  Returns
    the launches by row."""
    import numpy as np
    import torch

    launches = {"decode_attention": 0, "decode_attention_multi": 0,
                "paged_decode_attention": 0, "_paged_multi_call": 0}
    for label, argv in TP_RUNS:
        ranks = _run_ranks(out, label)
        lead = ranks[0]
        paged = "--serve-paged" in argv
        tp = int(argv[argv.index("--serve-tp") + 1])
        for r, x in enumerate(ranks):
            n9, n10, n11, n12m, n12p = x["launches"]
            if paged:
                ok = (n9 == n10 == 0 and n11 + n12m == LAYERS
                      * x["decode_ticks"] and n12p == LAYERS
                      * x["prefill_ticks"])
            else:
                ok = (n11 == n12m == n12p == 0
                      and n9 + n10 == LAYERS * x["decode_ticks"])
            peer = ranks[r - r % tp]
            check(ok and x["heads"] == [12 // tp] and x["decode_ticks"] > 0
                  and x["decode_ticks"] == peer["decode_ticks"]
                  and x["prefill_ticks"] == peer["prefill_ticks"],
                  f"TP {label} rank {r}: launches {x['launches']} vs 12 x "
                  f"{x['decode_ticks']} decode / {x['prefill_ticks']} "
                  f"prefill ticks, heads {x['heads']}")
            launches["decode_attention"] += n9
            launches["decode_attention_multi"] += n10
            launches["paged_decode_attention"] += n11
            launches["_paged_multi_call"] += n12m + n12p
        s = lead["summary"]
        toks = {int(k): v for k, v in lead["tokens"].items()}
        check(s["completed"] == TP_REQUESTS and len(toks) == TP_REQUESTS
              and all(0 <= t < VOCAB for r in toks.values() for t in r),
              f"TP {label}: {TP_REQUESTS} requests completed, tokens in the "
              "vocabulary")
        kind = "paged" if paged else "contig"
        got = torch.load(os.path.join(out, f"{label}.logits.pt"))
        ref = carry[f"logits/{kind}"]
        if tp == 2:
            got, ref = got[:len(TP_GROUP_ROWS)], ref[TP_GROUP_ROWS]
        err = (got - ref).abs().max().item()
        check(got.shape == ref.shape and err <= TP_LOGITS_ATOL,
              f"TP {label}: first prefill logits within {TP_LOGITS_ATOL} of "
              f"one process's (max err {err:.3g})")
        one = carry[f"tokens/{kind}"]
        same = sum(a == b for rid in toks for a, b in zip(toks[rid],
                                                          one[rid]))
        total = sum(min(len(v), len(one[rid])) for rid, v in toks.items())
        extra = ""
        if tp == 2:
            rt, remote = lead["router"], lead["remote"]
            per_tick = remote["round_trip_s"] / lead["ticks"] * 1e3
            served = remote["served_s"] / lead["ticks"] * 1e3
            blocked = remote["wait_s"] / lead["ticks"] * 1e3
            extra = (f"; routed {rt['routed']}, remote replica "
                     f"{remote['round_trips']} calls "
                     f"({remote['round_trips'] / lead['ticks']:.2f} a "
                     f"tick), {per_tick:.4f} ms host from send to reply a "
                     f"tick, the group's own work {served:.4f} ms, rank 0 "
                     f"blocked on replies {blocked:.4f} ms (its step "
                     f"posted before group 0's), "
                     f"{remote['cached_reads']} cached reads")
            fo = rt.get("failover")
            if "--serve-inject-faults" in argv:
                check(fo["replica_deaths"] == 1 and fo["respawns"] == 1
                      and fo["deaths"][0]["replica"] == 1
                      and fo["requeued"] + fo["retried"] > 0
                      and fo["failed"] == 0,
                      f"TP {label}: one death of group 1, its work drained "
                      f"and requeued, one respawn ({fo})")
                extra += (f"; failover: death at tick "
                          f"{fo['deaths'][0]['tick']}, requeued "
                          f"{fo['requeued']}, retried {fo['retried']}, "
                          f"respawns {fo['respawns']}")
            else:
                check(fo["replica_deaths"] == 0, f"TP {label}: no death")
        tp_note = lead["tp"]
        print(f"serve {label} (GPT-2 124M bf16, {' '.join(argv[:4])}, 4 gloo "
              f"ranks on one card, {12 // tp} heads a rank): completed "
              f"{s['completed']}/{TP_REQUESTS}, "
              f"{s['goodput_tok_per_s']} tok/s, ttft p50/p99 "
              f"{s['ttft_p50_s']}/{s['ttft_p99_s']} s, tpot p50/p99 "
              f"{s['tpot_p50_s']}/{s['tpot_p99_s']} s; decode ticks "
              f"{[x['decode_ticks'] for x in ranks]}, prefill ticks "
              f"{[x['prefill_ticks'] for x in ranks]}, launches by rank "
              f"{[x['launches'] for x in ranks]}; lockstep "
              f"{tp_note['broadcasts']} broadcasts, "
              f"{tp_note['broadcast_s'] / lead['ticks'] * 1e3:.4f} ms a tick "
              f"over {lead['ticks']} ticks{extra}; first prefill logits max "
              f"err {err:.3g} (bound {TP_LOGITS_ATOL}); token agreement with "
              f"one process (informational) {same}/{total}; "
              f"{lead['seconds']:.1f} s", flush=True)
    for kind in ("contig", "paged"):
        carry.pop(f"logits/{kind}")
        carry.pop(f"tokens/{kind}")
    tiny = _run_ranks(out, "tiny")
    leaders = {0: tiny[0], 2: tiny[2]}
    cases = 0
    for r, rec in leaders.items():
        for key, v in rec.items():
            if key.startswith("fleet"):
                continue
            check(v["tp"] == v["one"], f"TP tiny f32 {key} (leader rank "
                  f"{r}): tokens equal one process's")
            cases += 1
    check(cases == 6, f"TP tiny: 6 cases held ({cases})")
    for label in ("fleet", "fleet_crash"):
        v = tiny[0][label]
        check(v["tp"] == v["one"], f"TP tiny f32 {label}: TP 2 x 2's tokens "
              "and routing equal one process's 2-replica router's")
        cases += 1
    fo = tiny[0]["fleet_crash"]["one"]["failover"]
    check(fo["replica_deaths"] == 1 and fo["respawns"] == 1,
          f"TP tiny fleet_crash: one death, one respawn ({fo})")
    fetched = tiny[0]["fleet"]["one"]["router"]["sibling_fetch_blocks"]
    check(fetched > 0, "TP tiny fleet: a sibling fetch between groups")
    for a, b in ((0, 2), (1, 3)):
        pa_ = np.load(os.path.join(out, f"tiny_prefix.rank{a}.npz"))
        pb = np.load(os.path.join(out, f"tiny_prefix.rank{b}.npz"))
        check(sorted(pa_.files) == sorted(pb.files) and len(pa_.files) > 0
              and all(np.array_equal(pa_[k], pb[k]) for k in pa_.files),
              f"TP tiny fleet: rank {b}'s fetched prefix blocks are rank "
              f"{a}'s shard, bit for bit")
    print(f"serve TP tiny f32 (TF32 off): TP 2 (two groups) and TP 4, "
          f"contiguous and paged speculative, and TP 2 x 2 behind one "
          f"router with and without a crash of replica 1, {cases} cases, "
          f"greedy tokens equal to one process's on the card; {fetched} "
          f"prefix blocks fetched between the groups, each rank's shard "
          f"bit for bit its peer's", flush=True)
    return launches


def cli_runs_leg(out: str, spec: str, cli_joins: bool = False) -> int:
    """One rank of a torchrun of several CLI legs on the card
    (``--cli-runs-leg OUT SPEC``, ``SPEC`` a JSON list for ``cli_runs``),
    each rank in a gloo group (several ranks on the one card); with
    ``cli_joins`` (``--cli-joins``) the rank joins no group itself: the
    CLI's first ``--distributed`` run does (NCCL on the card) and
    ``group_kept`` holds it for the others."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pytorch_distributed_training_tpu_torch.comm import init as comm_init

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if not cli_joins:
        torch.set_num_threads(1)
        comm_init.initialize(device, backend="gloo")
    try:
        with open(spec) as f:
            cli_runs(torch, out, json.load(f),
                     int(os.environ.get("RANK", "0")))
    finally:
        comm_init.shutdown()
    return 0


def _p1_ckpt(label: str) -> str:
    if label == "flat":
        return M1_FLAT_CKPT
    return os.path.join(PP_DIR, f"p1_{label}_ckpt")


def _p1_runs() -> list:
    """P1's, P2's and P3's multi-rank runs for ``cli_runs``: each of
    ``P1_RUNS`` committing step 3 (1f1b step 2 too: P2's start), then the 1f1b run's step-2 checkpoint resumed under PP 4 and
    PP 2 x data 2, then ``P3_RUNS``."""
    ckpt = _p1_ckpt("1f1b")
    runs = []
    for label, extra in P1_RUNS:
        extra = extra + ["--checkpoint-dir", _p1_ckpt(label)]
        if label == P1_TM_RUN:
            extra = extra + ["--metrics-dir", P1_TM]
        runs.append(dict(label=label, argv=[
            *T1_RECIPE, *GLOO_DEPTH, *TRAIN_COMMON, "--distributed",
            "--steps-per-epoch", "3", "--accum-steps", "1", *extra]))
    for label, stages in (("resume_pp4", "4"), ("resume_pp2d2", "2")):
        directory = os.path.join(PP_DIR, f"{label}_ckpt")
        runs.append(dict(label=label, copy=[ckpt, 2, directory], argv=[
            *T1_RECIPE, *GLOO_DEPTH, *TRAIN_COMMON, "--distributed",
            "--steps-per-epoch",
            "3", "--accum-steps", "1", "--pipeline-parallel", stages,
            "--pipeline-schedule", "1f1b", "--checkpoint-dir", directory,
            "--resume"]))
    for label, extra in P3_RUNS:
        runs.append(dict(label=label, argv=[
            *T1_RECIPE, *TRAIN_COMMON, "--distributed", "--steps-per-epoch",
            "3", "--accum-steps", "1", "--model", "gpt2_moe", *extra]))
    return runs


def pipeline_leg(out: str, seed: int) -> int:
    """One rank of the pipeline phase's 4-rank torchrun (``--pipeline-leg
    OUT SEED``), gloo on the one card: P0 (f32, TF32 off), then P1 and
    P2's multi-rank legs (``cli_runs`` of ``OUT/p1.json``)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pytorch_distributed_training_tpu_torch.comm import (
        collectives, init as comm_init,
    )

    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    comm_init.initialize(device, backend="gloo")
    try:
        rank = comm_init.process_index()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.monotonic()
        _p0_leg(torch, seed, os.path.join(out, "p0"), rank)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        collectives.barrier()
        with open(os.path.join(out, f"p0.rank{rank}.json"), "w") as f:
            json.dump({"seconds": time.monotonic() - t0}, f)
        with open(os.path.join(out, "p1.json")) as f:
            cli_runs(torch, os.path.join(out, "p1"), json.load(f), rank)
        collectives.barrier()
        tp_tiny_leg(torch, os.path.join(out, "p1"), seed, rank)
        collectives.barrier()
    finally:
        comm_init.shutdown()
    return 0


def serving_leg(out: str, seed: int) -> int:
    """One rank of ``--serving-only``'s 4-rank torchrun (``--serving-leg
    OUT SEED``), gloo on the one card: the TP runs (``_tp_runs``) and
    ``tp_tiny_leg``, as the pipeline phase's torchrun runs them."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pytorch_distributed_training_tpu_torch.comm import (
        collectives, init as comm_init,
    )

    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    comm_init.initialize(device, backend="gloo")
    try:
        rank = comm_init.process_index()
        cli_runs(torch, out, _tp_runs(seed), rank)
        collectives.barrier()
        tp_tiny_leg(torch, out, seed, rank)
        collectives.barrier()
    finally:
        comm_init.shutdown()
    return 0


def serving_torchrun(torch, seed: int, repo: str, carry: dict) -> dict:
    """``--serving-only``'s TP runs: ``serving_leg`` on 4 ranks, then
    ``tp_check``.  Returns the launches by row."""
    import shutil

    base = os.path.join(repo, "build", "chip_smoke", "serving_only")
    shutil.rmtree(base, ignore_errors=True)
    out, logs = os.path.join(base, "legs"), os.path.join(base, "logs")
    os.makedirs(out)
    argv = [os.path.join(repo, "chip_smoke.py"), "--serving-leg", out,
            str(seed)]
    proc = torchrun_logged(repo, 4, argv, logs)
    try:
        wait_ranks(proc, argv, 600, logs, "serving legs")
    finally:
        torchrun_kill(proc)
    return tp_check(out, carry)


def _rel_l2(a: dict, b: dict, names) -> float:
    import numpy as np

    x = np.concatenate([a[n].ravel() for n in names])
    y = np.concatenate([b[n].ravel() for n in names])
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _p0_check(out: str, refs: dict) -> None:
    """Each P0 run against one process: ranks identical after every
    step; uncompressed runs at JAX's tolerances (loss, every gradient, 3
    steps' losses) with the weights at M0's relative L2 and update
    bounds; compressed runs within JAX's band of one process (loss and
    step losses 5e-3, gradient relative L2 5e-2, weights Adam's 2 lr a
    step); stripe 2 bitwise stripe 1."""
    import numpy as np

    parts = []
    for label, sched, S, V, layers, mode, stripe, axes, width in P0_RUNS:
        ranks = []
        for r in range(4):
            with open(os.path.join(out, f"{label}.rank{r}.json")) as f:
                ranks.append(json.load(f))
        check(all(x["checksums"] == ranks[0]["checksums"]
                  and x["losses"] == ranks[0]["losses"]
                  and x["loss"] == ranks[0]["loss"] for x in ranks),
              f"P0 {label}: the 4 ranks' losses and whole states identical")
        got = dict(np.load(os.path.join(out, f"{label}.npz")))
        ref = refs[layers, width]
        names = sorted(ref["grads"])
        g = {n: got[f"g/{n}"] for n in names}
        p = {n: got[f"p/{n}"] for n in names}
        loss, losses = ranks[0]["loss"], ranks[0]["losses"]
        gerr = max(float(np.abs(g[n] - ref["grads"][n]).max())
                   for n in names)
        grel = _rel_l2(g, ref["grads"], names)
        wrel = _rel_l2(p, ref["params"], names)
        urel = float(np.linalg.norm(np.concatenate(
            [(p[n] - ref["params"][n]).ravel() for n in names]))
            / np.linalg.norm(np.concatenate(
                [(ref["params"][n] - ref["init"][n]).ravel()
                 for n in names])))
        lerr = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
        if stripe > 1:
            one = f"{sched}_{mode}"
            base = dict(np.load(os.path.join(out, f"{one}.npz")))
            with open(os.path.join(out, f"{one}.rank0.json")) as f:
                b0 = json.load(f)
            check(b0["losses"] == losses and b0["loss"] == loss
                  and all(np.array_equal(base[k], got[k]) for k in got),
                  f"P0 {label}: bitwise stripe 1's loss, gradients and "
                  "weights")
            parts.append(f"{label} bitwise {one}")
            continue
        if mode == "none":
            rtol, atol = P0_GRAD_TOL
            check(abs(loss - ref["loss"]) <= P0_LOSS_RTOL * abs(ref["loss"]),
                  f"P0 {label}: loss {loss} vs {ref['loss']}")
            for n in names:
                e = np.abs(g[n] - ref["grads"][n])
                check(bool((e <= atol + rtol * np.abs(ref["grads"][n])).all()),
                      f"P0 {label}: gradient {n} max err {e.max():.3g} "
                      f"(rtol {rtol}, atol {atol})")
            lrel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, ref["losses"]))
            check(lrel <= P0_LOSS_RTOL and wrel <= M0_REL
                  and urel <= M0_UPDATE_REL,
                  f"P0 {label}: 3 steps' losses rel {lrel:.3g} "
                  f"({P0_LOSS_RTOL}), weights rel L2 {wrel:.3g} ({M0_REL}),"
                  f" update rel L2 {urel:.3g} ({M0_UPDATE_REL})")
        else:
            werr = max(float(np.abs(p[n] - ref["params"][n]).max())
                       for n in names)
            check(abs(loss - ref["loss"]) <= P0_BAND and lerr <= P0_BAND
                  and grel <= 10 * P0_BAND
                  and werr <= 2 * P0_LR * P0_STEPS,
                  f"P0 {label}: loss {abs(loss - ref['loss']):.3g}, steps' "
                  f"losses {lerr:.3g} (band {P0_BAND}), gradient rel L2 "
                  f"{grel:.3g} ({10 * P0_BAND}), weights {werr:.3g} "
                  f"({2 * P0_LR * P0_STEPS})")
        parts.append(f"{label} loss {abs(loss - ref['loss']):.2g}, grads "
                     f"{gerr:.2g} (rel L2 {grel:.2g}), steps {lerr:.2g}, "
                     f"weights rel L2 {wrel:.2g}, update {urel:.2g}")
    print("pipeline P0 (tiny GPT-2: 4 layers (8 for interleaved at PP 4), "
          "width 32 (256 under fsdp), 4 heads, vocab 128, L 32, batch 8 = 4 "
          "microbatches; 4 gloo ranks on one card, f32, TF32 off; against "
          "one process): ranks identical; " + "; ".join(parts), flush=True)


def _run_ranks(out: str, label: str, n: int = 4) -> list:
    """The ``n`` ranks' records of a run (``cli_runs``, the E0 legs)."""
    ranks = []
    for r in range(n):
        with open(os.path.join(out, f"{label}.rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def _bubble(label: str) -> str:
    from pytorch_distributed_training_tpu_torch.parallel.pipeline_schedule \
        import make_interleaved_schedule

    if label.startswith("interleaved"):
        return f"{make_interleaved_schedule(2, 2, 4).bubble_fraction():.4f}"
    s, m = (2, 4) if label.endswith("pp2d2") else (4, 8)
    return f"{(s - 1) / (m + s - 1):.4f}"


def _pp_bytes(label: str) -> int:
    from pytorch_distributed_training_tpu_torch.comm.compress import (
        pp_boundary_bytes_per_step,
    )

    sched = ("gpipe" if label.startswith("gpipe") else "interleaved"
             if label.startswith("interleaved") else "1f1b")
    s, m = (2, 4) if label.endswith("pp2d2") else (4, 8)
    return pp_boundary_bytes_per_step(
        schedule=sched, num_stages=s, num_microbatches=m,
        microbatch_rows=16 // m, seq_len=1024, hidden=768, act_itemsize=2,
        mode="int8" if label.endswith("int8") else "none",
        num_chunks=2 if label.startswith("interleaved") else 1)


def pipeline_phase(torch, seed: int, repo: str, carry: dict) -> dict:
    """Pipeline parallelism, every multi-rank leg 4 torchrun ranks on the
    one card over gloo (NCCL takes one rank a card), in one launch
    (``pipeline_leg``).  P0: parity of each layout (``P0_RUNS``) against
    one process.  P1: T1's recipe at ``GLOO_LAYERS`` blocks through the
    CLI, PP 4 with 8 microbatches under gpipe, gpipe --remat, 1f1b and
    1f1b --pp-compress int8, then PP 2 x data 2 under 1f1b and
    interleaved (2 chunks), against flat (M1's flat run,
    ``carry["m1_flat"]``): each pipelined step-3
    loss within ``P1_LOSS_BOUND`` of flat's and step-3 checkpoint within
    ``M1_STATE_BOUND`` (``_state_distance``), every rank's loss the same,
    the flash launches exact; state bytes, peak memory and step times
    printed.  P2: the 1f1b run's step-2 checkpoint resumed under PP 4
    (bitwise: loss and step-3 checkpoint), PP 2 x data 2 and flat at
    world 1 (this process), step-3 losses and checkpoints within the
    bounds of the 1f1b run's.  P3: GPipe x MoE (``P3_RUNS``) in the same
    torchrun.  Returns the flash launches by row (#4 forward, #5
    backward)."""
    import shutil
    import statistics as st

    from pytorch_distributed_training_tpu_torch.cli.main import main as cli

    shutil.rmtree(PP_DIR, ignore_errors=True)
    os.makedirs(PP_DIR)
    out, logs = os.path.join(PP_DIR, "legs"), os.path.join(PP_DIR, "logs")
    for part in ("p0", "p1"):
        os.makedirs(os.path.join(out, part))
    t0 = time.monotonic()
    with open(os.path.join(out, "p1.json"), "w") as f:
        json.dump(_p1_runs() + _tp_runs(seed), f)
    argv = [os.path.join(repo, "chip_smoke.py"), "--pipeline-leg", out,
            str(seed)]
    proc = torchrun_logged(repo, 4, argv, logs)
    try:
        # P0's references while the ranks start.
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            refs = _p0_references(torch, seed)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        wait_ranks(proc, argv, 600, logs, "pipeline legs")
    finally:
        torchrun_kill(proc)
    _p0_check(os.path.join(out, "p0"), refs)
    with open(os.path.join(out, "p0.rank0.json")) as f:
        print(f"pipeline P0: {json.load(f)['seconds']:.1f} s; P0 + P1 + "
              f"P2's 4-rank legs {time.monotonic() - t0:.1f} s", flush=True)

    fwd = bwd = 0
    runs = {"flat": carry.pop("m1_flat")}
    for label in [lb for lb, _ in P1_RUNS] + ["resume_pp4", "resume_pp2d2"]:
        ranks = _run_ranks(os.path.join(out, "p1"), label)
        want_f, want_b = P1_FLASH[label]
        for x in ranks:
            check(x["fwd"] == want_f and x["dq"] == want_b
                  and x["dkv"] == want_b and not any(x["plain"].values())
                  and not any(x["xla"].values()),
                  f"P1 {label}: flash fwd/dq/dkv {x['fwd']}/{x['dq']}/"
                  f"{x['dkv']} a rank ({want_f}/{want_b}/{want_b}), no plain "
                  f"path {x['plain']} {x['xla']}")
            fwd += x["fwd"]
            bwd += x["dq"] + x["dkv"]
        losses = ranks[0]["losses"]
        n = 1 if label.startswith("resume") else 3
        check(len(losses) == n and _finite(losses)
              and all(x["losses"] == losses for x in ranks),
              f"P1 {label}: {n} equal finite losses on every rank: "
              f"{[x['losses'] for x in ranks]}")
        runs[label] = ranks
    flat = runs["flat"][0]["losses"]
    check(10.0 <= flat[0] <= 12.0, f"P1 flat: first loss {flat[0]} near "
          "ln 50257 = 10.8")
    flat_ms = st.median(runs["flat"][0]["step_s"][1:]) * 1e3
    flat_ref = _ref_steps(_p1_ckpt("flat"))
    held = []
    for label, ranks in runs.items():
        if label.startswith("resume"):
            continue
        losses = ranks[0]["losses"]
        step_ms = max(st.median(x["step_s"][1:]) for x in ranks) * 1e3
        d3 = abs(losses[2] - flat[2])
        extra = ""
        if not label.startswith("flat"):
            dist = _state_distance(flat_ref, _p1_ckpt(label), f"P1 {label}")
            held.append((label, losses[2], d3, dist))
            extra = (f"; step-3 checkpoint vs flat's {_distance_text(dist)}"
                     f"; analytic bubble {_bubble(label)}; boundary bytes a "
                     f"step {_pp_bytes(label)}")
        print(f"pipeline P1 {label} (GPT-2 124M's widths at {GLOO_LAYERS} "
              f"layers, T1's recipe through the CLI, bf16, L 1024, 16 rows, "
              f"4 ranks on one card over gloo, 3 steps): losses {[round(x, 5) for x in losses]} (step 3 "
              f"vs flat {d3:.3g}); parameters + slots a rank "
              f"{[round(x['state_bytes'] / 1e9, 4) for x in ranks]} GB; "
              f"peak memory by rank "
              f"{[round(x['peak_mem_gb'], 2) for x in ranks]} GB; step "
              f"(median of steps 2-3, slowest rank) {step_ms:.1f} ms, "
              f"{P1_TOKENS / step_ms * 1e3:.0f} tokens/s (flat "
              f"{flat_ms:.1f} ms); "
              f"flash fwd/dq/dkv {ranks[0]['fwd']}/{ranks[0]['dq']}/"
              f"{ranks[0]['dkv']} a rank{extra}", flush=True)
    del flat_ref
    p1_telemetry()
    for label, loss, d3, dist in held:
        check(d3 <= P1_LOSS_BOUND,
              f"P1 {label}: step-3 loss {loss} vs flat {flat[2]} ({d3:.3g}, "
              f"bound {P1_LOSS_BOUND})")
        _check_distance(dist, f"P1 {label}")

    ckpt = _p1_ckpt("1f1b")
    src = runs["1f1b"][0]["losses"][2]
    same = runs["resume_pp4"][0]["losses"][0] == src
    check(same and _leaves(os.path.join(PP_DIR, "resume_pp4_ckpt"), 3)
          == _leaves(ckpt, 3),
          "P2: PP 4 1f1b step 2 resumed under PP 4 bitwise the "
          "uninterrupted run (step-3 loss and step-3 checkpoint)")
    src_ref = _ref_steps(ckpt)
    d_pp2 = abs(runs["resume_pp2d2"][0]["losses"][0] - src)
    dist_pp2 = _state_distance(src_ref, os.path.join(
        PP_DIR, "resume_pp2d2_ckpt"), "P2 PP 2 x data 2")
    check(d_pp2 <= P1_LOSS_BOUND,
          f"P2: resumed under PP 2 x data 2, step-3 loss "
          f"{runs['resume_pp2d2'][0]['losses'][0]} vs {src} ({d_pp2:.3g})")
    _check_distance(dist_pp2, "P2 PP 2 x data 2")
    flat_dir = os.path.join(PP_DIR, "resume_flat_ckpt")
    os.makedirs(flat_dir)
    shutil.copytree(os.path.join(ckpt, "2"), os.path.join(flat_dir, "2"))
    shutil.copy(os.path.join(ckpt, "manifest-2.json"), flat_dir)
    record: dict = {"losses": [], "step_s": []}
    original = _timed_steps(torch, record)
    try:
        trainer = cli([*T1_RECIPE, *GLOO_DEPTH, *TRAIN_COMMON,
                       "--steps-per-epoch", "3", "--checkpoint-dir",
                       flat_dir, "--resume"])
    finally:
        import pytorch_distributed_training_tpu_torch.train as train

        train.make_train_step = original
    check(trainer.state.step == 3 and len(record["losses"]) == 1,
          "P2 flat: resumed at step 2, one step to 3")
    d_flat = abs(record["losses"][0] - src)
    dist_flat = _state_distance(src_ref, flat_dir, "P2 flat")
    del src_ref
    check(d_flat <= P1_LOSS_BOUND,
          f"P2: resumed flat at world 1, step-3 loss {record['losses'][0]} "
          f"vs {src} ({d_flat:.3g}, bound {P1_LOSS_BOUND})")
    _check_distance(dist_flat, "P2 flat")
    print(f"pipeline P2 (P1's PP 4 1f1b checkpoint of step 2): resumed under "
          f"PP 4 bitwise (loss {src}, step-3 checkpoint); under PP 2 x data "
          f"2 step-3 loss {runs['resume_pp2d2'][0]['losses'][0]} "
          f"({d_pp2:.3g}), checkpoint {_distance_text(dist_pp2)}; flat at "
          f"world 1 {record['losses'][0]} ({d_flat:.3g}), checkpoint "
          f"{_distance_text(dist_flat)} (bounds {P1_LOSS_BOUND}, "
          f"{M1_STATE_BOUND}); the phase {time.monotonic() - t0:.1f} s; "
          "times are gloo's on one card", flush=True)
    del trainer
    moe_f, moe_b = _p3_check(os.path.join(out, "p1"), carry.pop("t6"))
    carry["tp_launches"] = tp_check(os.path.join(out, "p1"), carry)
    shutil.rmtree(PP_DIR, ignore_errors=True)
    shutil.rmtree(M1_FLAT_CKPT, ignore_errors=True)
    return {4: fwd + moe_f, 5: bwd + moe_b}


def _p3_check(out: str, t6: list) -> tuple:
    """P3's runs: exact flash launches, equal finite losses on every rank
    near ln 50257, the PP 2 x data 2 step-3 loss within ``P1_LOSS_BOUND``
    of T6's scatter run's (``t6``, its losses); returns the flash
    launches (#4, #5)."""
    fwd = bwd = 0
    runs = {}
    for label, _ in P3_RUNS:
        ranks = _run_ranks(out, label)
        want_f, want_b = P3_FLASH[label]
        for x in ranks:
            check(x["fwd"] == want_f and x["dq"] == want_b
                  and x["dkv"] == want_b and not any(x["plain"].values())
                  and not any(x["xla"].values()),
                  f"P3 {label}: flash fwd/dq/dkv {x['fwd']}/{x['dq']}/"
                  f"{x['dkv']} a rank ({want_f}/{want_b}/{want_b}), no plain "
                  f"path {x['plain']} {x['xla']}")
            fwd += x["fwd"]
            bwd += x["dq"] + x["dkv"]
        losses = ranks[0]["losses"]
        check(len(losses) == 3 and _finite(losses)
              and 10.0 <= losses[0] <= 12.0
              and all(x["losses"] == losses for x in ranks),
              f"P3 {label}: 3 equal finite losses on every rank, the first "
              f"near ln 50257: {[x['losses'] for x in ranks]}")
        runs[label] = ranks
        step_ms = max(statistics.median(x["step_s"][1:]) for x in ranks) * 1e3
        print(f"pipeline P3 {label} (gpt2_moe, T1's recipe through the CLI, "
              f"bf16, L 1024, 16 rows, 4 ranks on one card over gloo, 3 "
              f"steps): losses {[round(x, 5) for x in losses]}; parameters "
              f"+ slots a rank "
              f"{[round(x['state_bytes'] / 1e9, 4) for x in ranks]} GB; "
              f"peak memory by rank "
              f"{[round(x['peak_mem_gb'], 2) for x in ranks]} GB; step "
              f"(median of steps 2-3, slowest rank) {step_ms:.1f} ms; flash "
              f"fwd/dq/dkv {ranks[0]['fwd']}/{ranks[0]['dq']}/"
              f"{ranks[0]['dkv']} a rank; {ranks[0]['seconds']:.1f} s",
              flush=True)
    d3 = abs(runs["moe_pp2d2"][0]["losses"][2] - t6[2])
    print(f"pipeline P3: PP 2 x data 2 step-3 loss vs T6's scatter run "
          f"{t6[2]:.5f}: {d3:.3g} (bound {P1_LOSS_BOUND})", flush=True)
    check(d3 <= P1_LOSS_BOUND, f"P3: PP 2 x data 2 step-3 loss vs T6's "
          f"{d3:.3g} within {P1_LOSS_BOUND}")
    return fwd, bwd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cli-leg", nargs=argparse.REMAINDER,
                    help="(internal) OUT ARGV...: one rank of a CLI leg")
    ap.add_argument("--grad-sync-leg", nargs=2, metavar=("OUT", "SEED"),
                    help="(internal) one rank of the grad-sync H1 and H2 "
                    "legs")
    ap.add_argument("--sharded-leg", nargs=2, metavar=("OUT", "SEED"),
                    help="(internal) one rank of the sharded phase's legs")
    ap.add_argument("--pipeline-leg", nargs=2, metavar=("OUT", "SEED"),
                    help="(internal) one rank of the pipeline phase's legs")
    ap.add_argument("--cli-runs-leg", nargs=2, metavar=("OUT", "SPEC"),
                    help="(internal) one rank of several CLI legs in turn")
    ap.add_argument("--cli-joins", action="store_true",
                    help="(internal) with --cli-runs-leg: the CLI's "
                    "--distributed run joins the group")
    ap.add_argument("--serving-only", action="store_true",
                    help="the serving tier alone, for work on it: the "
                    "builds, the decode, paged and TP kernel checks, the "
                    "serving, paged serving, prefix and fleet phases and "
                    "the TP runs' torchrun (~3 min); prints no result line")
    ap.add_argument("--serving-leg", nargs=2, metavar=("OUT", "SEED"),
                    help="(internal) one rank of --serving-only's TP runs")
    args = ap.parse_args()
    if args.cli_leg:
        return cli_leg(args.cli_leg[0], args.cli_leg[1:])
    if args.grad_sync_leg:
        return grad_sync_leg(args.grad_sync_leg[0],
                             int(args.grad_sync_leg[1]))
    if args.sharded_leg:
        return sharded_leg(args.sharded_leg[0], int(args.sharded_leg[1]))
    if args.pipeline_leg:
        return pipeline_leg(args.pipeline_leg[0], int(args.pipeline_leg[1]))
    if args.cli_runs_leg:
        return cli_runs_leg(*args.cli_runs_leg, args.cli_joins)
    if args.serving_leg:
        return serving_leg(args.serving_leg[0], int(args.serving_leg[1]))
    only = args.serving_only
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from pytorch_distributed_training_tpu_torch.data import native
        from pytorch_distributed_training_tpu_torch.ops import (
            _build, decode_attention as da, flash_attention as fa,
            paged_attention as pa,
        )
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    t_start = time.monotonic()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    bandwidth = bandwidth_of(name)
    lint_s = lint_phase(repo, card)

    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native_lib = pool.submit(native.build)   # g++, beside the nvccs
        reports = _build.build()
        native_path = native_lib.result()
    print(f"build: {time.monotonic() - t0:.1f} s, {len(reports)} "
          f"librar{'y' if len(reports) == 1 else 'ies'} compiled in "
          f"parallel, and the native data library "
          f"{os.path.relpath(native_path, repo)}", flush=True)
    for src, rep in reports.items():
        regs = [ln.split(":", 1)[-1].strip() for ln in rep.splitlines()
                if "registers" in ln]
        spills = {ln.strip() for ln in rep.splitlines() if "spill" in ln}
        print(f"ptxas {src}: {len(regs)} kernels; {' | '.join(regs)}; "
              f"{' | '.join(sorted(spills))}", flush=True)
        if src in (os.path.basename(PAGED_SOURCE), os.path.basename(SOURCE)):
            for ln in ptxas_lines(rep):
                print(f"ptxas {ln}", flush=True)
        if src == os.path.basename(SOURCE):
            check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
                      for ln in spills), "no decode kernel instance spills")

    seconds: dict = {"lint": lint_s, "build": time.monotonic() - t0}
    # T1 writes its epoch-end checkpoint here: start from nothing.
    import shutil

    shutil.rmtree(CKPT, ignore_errors=True)

    def timed(name, phase, *a):
        t0 = time.monotonic()
        out = phase(*a)
        seconds[name] = time.monotonic() - t0
        return out

    if not only:
        flash = timed("flash", flash_kernel_phase, torch, fa, args.seed,
                      bandwidth)
    kernels = timed("decode", kernel_phase, torch, da, args.seed, bandwidth)
    kernels.update(timed("paged", paged_kernel_phase, torch, pa, args.seed,
                         bandwidth))
    timed("tp kernels", tp_kernel_phase, torch, da, pa, args.seed,
          bandwidth, kernels)
    if not only:
        timed("parity", parity_phase, torch, args.seed)
        timed("train parity", train_parity_phase, torch, fa, args.seed)
    carry: dict = {}
    _, launches = timed("serving", serving_phase, torch, da, args.seed,
                        carry)
    for kname, n in timed("paged serving", paged_serving_phase, torch, da,
                          pa, args.seed, repo, carry).items():
        launches[kname] = launches.get(kname, 0) + n
    timed("prefix", prefix_phase, torch, args.seed, repo)
    for kname, n in timed("fleet", fleet_phase, torch, pa, args.seed,
                          repo).items():
        launches[kname] = launches.get(kname, 0) + n
    if only:
        for kname, n in timed("tp runs", serving_torchrun, torch, args.seed,
                              repo, carry).items():
            launches[kname] = launches.get(kname, 0) + n
        print("phases: " + ", ".join(f"{k} {v:.1f} s"
                                     for k, v in seconds.items()), flush=True)
        print(f"serving only: every check held; launches {launches}; "
              f"{time.monotonic() - t_start:.1f} s", flush=True)
        return 0
    timed("generate", generate_phase, torch, da, args.seed)
    figures: dict = {}
    for num, n in timed("training", training_phase, torch, fa, args.seed,
                        figures).items():
        flash[num]["launches"] = n
    for num, n in timed("moe", moe_train_phase, torch, args.seed,
                        carry).items():
        flash[num]["launches"] += n
    timed("image", image_phase, torch, args.seed, repo, figures)
    for num, n in timed("dp", dp_phase, torch, args.seed, repo,
                        figures).items():
        flash[num]["launches"] += n
    for num, n in timed("vit", vit_phase, torch, fa, args.seed, repo,
                        figures).items():
        flash[num]["launches"] += n
    for num, n in timed("checkpoint", checkpoint_phase, torch, args.seed,
                        repo, figures).items():
        flash[num]["launches"] += n
    for num, n in timed("cache+guard", cache_guard_phase, torch, fa,
                        args.seed, repo).items():
        flash[num]["launches"] += n
    for num, n in timed("grad sync", grad_sync_phase, torch, args.seed,
                        repo).items():
        flash[num]["launches"] += n
    for num, n in timed("sharded", sharded_phase, torch, args.seed, repo,
                        carry).items():
        flash[num]["launches"] += n
    for num, n in timed("pipeline", pipeline_phase, torch, args.seed, repo,
                        carry).items():
        flash[num]["launches"] += n
    for kname, n in carry.pop("tp_launches").items():
        launches[kname] = launches.get(kname, 0) + n
    for kname, n in launches.items():
        kernels[kname]["launches"] = n
    print("phases: " + ", ".join(f"{k} {v:.1f} s"
                                 for k, v in seconds.items()), flush=True)
    print(f"total: {time.monotonic() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    rows = [flash[num] for num in sorted(flash)] + list(kernels.values())
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
