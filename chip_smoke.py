#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from the sources in this checkout (nvcc,
one process per source, all at once, into build/torch_kernels/) and the
native data library (g++, csrc/fastbatch.cpp, into build/fastbatch/), holds
each kernel against its plain PyTorch version and times both, then drives
the port's main paths:

- serving: the ``--serve`` CLI serving GPT-2 124M (bf16, fresh weights
  from the seed) over the contiguous cache with and without speculative
  decoding, and over the paged pool plainly, with speculative decoding and
  with int8 KV, checking that every request completed and that the
  attention kernels carried every decode, verify and prefill tick; a
  scripted engine run at full width serves shared-prefix traffic through
  the prefix cache; lockstep ``generate`` runs at full width; a small f32
  model's slot-mode logits on the card are checked against the host;
- training: the CLI trains GPT-2 at full width (124M at 1024 and 512
  positions with gradient accumulation, XL widths at 1024, 2048
  positions, and the main run again with remat and chunked CE), each run
  routed to the flash kernels that port one TPU tiling, with the flash
  launch counts checked exactly and no attention outside the kernels; a
  small f32 model trains three steps on the card and on the host from the
  same weights and must agree;
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
- data parallel (the reference's DDP), each leg a ``torch.distributed.run``
  of the port read back through ``--metrics-jsonl``: D1 R2's command with
  ``--distributed`` (a one-rank NCCL group: sync-BN and the gradient
  all-reduce on the path), D2 T1's recipe with ``--distributed`` (2
  epochs of 8 steps, the flash launches counted in the rank, which runs
  this script as ``--cli-leg OUT ARGV...``), D3 two ranks on the one card
  over gloo (a shallow ResNet and a 2-layer GPT-2, f32, TF32 off, 3
  steps): the ranks bit-identical and within 1e-4 of one process;
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
  flash launches and step-8 checkpoint equal to T1's, C2 R2's command
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

Each phase prints its lines; any failed check ends the run with a
traceback and a non-zero exit.  The last lines are the kernel table
(JSON), the card's name and power limit, and the result object.  Without
a CUDA device, or without the port package beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
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


def bound_ms(index, c: int, dtype, bandwidth: float) -> tuple[float, str]:
    """Least time for the work these inputs need: the visible K/V prefix
    read once plus q, out and index, against the flops of QK^T and PV."""
    item = 2 if "bfloat16" in str(dtype) else 4
    keys = [min(i + c, L) for i in index]
    per_query = [min(i + j + 1, L) for i in index for j in range(c)]
    nbytes = (2 * sum(keys) * H * DH * item + 2 * B * c * H * DH * item
              + 4 * B)
    ops = 4 * sum(per_query) * H * DH
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


def serving_phase(torch, da, seed: int) -> tuple[dict, dict]:
    """The main path: the CLI serving GPT-2 124M in bf16, once plainly and
    once with speculative decoding (k = 4)."""
    from pytorch_distributed_training_tpu_torch.cli.main import main as cli

    argv = SERVE_ARGV + ["--seed", str(seed)]
    runs, launches = {}, {"decode_attention": 0, "decode_attention_multi": 0}
    for spec in (False, True):
        da.decode_attention.launches = 0
        da.decode_attention_multi.launches = 0
        res = cli(argv + (["--serve-spec", "--serve-spec-k", "4"] if spec else []))
        n9 = da.decode_attention.launches
        n10 = da.decode_attention_multi.launches
        launches["decode_attention"] += n9
        launches["decode_attention_multi"] += n10
        s, ticks = res["summary"], res["engine"]["decode_ticks"]
        label = "spec" if spec else "plain"
        check(s["completed"] == 16, f"{label}: 16 requests completed")
        toks = res["tokens"]
        check(all(0 <= t < 50257 for r in toks.values() for t in r),
              f"{label}: tokens inside the vocabulary")
        check(sum(len(r) for r in toks.values()) == s["generated_tokens"],
              f"{label}: streamed tokens match the summary")
        if spec:
            check(n10 > 0, "spec: decode_attention_multi launched")
            check(n9 + n10 == LAYERS * ticks,
                  "spec: one kernel launch per layer per decode/verify tick")
        else:
            check(n9 == LAYERS * ticks and n10 == 0,
                  "plain: decode_attention launched 12x per decode tick")
        print(f"serve {label}: completed {s['completed']}/16, "
              f"{s['goodput_tok_per_s']} tok/s, ttft p50/p99 "
              f"{s['ttft_p50_s']}/{s['ttft_p99_s']} s, tpot p50/p99 "
              f"{s['tpot_p50_s']}/{s['tpot_p99_s']} s, decode ticks {ticks}, "
              f"launches decode_attention {n9} decode_attention_multi {n10}",
              flush=True)
        runs[label] = res
    a, b = runs["plain"]["tokens"], runs["spec"]["tokens"]
    same = sum(x == y for rid in a for x, y in zip(a[rid], b[rid]))
    total = sum(len(a[rid]) for rid in a)
    print(f"serve agreement (informational): {same}/{total} tokens equal "
          "between plain and speculative runs", flush=True)
    return runs, launches


def paged_bound_ms(index, c: int, storage: str, bandwidth: float
                   ) -> tuple[float, str]:
    """Least time for one paged call on these inputs: the visible whole
    blocks of each row at the stored width (plus their bf16 scales when
    quantized), q, out, table and index read or written once, against
    the flops of QK^T and PV at q's dtype."""
    item = {"f32": 4, "bf16": 2, "int8": 1, "int4": 0.5}[storage]
    q_item = 4 if storage == "f32" else 2
    span = NB * BS
    blocks = sum(min(NB, (i + c - 1) // BS + 1) for i in index)
    nbytes = 2 * blocks * H * BS * DH * item
    if storage in ("int8", "int4"):
        nbytes += 2 * blocks * H * BS * 2
    nbytes += 2 * B * c * H * DH * q_item + 4 * B * NB + 4 * B
    live = sum(min(i + j + 1, span) for i in index for j in range(c))
    ops = 4 * live * H * DH
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


def paged_serving_phase(torch, da, pa, seed: int) -> dict:
    """The paged main path: the CLI serving GPT-2 124M in bf16 from the
    paged pool, plainly, with speculative decoding (k = 4) and with int8
    KV.  Every decode and verify tick must run #11 or #12 and every
    prefill tick #12, once per layer, and #9/#10 never."""
    from pytorch_distributed_training_tpu_torch.cli.main import main as cli
    from pytorch_distributed_training_tpu_torch.serve import ServingEngine

    prefill_ticks = [0]
    original = ServingEngine.prefill_step

    def counted_prefill(self):
        if self._live("prefill"):
            prefill_ticks[0] += 1
        return original(self)

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
            res = cli(argv + extra)
            n9, n10, n11, n12m, n12p = (e.launches for e in entries)
            s, st = res["summary"], res["engine"]
            ticks = st["decode_ticks"]
            check(s["completed"] == 16, f"{label}: 16 requests completed")
            toks = res["tokens"]
            check(all(0 <= t < VOCAB for r in toks.values() for t in r),
                  f"{label}: tokens inside the vocabulary")
            check(n9 == 0 and n10 == 0,
                  f"{label}: the contiguous kernels launched {n9}, {n10}")
            check(n11 + n12m == LAYERS * ticks,
                  f"{label}: one paged launch per layer per decode/verify "
                  f"tick ({n11} + {n12m} vs {ticks} ticks)")
            check(n12p == LAYERS * prefill_ticks[0],
                  f"{label}: one prefill launch per layer per prefill tick "
                  f"({n12p} vs {prefill_ticks[0]} ticks)")
            if "spec" in label:
                check(n12m > 0, f"{label}: the verify chunk ran #12")
            launches["paged_decode_attention"] += n11
            launches["_paged_multi_call"] += n12m + n12p
            print(f"serve {label}: completed {s['completed']}/16, "
                  f"{s['goodput_tok_per_s']} tok/s, ttft p50/p99 "
                  f"{s['ttft_p50_s']}/{s['ttft_p99_s']} s, tpot p50/p99 "
                  f"{s['tpot_p50_s']}/{s['tpot_p99_s']} s, decode ticks "
                  f"{ticks}, prefill ticks {prefill_ticks[0]}, launches "
                  f"paged_decode_attention {n11} paged_decode_attention_multi "
                  f"{n12m} paged_prefill_attention {n12p}", flush=True)
    finally:
        ServingEngine.prefill_step = original
    return launches


def prefix_phase(torch, seed: int) -> None:
    """Shared-prefix traffic at full width: 16 requests with one
    128-token prefix (8 blocks) and distinct tails, through the paged
    engine's prefix cache; the same requests without the cache give the
    greedy-token agreement (information only: bf16)."""
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
    for cache_on in (True, False):
        tokens: dict = {}
        engine = ServingEngine(
            model, num_slots=8, paged=True, prefix_cache=cache_on,
            temperature=0.0, seed=seed, device="cuda",
            stream_cb=lambda rid, tok: tokens.setdefault(rid, []).append(tok),
        )
        sched = ContinuousScheduler(engine, clock=VirtualClock())
        for i, p in enumerate(prompts):
            check(sched.submit(Request(i, p, 32)), "prefix: request queued")
        while not sched.idle:
            sched.tick()
        st = engine.stats()
        check(len(sched.completed) == 16, "prefix: 16 requests completed")
        engine.pool.check_invariants()
        runs[cache_on] = (tokens, st)
    tokens, st = runs[True]
    check(st["prefix_hit_tokens"] > 0, "prefix: the prefix cache was hit")
    check(st["prefill_tokens_computed"] < st["prefill_tokens_offered"],
          "prefix: hits skipped prefill work")
    plain = runs[False][0]
    same = sum(x == y for rid in tokens for x, y in zip(tokens[rid], plain[rid]))
    total = sum(len(tokens[rid]) for rid in tokens)
    print(f"prefix: prefix_hit_tokens {st['prefix_hit_tokens']}, prefill "
          f"tokens {st['prefill_tokens_computed']}/"
          f"{st['prefill_tokens_offered']}, cow copies {st['cow_copies']}; "
          f"agreement with prefix_cache=False (informational): "
          f"{same}/{total} tokens", flush=True)
    del model


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
    Returns D2's launches by row."""
    import numpy as np

    from pytorch_distributed_training_tpu_torch.tools import dp_check

    out_dir = os.path.join(repo, "build", "chip_smoke", "dp")
    os.makedirs(out_dir, exist_ok=True)

    script = os.path.join(repo, "chip_smoke.py")
    joined = "Process group initialized - WORLD_SIZE: 1, RANK: 0"
    t0 = time.monotonic()
    path = os.path.join(out_dir, "d1.jsonl")
    if os.path.exists(path):
        os.remove(path)
    counts = os.path.join(out_dir, "d1_calls.json")
    out = torchrun(repo, 1, [script, "--cli-leg", counts, *R2_ARGV,
                             "--distributed", "--seed", str(seed),
                             "--metrics-jsonl", path], timeout=240)
    check(joined in out and "process 0/1 | backend=cuda | devices=1" in out,
          "D1: the CLI joined a one-rank group on the card")
    with open(counts) as f:
        comm = json.load(f)["comm"]
    recs = _records(path)
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
          f"all-reduces; {time.monotonic() - t0:.1f} s", flush=True)

    t0 = time.monotonic()
    path = os.path.join(out_dir, "d2.jsonl")
    if os.path.exists(path):
        os.remove(path)
    counts = os.path.join(out_dir, "d2_launches.json")
    out = torchrun(repo, 1, [script, "--cli-leg", counts, *T1_RECIPE,
                             *TRAIN_COMMON, "--epochs", "2",
                             "--steps-per-epoch", "8", "--total-steps", "16",
                             "--distributed", "--seed", str(seed),
                             "--metrics-jsonl", path], timeout=240)
    check(joined in out, "D2: the CLI joined a one-rank group on the card")
    with open(counts) as f:
        n = json.load(f)
    recs = _records(path)
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
          f"dq {n['dq']} dkv {n['dkv']}; {time.monotonic() - t0:.1f} s",
          flush=True)

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


def vit_phase(torch, fa, seed: int, repo: str, figures: dict) -> dict:
    """The ViT path (BASELINE configs[2]) on packed records: V1 through
    the CLI, V2 with ``--distributed``, V3 forced flash against the
    kernel-free layouts, V4 card against host, R2p ResNet-50 on the same
    records.  Returns V3's launches by row."""
    from pytorch_distributed_training_tpu_torch.cli.main import main as cli
    from pytorch_distributed_training_tpu_torch.data import (
        native, synthesize_packed_images,
    )

    out_dir = os.path.join(repo, "build", "chip_smoke", "vit")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train.pck")
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

    # V2: V1 with --distributed, one NCCL rank.
    t0 = time.monotonic()
    script = os.path.join(repo, "chip_smoke.py")
    metrics = os.path.join(out_dir, "v2.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)
    counts = os.path.join(out_dir, "v2_calls.json")
    out = torchrun(repo, 1, [script, "--cli-leg", counts, *vit_argv(path),
                             "--distributed", "--seed", str(seed),
                             "--metrics-jsonl", metrics], timeout=300)
    check("Process group initialized - WORLD_SIZE: 1, RANK: 0" in out
          and "process 0/1 | backend=cuda | devices=1" in out,
          "V2: the CLI joined a one-rank group on the card")
    with open(counts) as f:
        n = json.load(f)
    recs = _records(metrics)
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
          f"{time.monotonic() - t0:.1f} s", flush=True)

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
        counts = []
        for i, extra in enumerate(([], ["--resume"])):
            out_json = os.path.join(CKPT, f"c1_{i}.json")
            proc = subprocess.Popen(
                [sys.executable, script, "--cli-leg", out_json, *argv,
                 *extra], cwd=repo, stdout=subprocess.PIPE,
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
    DC1 R1 with and without ``--device-cache`` (loader / cache / cache /
    loader), DC2 R2p's ResNet-50 and V1's ViT-B/16 on V1's packed
    records, DC3 T1 on a token file written from the seed (flash #4/#5):
    each warm epoch's rate and step, and a profiled window's busy share
    and host-to-device copies a step, which must be 0 with the cache.
    G1 T1 with ``--skip-bad-steps`` against T1 without, off / on / on /
    off: bitwise the same trajectory (flash #4/#5); then ``gate_turns``,
    the gate's cost a step.  G2 R1's loader command (float batches) with the gate,
    ``nan_batch@3`` and ``spike_batch@6:1e4``: the NaN step skipped, the
    parameters bitwise unchanged across it, the norms around the spike.
    G3 R1's loader command with a spike threshold below G2's clean norms
    under ``--elastic --max-restarts 1``: a rollback, an abort, the
    supervisor's relaunch failing the same way (a subprocess, beside
    DC4).  DC4 DC1's cached command preempted by ``sigterm@4`` under
    step checkpoints every 2 and resumed, cuDNN held to its
    deterministic algorithms: bitwise on the uninterrupted cached run at
    step 100.  Returns DC3's and G1's flash launches by row."""
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

    # DC1: the reference's run, loader / cache / cache / loader; warm steps
    # 20-24 of the first epoch are profiled, the second epoch is timed
    # unprofiled.
    _pair(torch, cli, "DC1 R1", R1_ARGV + seed_argv, 50, 20, 5, 1,
          "images/s", order=("loader", "cache", "cache", "loader"))
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

    # G1: T1 with and without the gate, off / on / on / off; every step's
    # loss bits and the end weights' crc32 must agree.
    runs = []
    _reset_flash(fa)
    for gate in (False, True, True, False):
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
    check(fwd == dq == dkv == 4 * 12 * 2 * 16,
          f"G1: flash launches fwd {fwd} dq {dq} dkv {dkv}, expected "
          f"{4 * 12 * 2 * 16} each (four runs of 16 steps)")
    launches[4] += fwd
    launches[5] += dq + dkv
    ref = runs[0]
    for gate, bits, crc, _ in runs[1:]:
        check(bits == ref[1], f"G1: losses {bits} against {ref[1]}")
        check(crc == ref[2], "G1: end weights bitwise equal")
    off = [r[3] for r in runs if not r[0]]
    on = [r[3] for r in runs if r[0]]
    print(f"G1 T1 --skip-bad-steps (off / on / on / off, 2 x 8 steps): "
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
                                 run_dir, "--ckpt-every-steps", "2",
                                 "--inject-faults", "sigterm@4"]
    try:
        cli(dc4)
        code = 0
    except SystemExit as e:
        code = e.code
    check(code == 75, f"DC4: preempted run exit {code}, expected 75")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cli-leg", nargs=argparse.REMAINDER,
                    help="(internal) OUT ARGV...: one rank of a CLI leg")
    args = ap.parse_args()
    if args.cli_leg:
        return cli_leg(args.cli_leg[0], args.cli_leg[1:])
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

    seconds: dict = {"build": time.monotonic() - t0}
    # T1 writes its epoch-end checkpoint here: start from nothing.
    import shutil

    shutil.rmtree(CKPT, ignore_errors=True)

    def timed(name, phase, *a):
        t0 = time.monotonic()
        out = phase(*a)
        seconds[name] = time.monotonic() - t0
        return out

    flash = timed("flash", flash_kernel_phase, torch, fa, args.seed,
                  bandwidth)
    kernels = timed("decode", kernel_phase, torch, da, args.seed, bandwidth)
    kernels.update(timed("paged", paged_kernel_phase, torch, pa, args.seed,
                         bandwidth))
    timed("parity", parity_phase, torch, args.seed)
    timed("train parity", train_parity_phase, torch, fa, args.seed)
    _, launches = timed("serving", serving_phase, torch, da, args.seed)
    launches.update(timed("paged serving", paged_serving_phase, torch, da,
                          pa, args.seed))
    for kname, n in launches.items():
        kernels[kname]["launches"] = n
    timed("prefix", prefix_phase, torch, args.seed)
    timed("generate", generate_phase, torch, da, args.seed)
    figures: dict = {}
    for num, n in timed("training", training_phase, torch, fa, args.seed,
                        figures).items():
        flash[num]["launches"] = n
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
