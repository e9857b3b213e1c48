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
  command reading the same packed file.

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
    ("T1", T1_RECIPE + ["--steps-per-epoch", "8"], 12, 2, 8, False, (4, 5)),
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
    """One rank of a CLI leg under torchrun (``--cli-leg OUT ARGV...``):
    runs the CLI with the flash kernels' launches counted and writes them
    to OUT with the plain flash and plain attention calls (which must be
    none) and the calls of the collectives ``psum`` and ``pmean`` (each
    ``pmean`` makes one ``psum``; the rest are sync-BN's)."""
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
    trainer = cli(argv)
    with open(out, "w") as f:
        json.dump({"fwd": entries[0].launches, "dq": entries[1].launches,
                   "dkv": entries[2].launches, "plain": plain, "xla": xla,
                   "comm": comm, "steps": trainer.state.step}, f)
    return 0


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
