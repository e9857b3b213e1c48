#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from the sources in this checkout (nvcc,
one process per source, into build/torch_kernels/), holds each kernel
against its plain PyTorch version at the serving shapes and times both,
then drives the port's main paths — the ``--serve`` CLI serving GPT-2
124M (bf16, fresh weights from the seed) over the contiguous cache with
and without speculative decoding, and over the paged pool plainly, with
speculative decoding and with int8 KV — and checks that every request
completed and that the attention kernels carried every decode, verify and
prefill tick they should.  A scripted engine run at full width serves
shared-prefix traffic through the prefix cache.  Lockstep ``generate``
runs at full width too, and a small f32 model's slot-mode logits on the
card, contiguous and paged, are checked against the same model on the
host.

Each phase prints one line; any failed check ends the run with a
traceback and a non-zero exit.  The last lines are the kernel table
(JSON), the card's name and power limit, and the result object.  Without
a CUDA device, or without the port package beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SOURCE = "pytorch_distributed_training_tpu_torch/csrc/decode_attention.cu"
PAGED_SOURCE = "pytorch_distributed_training_tpu_torch/csrc/paged_attention.cu"
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
SERVE_ARGV = ["--serve", "--model", "gpt2", "--precision", "bf16",
              "--seq-len", "512", "--serve-requests", "16",
              "--serve-slots", "8", "--serve-max-new", "64",
              "--serve-rate", "0"]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


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
    (atol 1e-5) and bf16 (atol 2e-2, rtol 2e-2), then timed in bf16."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    index = torch.tensor(INDEX, dtype=torch.int32, device="cuda")
    k32 = torch.randn(B, H, L, DH, generator=gen, device="cuda")
    v32 = torch.randn(B, H, L, DH, generator=gen, device="cuda")
    results = {}
    for name, c in (("decode_attention", 1), ("decode_attention_multi", 5),
                    ("decode_attention_multi", 8)):
        for dtype, atol, rtol in ((torch.float32, 1e-5, 0.0),
                                  (torch.bfloat16, 2e-2, 2e-2)):
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
            line = (f"kernel {name} C={c} {str(dtype)[6:]}: max_abs_err "
                    f"{err.max().item():.3g} (atol {atol}, rtol {rtol})")
            if dtype is torch.bfloat16 and (c == 1 or c == 5):
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
                results[name] = dict(
                    name=name, route="cuda", source=SOURCE,
                    replaces=TPU_KERNELS[name], launches=0,
                    max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=library_ms,
                )
                line += (f"; kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f}"
                         f" us, sdpa {library_ms * 1e3:.1f} us, bound "
                         f"{bms * 1e3:.2f} us ({by})")
            print(line, flush=True)
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
    and int8 timed at C = 1, 5 and 16.  ``library_ms``: SDPA on the same
    K/V already gathered into a contiguous cache (gather excluded), bf16
    only: no PyTorch call reads int8/int4 KV."""
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
            if storage in ("bf16", "int8") and c in (1, 5, 16):
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
                lib = ("null" if library_ms is None
                       else f"{library_ms * 1e3:.1f} us (gather excluded)")
                line += (f"; kernel {ms * 1e3:.1f} us, plain "
                         f"{plain_ms * 1e3:.1f} us, sdpa {lib}, bound "
                         f"{bms * 1e3:.2f} us ({by})")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from pytorch_distributed_training_tpu_torch.ops import (
            _build, decode_attention as da, paged_attention as pa,
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
    reports = _build.build()
    print(f"build: {time.monotonic() - t0:.1f} s, {len(reports)} "
          f"librar{'y' if len(reports) == 1 else 'ies'} compiled in "
          "parallel", flush=True)
    for src, rep in reports.items():
        regs = [ln.split(":", 1)[-1].strip() for ln in rep.splitlines()
                if "registers" in ln]
        spills = {ln.strip() for ln in rep.splitlines() if "spill" in ln}
        print(f"ptxas {src}: {len(regs)} kernels; {' | '.join(regs)}; "
              f"{' | '.join(sorted(spills))}", flush=True)

    kernels = kernel_phase(torch, da, args.seed, bandwidth)
    kernels.update(paged_kernel_phase(torch, pa, args.seed, bandwidth))
    parity_phase(torch, args.seed)
    _, launches = serving_phase(torch, da, args.seed)
    launches.update(paged_serving_phase(torch, da, pa, args.seed))
    for kname, n in launches.items():
        kernels[kname]["launches"] = n
    prefix_phase(torch, args.seed)
    generate_phase(torch, da, args.seed)
    print(f"total: {time.monotonic() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
