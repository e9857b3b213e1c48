#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from the sources in this checkout (nvcc,
into build/torch_kernels/), holds each kernel against its plain PyTorch
version at the serving shapes and times both, then drives the port's main
path — the ``--serve`` CLI serving GPT-2 124M (bf16, fresh weights from
the seed) with and without speculative decoding — and checks that every
request completed and that the decode-attention kernels carried the
decode and verify ticks.  Lockstep ``generate`` runs at full width too,
and a small f32 model's slot-mode logits on the card are checked against
the same model on the host.

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
TPU_KERNELS = {
    "decode_attention":
        "pytorch_distributed_training_tpu/ops/pallas_attention.py:1221",
    "decode_attention_multi":
        "pytorch_distributed_training_tpu/ops/pallas_attention.py:1295",
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

    argv = ["--serve", "--model", "gpt2", "--precision", "bf16", "--seed",
            str(seed), "--seq-len", "512", "--serve-requests", "16",
            "--serve-slots", "8", "--serve-max-new", "64", "--serve-rate", "0"]
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
    decode tick and a verify chunk, atol 1e-3."""
    from pytorch_distributed_training_tpu_torch.models import gpt2_124m

    torch.backends.cuda.matmul.allow_tf32 = False
    small = dict(num_layers=2, hidden_dim=64, num_heads=2, vocab_size=256,
                 max_seq_len=64)
    host = gpt2_124m(small, device="cpu", seed=seed).eval()
    card = gpt2_124m(small, device="cpu", seed=seed).to("cuda").eval()
    caches = host.new_cache(3, 48), card.new_cache(3, 48)
    rng = torch.Generator().manual_seed(seed)
    worst = 0.0
    with torch.no_grad():
        for width, pos in ((12, [0, 5, 48]), (1, [12, 17, 48]),
                           (5, [13, 18, 48])):
            tok = torch.randint(0, 256, (3, width), generator=rng)
            p = torch.tensor(pos, dtype=torch.int32)
            ref = host(tok, cache=caches[0], positions=p)
            out = card(tok.cuda(), cache=caches[1], positions=p.cuda())
            err = (out.cpu() - ref)[:2].abs().max().item()
            worst = max(worst, err)
            check(err <= 1e-3, f"parity width {width}: max err {err:.3g}")
    print(f"parity: small f32 model, card vs host slot-mode logits max err "
          f"{worst:.3g} (atol 1e-3)", flush=True)


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
            _build, decode_attention as da,
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
    regs = [ln.strip() for rep in reports.values() for ln in rep.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"build: {time.monotonic() - t0:.1f} s, {len(reports)} "
          f"librar{'y' if len(reports) == 1 else 'ies'} compiled; "
          f"ptxas: {' | '.join(regs[:4])}", flush=True)

    kernels = kernel_phase(torch, da, args.seed, bandwidth)
    parity_phase(torch, args.seed)
    _, launches = serving_phase(torch, da, args.seed)
    for kname, n in launches.items():
        kernels[kname]["launches"] = n
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
