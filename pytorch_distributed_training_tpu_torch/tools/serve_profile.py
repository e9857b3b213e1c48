#!/usr/bin/env python3
"""Where a serving run of the PyTorch port spends its time, on one GPU.

    python3 -m pytorch_distributed_training_tpu_torch.tools.serve_profile \
        [--paged] [--spec] [--rows 25]

Runs the port's ``--serve`` CLI (GPT-2 124M, bf16, 8 slots, 16 burst
requests of 2..256 prompt tokens and up to 64 new tokens — the
chip_smoke.py trace; ``--paged`` serves it from the paged KV pool) once
to warm up, then once more under ``torch.profiler``, and prints:

- the wall time of the profiled run and the device-busy share (the union
  of kernel intervals on the device timeline over that wall time);
- the operators with the most device time, and those with the most host
  time (``key_averages()``);
- one JSON line with the totals and the attention kernels' device time
  over the run, per wrapper call and per decode tick: the contiguous
  cache's ``decode_attention_kernel`` (#9/#10, the wrappers of
  ``ops/decode_attention.py``), or with ``--paged`` the paged kernels
  (``paged_attention_kernel`` and ``paged_combine_kernel``, the wrappers
  of ``ops/paged_attention.py``).

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARGV = ["--serve", "--model", "gpt2", "--precision", "bf16", "--seed", "0",
        "--seq-len", "512", "--serve-requests", "16", "--serve-slots", "8",
        "--serve-max-new", "64", "--serve-rate", "0"]


def busy_seconds(events, name: str = "") -> float:
    """Union of the intervals of the device kernels whose name holds
    ``name`` (overlaps counted once)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type.name == "CUDA" and name in e.name
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", action="store_true",
                    help="Profile the speculative (k = 4) run instead.")
    ap.add_argument("--paged", action="store_true",
                    help="Serve from the paged KV pool (--serve-paged).")
    ap.add_argument("--rows", type=int, default=25)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pytorch_distributed_training_tpu_torch.cli.main import main as cli
    from pytorch_distributed_training_tpu_torch.ops import (
        decode_attention as da, paged_attention as pa,
    )
    if args.paged:
        kernel = "paged_"
        entries = (pa.paged_decode_attention, pa.paged_decode_attention_multi,
                   pa.paged_prefill_attention)
    else:
        kernel = "decode_attention_kernel"
        entries = (da.decode_attention, da.decode_attention_multi)

    argv = ARGV + (["--serve-spec", "--serve-spec-k", "4"] if args.spec else [])
    argv += ["--serve-paged"] if args.paged else []
    cli(argv)  # warm-up: CUDA context, cuBLAS, kernel build and load
    torch.cuda.synchronize()
    for e in entries:
        e.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = cli(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    avg = prof.key_averages()
    print(avg.table(sort_by="self_cuda_time_total", row_limit=args.rows))
    print(avg.table(sort_by="self_cpu_time_total", row_limit=args.rows))
    events = prof.events()
    busy_s = busy_seconds(events)
    attn_s = busy_seconds(events, kernel)
    calls = sum(e.launches for e in entries)
    ticks = res["engine"]["decode_ticks"]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "spec": args.spec,
        "paged": args.paged,
        "wall_s": wall_s, "device_busy_s": busy_s,
        "device_busy_share": busy_s / wall_s,
        "decode_ticks": ticks,
        "goodput_tok_per_s": res["summary"]["goodput_tok_per_s"],
        "attention_kernel": kernel,
        "attention_kernel_ms": attn_s * 1e3,
        "attention_calls": calls,
        "attention_kernel_us_per_call": (attn_s * 1e6 / calls
                                         if calls else None),
        "attention_kernel_ms_per_decode_tick": (attn_s * 1e3 / ticks
                                                if ticks else None),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
