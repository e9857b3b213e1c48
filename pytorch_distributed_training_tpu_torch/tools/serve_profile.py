#!/usr/bin/env python3
"""Where a serving run of the PyTorch port spends its time, on one GPU.

    python3 -m pytorch_distributed_training_tpu_torch.tools.serve_profile \
        [--paged] [--spec] [--eager] [--rows 25]

Runs the port's ``--serve`` CLI (GPT-2 124M, bf16, 8 slots, 16 burst
requests of 2..256 prompt tokens and up to 64 new tokens — the
chip_smoke.py trace; ``--paged`` serves it from the paged KV pool) once
to warm up, then once more under ``torch.profiler``, and prints what it
measured.  The engines replay their programs as CUDA graphs, captured
when the CLI builds them; ``--eager`` builds them with
``cuda_graphs=False``.  The profiler starts at the scheduler's first
tick, so the window holds the serving and not the engines' construction
(warm-up and capture), and it prints:

- the wall time of the profiled run and the device-busy share (the union
  of the device's kernel, copy and memset intervals over that wall time;
  the ``record_function`` ranges the profiler mirrors on the device
  timeline are not work and are left out);
- the scheduler's ticks, the wall time a tick, TPOT p50, the device
  kernels a tick and the host's launch calls a tick (kernel launches
  and graph launches), and the engines' capture seconds and graph pool
  bytes;
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
import contextlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARGV = ["--serve", "--model", "gpt2", "--precision", "bf16", "--seed", "0",
        "--seq-len", "512", "--serve-requests", "16", "--serve-slots", "8",
        "--serve-max-new", "64", "--serve-rate", "0"]


def device_work(e) -> bool:
    """Whether a profiler event is work on the card: its kernels, copies
    and memsets, not a ``record_function`` range mirrored on the device
    timeline (the engine's tick spans are such ranges)."""
    return (e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False))


def busy_seconds(events, name: str = "") -> float:
    """Union of the intervals of the device work (``device_work``) whose
    name holds ``name`` (overlaps counted once)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if device_work(e) and name in e.name
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


# The host's launch calls as the profiler names them: a kernel each, or a
# whole graph.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")


@contextlib.contextmanager
def engines_built(graphs: bool):
    """While the CLI serves: every ``ServingEngine`` it builds, with
    ``cuda_graphs=graphs``, into the list this yields."""
    from pytorch_distributed_training_tpu_torch.serve import engine

    built, init = [], engine.ServingEngine.__init__

    def kept(self, *a, **kw):
        init(self, *a, **{**kw, "cuda_graphs": graphs})
        built.append(self)

    engine.ServingEngine.__init__ = kept
    try:
        yield built
    finally:
        engine.ServingEngine.__init__ = init


@contextlib.contextmanager
def from_first_tick(prof, clock: dict):
    """Starts ``prof`` at the scheduler's first tick and stamps it in
    ``clock["t0"]``."""
    from pytorch_distributed_training_tpu_torch.serve import scheduler

    tick = scheduler.ContinuousScheduler.tick

    def first(self):
        if "t0" not in clock:
            prof.start()
            clock["t0"] = time.perf_counter()
        return tick(self)

    scheduler.ContinuousScheduler.tick = first
    try:
        yield
    finally:
        scheduler.ContinuousScheduler.tick = tick


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", action="store_true",
                    help="Profile the speculative (k = 4) run instead.")
    ap.add_argument("--paged", action="store_true",
                    help="Serve from the paged KV pool (--serve-paged).")
    ap.add_argument("--eager", action="store_true",
                    help="Build the engines with cuda_graphs=False.")
    ap.add_argument("--rows", type=int, default=25)
    args = ap.parse_args(argv)
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
    graphs = not args.eager
    with engines_built(graphs):
        cli(argv)  # warm-up: CUDA context, cuBLAS, kernel build and load
    torch.cuda.synchronize()
    for e in entries:
        e.launches = 0
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    clock: dict = {}
    with engines_built(graphs) as built, from_first_tick(prof, clock):
        res = cli(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - clock["t0"]
    prof.stop()
    avg = prof.key_averages()
    print(avg.table(sort_by="self_cuda_time_total", row_limit=args.rows))
    print(avg.table(sort_by="self_cpu_time_total", row_limit=args.rows))
    events = prof.events()
    busy_s = busy_seconds(events)
    attn_s = busy_seconds(events, kernel)
    calls = sum(e.launches for e in entries)
    ticks = res["engine"]["decode_ticks"]
    sched_ticks = res["ticks"]
    kernels = sum(device_work(e) and not e.name.startswith(("Memcpy",
                                                            "Memset"))
                  for e in events)
    launch_calls = sum(e.name in LAUNCH_CALLS for e in events)
    stats = [e.program_stats() for e in built]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "spec": args.spec,
        "paged": args.paged, "cuda_graphs": graphs,
        "wall_s": wall_s, "device_busy_s": busy_s,
        "device_busy_share": busy_s / wall_s,
        "ticks": sched_ticks, "tick_ms": wall_s * 1e3 / sched_ticks,
        "tpot_p50_s": res["summary"]["tpot_p50_s"],
        "kernels_per_tick": kernels / sched_ticks,
        "launch_calls_per_tick": launch_calls / sched_ticks,
        "graph_launches": sum(e.name == "cudaGraphLaunch" for e in events),
        "capture_s": {name: p["capture_s"] for st in stats
                      for name, p in st["programs"].items()},
        "graph_pool_bytes": [st["graph_pool_bytes"] for st in stats],
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
