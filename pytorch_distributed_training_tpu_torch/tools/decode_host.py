#!/usr/bin/env python3
"""Host time of one call of the contiguous-cache decode wrappers, compared
across source trees on one GPU.

    python3 -m pytorch_distributed_training_tpu_torch.tools.decode_host \
        TREE [TREE ...]

Each TREE is a checkout of this repo (two ``git archive`` trees, say).
Turns run the trees forward then backward (A B B A A B B A for two), each
in a fresh process that imports that tree's own
``ops/decode_attention.py``, warms its kernels up (the first call of a
tree builds them), then times 20 blocks of 500 calls each of
``decode_attention`` (#9, C = 1) and ``decode_attention_multi`` (#10,
C = 5 and 8) at the serving shapes of ``chip_smoke.py``: B 8, H 12,
Dh 64, bf16, the engine's strided view of an L + 1 = 1025 position cache,
index [0, 5, 100, 511, 1000, 1023, 1024, 300].  No sync runs inside a
block, so the device queue stays short of full and the host never waits:
a block's time over its calls is what a serving tick pays on the host per
layer.  Prints one JSON line a process (each wrapper's median over the
blocks, in us) and a last line with each tree's median over its
processes.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

B, H, L, DH = 8, 12, 1024, 64
INDEX = [0, 5, 100, 511, 1000, 1023, 1024, 300]
BLOCKS, CALLS, TURNS = 20, 500, 2


def worker(tree: str) -> dict:
    """Time the wrappers of ``tree``'s package in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from pytorch_distributed_training_tpu_torch.ops import (
        decode_attention as da,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    ck = torch.randn(B, H, L + 1, DH, generator=gen, device="cuda").bfloat16()
    cv = torch.randn(B, H, L + 1, DH, generator=gen, device="cuda").bfloat16()
    k, v = ck[:, :, :L], cv[:, :, :L]
    index = torch.tensor(INDEX, dtype=torch.int32, device="cuda")
    calls = {}
    for c in (1, 5, 8):
        q = torch.randn(B, c, H, DH, generator=gen, device="cuda").bfloat16()
        if c == 1:
            q0 = q[:, 0]
            calls[c] = lambda q0=q0: da.decode_attention(q0, k, v, index)
        else:
            calls[c] = lambda q=q: da.decode_attention_multi(q, k, v, index)
    for fn in calls.values():  # build, load and warm up
        for _ in range(50):
            fn()
    torch.cuda.synchronize()
    times = {c: [] for c in calls}
    for _ in range(BLOCKS):
        for c, fn in calls.items():
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            times[c].append((t1 - t0) / CALLS * 1e6)
    return {
        "tree": os.path.basename(os.path.abspath(tree)),
        "source": da.__file__,
        "device": torch.cuda.get_device_name(0),
        **{f"c{c}_us": statistics.median(t) for c, t in times.items()},
    }


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--worker":
        print(json.dumps(worker(argv[1])), flush=True)
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    order = [t for _ in range(TURNS) for t in argv + argv[::-1]]
    runs = []
    for tree in order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree],
            check=True, capture_output=True, text=True,
        )
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs.append(line)
    summary = {}
    for tree in argv:
        name = os.path.basename(os.path.abspath(tree))
        mine = [r for r in runs if r["tree"] == name]
        summary[name] = {
            key: statistics.median(r[key] for r in mine)
            for key in ("c1_us", "c5_us", "c8_us")
        }
    print(json.dumps({"device": runs[0]["device"], "median_us": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
