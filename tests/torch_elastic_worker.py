"""The rank side of ``tests/test_torch_elastic.py``: 4 gloo ranks on the
CPU (2 slices x 2), launched by ``tests/torch_dp_worker.launch``.
Imports the port only, never JAX.  Rank 0 writes ``OUT/<task>.json``.

``episodes``: the three episodes of JAX's ``tests/test_elastic.py`` —
``slice_lost@4:1,slice_return@9`` (12 steps, rank 0's emitter writing
``OUT/metrics``), ``slice_lost@4:0,slice_return@9`` (12 steps, rank 0's
own slice lost) and ``host_hang@2:2`` (6 steps) — each report, the
snapshot's leaves (path, kind, dtype, bytes) and the blob's length;
then an uninterrupted 12-step run of the same global batches on the
same ranks, and the relative L2 distance of its final parameters from
the first episode's; then the grow's transfer over the group of ranks
1-3 from its rank 1 (global rank 2), each rank's leaves after it.

``again``: the first episode once more, without an emitter (the
run-twice determinism pin, from other processes).
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAULTS_1 = "slice_lost@4:1,slice_return@9"
FAULTS_0 = "slice_lost@4:0,slice_return@9"
HANG = "host_hang@2:2"
STEPS, HANG_STEPS = 12, 6


def _uninterrupted(torch, group, rank: int, world: int, n_steps: int):
    """JAX's episode model trained ``n_steps`` steps of the episode's
    global batches at the full world, accumulation 2."""
    from pytorch_distributed_training_tpu_torch.resilience import elastic
    from pytorch_distributed_training_tpu_torch.train import (
        Policy, make_train_step,
    )

    cfg = elastic.tiny_gpt2_config(16)
    state = elastic.episode_state(cfg, Policy(), 0, torch.device("cpu"),
                                  group)
    step = make_train_step(kind="lm", num_microbatches=2,
                           process_group=group)
    for g in range(n_steps):
        rows = elastic.episode_rows(g, seed=0, global_batch=16, seq_len=16,
                                    vocab=cfg.vocab_size, rank=rank,
                                    world=world, accum=2)
        state, _ = step(state, {"tokens": torch.from_numpy(rows)})
    return state


def _rel_l2(torch, a: dict, b: dict) -> float:
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return (num / den) ** 0.5


def _subgroup_grow(torch, rank: int, group) -> list:
    """Each rank's leaves after the grow's transfer over the group of
    global ranks 1-3, whose rank 1 (global rank 2) is the source: a
    tensor and a Python int, both first rank-valued (rank 0 keeps its
    own)."""
    from pytorch_distributed_training_tpu_torch.comm import collectives
    from pytorch_distributed_training_tpu_torch.resilience import elastic

    sub = collectives.new_group([1, 2, 3])   # every rank enters new_group
    leaves = [("w", torch.full((3,), float(rank))), ("count", 10 * rank)]
    if rank != 0:
        leaves = elastic._broadcast_leaves(leaves, sub, 1)
    return elastic._gather_ints(
        [int(v) for v in leaves[0][1].tolist()] + [leaves[1][1]], group)


def _episodes(torch, out: str, rank: int, world: int, group) -> dict:
    from pytorch_distributed_training_tpu_torch.obs import MetricsEmitter
    from pytorch_distributed_training_tpu_torch.resilience import (
        elastic, run_elastic_episode,
    )

    emitter = (MetricsEmitter(os.path.join(out, "metrics"), rank=0, world=1)
               if rank == 0 else None)
    profile: dict = {}
    first = run_elastic_episode(faults=FAULTS_1, n_steps=STEPS,
                                emitter=emitter, device="cpu",
                                profile=profile)
    if emitter is not None:
        emitter.summary()
        emitter.close()
    state = profile["state"]
    leaves, _ = elastic._state_leaves(state)
    specs = elastic._specs(leaves)
    ref = _uninterrupted(torch, group, rank, world, STEPS)
    rel = _rel_l2(torch, {k: v.detach() for k, v in state.params.items()},
                  {k: v.detach() for k, v in ref.params.items()})
    return {
        "slice1": first,
        "slice0": run_elastic_episode(faults=FAULTS_0, n_steps=STEPS,
                                      device="cpu"),
        "hang": run_elastic_episode(faults=HANG, n_steps=HANG_STEPS,
                                    device="cpu"),
        "leaves": [[p, kind, str(dtype).removeprefix("torch."), list(shape)]
                   for p, kind, dtype, shape in specs],
        "blob_len": sum(elastic._nbytes(s) for s in specs),
        "params_rel_l2": rel,
        "losses": [s["loss"] for s in profile["steps"]],
        "subgroup_grow": _subgroup_grow(torch, rank, group),
    }


def _again(torch, out: str, rank: int, world: int, group) -> dict:
    from pytorch_distributed_training_tpu_torch.resilience import (
        run_elastic_episode,
    )

    return {"slice1": run_elastic_episode(faults=FAULTS_1, n_steps=STEPS,
                                          device="cpu")}


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    from pytorch_distributed_training_tpu_torch.comm import init as comm_init

    torch.set_num_threads(1)
    task, out = sys.argv[1], sys.argv[2]
    group = comm_init.initialize("cpu")
    try:
        rank, world = comm_init.process_index(), comm_init.process_count()
        res = {"episodes": _episodes, "again": _again}[task](
            torch, out, rank, world, group)
        if rank == 0:
            with open(os.path.join(out, f"{task}.json"), "w") as f:
                json.dump(res, f)
    finally:
        comm_init.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
