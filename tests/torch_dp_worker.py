"""Worker processes for the PyTorch port's data-parallel tests.

``launch(argv, n)`` starts ``n`` copies of ``python argv...`` with the
torchrun env contract (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
``RANK``/``LOCAL_RANK``), waits for them within one timeout and kills every
survivor on any failure, so a rank that dies never leaves the others
blocked in a collective.

Run as a script, this file is one rank of a gloo group on the CPU:

    python tests/torch_dp_worker.py syncbn OUT     # BN functions, modules
    python tests/torch_dp_worker.py collectives OUT
    python tests/torch_dp_worker.py restore_error OUT  # rank 0's walk fails
    python tests/torch_dp_worker.py cache_rows OUT  # --device-cache rows

Each rank writes ``OUT/rank<r>.npz``; the tests compare them with the
one-process results on the concatenated batch.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(argv: list[str], n: int = 2, *,
           timeout: float = 100.0) -> list[str]:
    """Run ``n`` ranks of ``python argv`` within ``timeout`` seconds in
    all; returns their stdouts."""
    deadline = time.monotonic() + timeout
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    try:
        for rank in range(n):
            rank_env = dict(os.environ, MASTER_ADDR="localhost",
                            MASTER_PORT=str(port), WORLD_SIZE=str(n),
                            RANK=str(rank), LOCAL_RANK=str(rank),
                            OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, *argv], cwd=REPO, env=rank_env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        for p in procs:
            out, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(out)
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# --- the rank side ----------------------------------------------------------

BN_SHAPE = (8, 7, 5, 5)       # NCHW, the batch split over the ranks
MODULES = ("FusedBNRelu", "FusedBN", "FusedBNAddRelu", "BatchNorm")
FUNCTIONS = ("batch_norm", "bn_relu", "bn_add_relu")


def bn_inputs(seed: int = 0):
    """x, r, dy (global, NCHW) and gamma, beta."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(BN_SHAPE) * 2 + 0.5).astype(np.float32)
    r = rng.standard_normal(BN_SHAPE).astype(np.float32)
    dy = rng.standard_normal(BN_SHAPE).astype(np.float32)
    c = BN_SHAPE[1]
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    gamma[1] = -0.7
    beta = rng.standard_normal(c).astype(np.float32)
    return x, r, dy, gamma, beta


def bn_case(name: str, x, r, dy, gamma, beta, group=None, scale=1.0):
    """One function or module, train mode, on (x, r): returns the outputs,
    statistics and grads (dy times ``scale`` as the cotangent) as numpy."""
    import torch

    from pytorch_distributed_training_tpu_torch.ops import fused_norm as fn

    xt = torch.from_numpy(x).requires_grad_()
    rt = torch.from_numpy(r).requires_grad_()
    g = torch.from_numpy(gamma).requires_grad_()
    b = torch.from_numpy(beta).requires_grad_()
    if name in FUNCTIONS:
        args = (xt, rt) if name == "bn_add_relu" else (xt,)
        y, mean, var = getattr(fn, name)(*args, g, b, group=group)
        stats = [mean, var]
    else:
        m = getattr(fn, name)(x.shape[1])
        new_stats: dict = {}
        args = (xt, rt) if name == "FusedBNAddRelu" else (xt,)
        y = torch.func.functional_call(
            m, {"scale": g, "bias": b}, args,
            {"new_stats": new_stats, "group": group})
        stats = [new_stats["mean"], new_stats["var"]]
    grads = torch.autograd.grad(y, (xt, g, b), torch.from_numpy(dy) * scale)
    return {"y": y.detach().numpy(), "mean": stats[0].detach().numpy(),
            "var": stats[1].detach().numpy(), "dx": grads[0].numpy(),
            "dgamma": grads[1].numpy(), "dbeta": grads[2].numpy()}


def _syncbn(rank: int, world: int, group) -> dict:
    """Every case on this rank's rows, the cotangent ``world`` times the
    global one (each rank differentiates its own mean loss)."""
    x, r, dy, gamma, beta = bn_inputs()
    rows = slice(rank * len(x) // world, (rank + 1) * len(x) // world)
    res = {}
    for name in FUNCTIONS + MODULES:
        got = bn_case(name, x[rows], r[rows], dy[rows], gamma, beta, group,
                      scale=float(world))
        res.update({f"{name}/{k}": v for k, v in got.items()})
    return res


def _collectives(rank: int, world: int, group) -> dict:
    import torch

    from pytorch_distributed_training_tpu_torch.comm import collectives

    a = torch.full((3, 2), float(rank + 1))
    b = torch.arange(4, dtype=torch.float64) * (rank + 1)
    mean_list = collectives.pmean([a, b], group)
    mean_one = collectives.pmean(torch.tensor([2.0 * rank]), group)
    bcast = [torch.full((5,), float(rank)), torch.full((2,), rank,
                                                       dtype=torch.int64)]
    collectives.broadcast(bcast, group)
    x = torch.tensor([1.0, 2.0]) * (rank + 1)
    x.requires_grad_()
    y = collectives.all_reduce_sum(x, group)
    (dx,) = torch.autograd.grad((y * (rank + 1)).sum(), x)
    collectives.barrier(group)
    return {"mean_a": mean_list[0].numpy(), "mean_b": mean_list[1].numpy(),
            "mean_b_dtype": np.array(str(mean_list[1].dtype)),
            "mean_one": mean_one.numpy(), "bcast_f": bcast[0].numpy(),
            "bcast_i": bcast[1].numpy(), "sum": y.detach().numpy(),
            "dsum": dx.numpy()}


def _restore_error(rank: int, world: int, group, out: str) -> dict:
    """A restore whose rank-0 walk fails outside the per-step checks (the
    directory cannot be listed): every rank must raise, none may wait in
    the outcome's broadcast.  Returns each rank's exception."""
    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from pytorch_distributed_training_tpu_torch.comm import collectives

    def unreadable():
        raise PermissionError("the checkpoint directory cannot be listed")

    mgr = CheckpointManager(os.path.join(out, "ckpt"), process_group=group)
    if rank == 0:
        mgr.all_steps = unreadable
    try:
        mgr.restore_latest(None)     # the template: never reached
        got = {"type": np.array("none"), "msg": np.array("")}
    except Exception as e:   # the outcome under test
        got = {"type": np.array(type(e).__name__), "msg": np.array(str(e))}
    # Rank 0 leaves the group only once rank 1 has taken the outcome off
    # the wire.
    collectives.barrier(group)
    return got


CACHE_ACCUM = 2    # microbatches of the cache_rows batches


def cache_rows(rank, world, group):
    """The CLI's device caches (``--device-cache``: synthetic images
    cropped from 10 to 8 px; a token stream) under this rank and world:
    this rank's rows of three global batches of two epochs, stacked."""
    import types

    from pytorch_distributed_training_tpu_torch.cli.main import (
        _device_cache, build_parser,
    )
    from pytorch_distributed_training_tpu_torch.data import SyntheticImages

    args = build_parser().parse_args([
        "--device-cache", "--image-size", "8", "--seq-len", "8",
        "--accum-steps", str(CACHE_ACCUM), "--seed", "4"])
    images = _device_cache(args, SyntheticImages(n=24, image_size=10),
                           "image_classifier", "cpu", rank, world)
    batches = [b for epoch in range(2) for b in images.batches(epoch, 8)]
    stream = types.SimpleNamespace(tokens=np.arange(500) % 301)
    tokens = _device_cache(args, stream, "lm", "cpu", rank, world)
    windows = [b["tokens"] for b in tokens.batches(1, 8, steps=3)]
    return {"image": np.stack([b["image"].numpy() for b in batches]),
            "label": np.stack([b["label"].numpy() for b in batches]),
            "tokens": np.stack([w.numpy() for w in windows])}


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    from pytorch_distributed_training_tpu_torch.comm import init as comm_init

    torch.set_num_threads(1)
    task, out = sys.argv[1], sys.argv[2]
    group = comm_init.initialize("cpu")
    try:
        rank, world = comm_init.process_index(), comm_init.process_count()
        tasks = {"syncbn": _syncbn, "collectives": _collectives,
                 "restore_error": lambda *a: _restore_error(*a, out),
                 "cache_rows": cache_rows}
        res = tasks[task](rank, world, group)
        os.makedirs(out, exist_ok=True)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        comm_init.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
