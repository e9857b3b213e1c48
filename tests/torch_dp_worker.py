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
    python tests/torch_dp_worker.py collectives4 OUT  # gather, scatter, ...
    python tests/torch_dp_worker.py slices OUT      # split_slice_groups
    python tests/torch_dp_worker.py bucket_sync OUT  # GradSync._sync_buckets
    python tests/torch_dp_worker.py grad_sync_steps OUT  # --grad-sync steps
    python tests/torch_dp_worker.py sharded OUT     # FSDP/TP/ZeRO-1/SP (4)
    python tests/torch_dp_worker.py sharded2 OUT    # the same at 2, ckpts
    python tests/torch_dp_worker.py sp_attention OUT  # ring, Ulysses

Each rank writes ``OUT/rank<r>.npz``; the tests compare them with the
one-process results on the concatenated batch.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(argv: list[str], n: int = 2, *,
           timeout: float = 100.0) -> list[str]:
    """Run ``n`` ranks of ``python argv`` within ``timeout`` seconds in
    all; returns their stdouts."""
    return launch_start(argv, n, timeout=timeout).wait()


class Launched:
    """``n`` ranks started by ``launch_start``, each writing its stdout
    and stderr to a temporary file (no pipe fills while the caller
    computes); ``wait()`` collects them (every rank killed on a failure
    or at the deadline)."""

    def __init__(self, procs: list, files: list, deadline: float):
        self.procs, self.files, self.deadline = procs, files, deadline

    def wait(self) -> list[str]:
        try:
            outs = []
            for p, (fo, fe) in zip(self.procs, self.files):
                p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
                out, err = (_read(f) for f in (fo, fe))
                assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
                outs.append(out)
            return outs
        finally:
            self.kill()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in (f for pair in self.files for f in pair):
            f.close()


def _read(f) -> str:
    f.seek(0)
    return f.read().decode(errors="replace")


def launch_start(argv: list[str], n: int = 2, *,
                 timeout: float = 100.0) -> Launched:
    """Start ``n`` ranks of ``python argv`` (``launch`` without the
    wait), so the caller can compute meanwhile; ``timeout`` counts from
    now."""
    deadline = time.monotonic() + timeout
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs, files = [], []
    try:
        for rank in range(n):
            rank_env = dict(os.environ, MASTER_ADDR="localhost",
                            MASTER_PORT=str(port), WORLD_SIZE=str(n),
                            RANK=str(rank), LOCAL_RANK=str(rank),
                            OMP_NUM_THREADS="1")
            files.append((tempfile.TemporaryFile(),
                          tempfile.TemporaryFile()))
            procs.append(subprocess.Popen(
                [sys.executable, *argv], cwd=REPO, env=rank_env,
                stdout=files[-1][0], stderr=files[-1][1]))
    except BaseException:
        Launched(procs, files, deadline).kill()
        raise
    return Launched(procs, files, deadline)


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


# --- the two-tier sync (tests/test_torch_grad_sync.py) -----------------------

WIRE_DTYPES = ("float32", "bfloat16", "uint8")


def collective_input(rank: int, dtype: str, shape=(4, 6)) -> np.ndarray:
    """Rank ``rank``'s input of the collectives family: small integers,
    exact in every dtype and in any order of summation."""
    rng = np.random.default_rng(100 + rank)
    return rng.integers(0, 9, shape).astype(np.float32)


def _collectives4(rank: int, world: int, group) -> dict:
    import torch

    from pytorch_distributed_training_tpu_torch.comm import collectives as c

    res = {}
    ring = [(i, (i + 1) % world) for i in range(world)]
    for name in WIRE_DTYPES:
        dt = getattr(torch, name)
        x = torch.from_numpy(collective_input(rank, name)).to(dt)
        outs = {
            "ag0": c.all_gather(x, group),
            "ag1": c.all_gather(x, group, gather_axis=1),
            "ag_stack": c.all_gather(x, group, gather_axis=1, tiled=False),
            "rs0": c.reduce_scatter(x, group),
            "rs1": c.reduce_scatter(x.repeat(1, 2)[:, :8], group,
                                    scatter_axis=1),
            "perm_ring": c.ppermute(x, group, ring),
            "perm_part": c.ppermute(x, group, [(0, 2), (3, 3)]),
            "a2a": c.all_to_all(x, group, split_axis=0, concat_axis=1),
            "ag_async": c.all_gather(x, group, async_op=True).wait(),
        }
        for k, v in outs.items():
            res[f"{name}/{k}"] = v.float().numpy()
    bits = torch.from_numpy(collective_input(rank, "int16")).to(
        torch.bfloat16).view(torch.int16)
    res["int16/ag0"] = c.all_gather(bits, group).view(
        torch.bfloat16).float().numpy()
    c.barrier(group)
    return res


SLICE_SHAPES = ((2, 2), (4, 1), (1, 4))


def _slices(rank: int, world: int, group) -> dict:
    import torch
    import torch.distributed as dist

    from pytorch_distributed_training_tpu_torch.comm import (
        GradSync, GradSyncConfig, collectives, split_slice_groups,
    )

    res = {}
    for s, l in SLICE_SHAPES:
        g = split_slice_groups(group, s)
        x = torch.tensor([float(rank)])
        res[f"{s}x{l}"] = np.array([
            g.n_slices, g.ici_size, g.slice_index, g.lane,
            collectives.psum(x.clone(), g.ici).item(),
            collectives.psum(x.clone(), g.dcn).item()])
        res[f"{s}x{l}/ici"] = np.array(dist.get_process_group_ranks(g.ici))
        res[f"{s}x{l}/dcn"] = np.array(dist.get_process_group_ranks(g.dcn))
    try:
        split_slice_groups(group, 3)
        res["indivisible"] = np.array("")
    except ValueError as e:
        res["indivisible"] = np.array(str(e))
    singles = [collectives.new_group([r]) for r in range(world)]
    try:
        GradSync(singles[rank], {"w": torch.zeros(8)},
                 GradSyncConfig(mode="hier"))
        res["trivial"] = np.array("")
    except ValueError as e:
        res["trivial"] = np.array(str(e))
    collectives.barrier(group)
    return res


# The bucket-sync family: a layout of 3 buckets of 1024 elements (4 ranks
# x the top-k bitmap's 8) over a 3000-element parameter.
SYNC_TOTAL, SYNC_BUCKET_MB = 3000, 1000 * 4 / (1 << 20)
SYNC_MODES = ("hier", "hier-bf16", "hier-int8", "hier-int4", "hier-topk")
SYNC_VARIANTS = (("off", False), ("off", True), (2, False), (2, True))


def sync_inputs(rank: int, n_buckets: int, elems: int, shard: int):
    """Rank ``rank``'s local bucket sums and residual row (seeded)."""
    rng = np.random.default_rng(1000 + rank)
    buckets = rng.standard_normal((n_buckets, elems)).astype(np.float32)
    resid = (rng.standard_normal((n_buckets, shard)) * 1e-2).astype(
        np.float32)
    return buckets, resid


def _bucket_sync(rank: int, world: int, group) -> dict:
    import torch

    from pytorch_distributed_training_tpu_torch.comm import (
        GradSync, GradSyncConfig, collectives,
    )

    res = {}
    for mode in SYNC_MODES:
        for stripe, overlap in SYNC_VARIANTS:
            sync = GradSync(group, {"w": torch.zeros(SYNC_TOTAL)},
                            GradSyncConfig(mode=mode, n_slices=2,
                                           bucket_mb=SYNC_BUCKET_MB,
                                           stripe=stripe,
                                           phase_overlap=overlap))
            lay = sync.layout
            b, r = sync_inputs(rank, lay.n_buckets, lay.bucket_elems,
                               lay.bucket_elems // sync.ici_size)
            out, resid = sync._sync_buckets(
                torch.from_numpy(b),
                torch.from_numpy(r) if sync.has_residual else ())
            key = f"{mode}/{stripe}/{int(overlap)}"
            res[key] = out.numpy()
            if sync.has_residual:
                res[key + "/resid"] = resid.numpy()
            res[key + "/layout"] = np.array(
                [lay.n_buckets, lay.bucket_elems, sync.stripe])
    collectives.barrier(group)
    return res


# The steps family: tools/grad_sync_diag.py's tiny GPT-2 (JAX's weights
# from the test, OUT/init.npz), adam 1e-3, bucket_mb 0.002, 2 slices.
TINY_LM = dict(vocab_size=128, max_seq_len=16, num_layers=2, num_heads=2,
               hidden_dim=32)
STEP_RUNS = (  # (label, mode, accum, steps, zero the residual after step 1)
    ("flat", "flat", 1, 1, False),
    ("hier", "hier", 1, 1, False),
    ("hier-bf16", "hier-bf16", 1, 1, False),
    ("hier-int8", "hier-int8", 1, 1, False),
    ("hier-int4", "hier-int4", 1, 1, False),
    ("hier-topk", "hier-topk", 1, 1, False),
    ("hier-accum4", "hier", 4, 2, False),
    ("hier-int8-2", "hier-int8", 1, 2, False),
    ("hier-int8-2z", "hier-int8", 1, 2, True),
    ("hier-int4-2", "hier-int4", 1, 2, False),
    ("hier-int4-2z", "hier-int4", 1, 2, True),
    ("hier-topk-2", "hier-topk", 1, 2, False),
    ("hier-topk-2z", "hier-topk", 1, 2, True),
)


def lm_tokens(accum: int) -> np.ndarray:
    """``tiny_lm_setup``'s batch: 8 x max(accum, 2) rows of 16 tokens."""
    rows = 8 * max(accum, 2)
    return np.random.default_rng(7).integers(0, 128, (rows, 16), np.int32)


def _tiny_state(group, init: dict, mode: str):
    import dataclasses

    import torch

    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer,
    )
    from pytorch_distributed_training_tpu_torch.comm import (
        GradSync, GradSyncConfig,
    )
    from pytorch_distributed_training_tpu_torch.models import (
        GPT2, GPT2Config,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state,
    )

    model = GPT2(GPT2Config(**TINY_LM))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    state = create_train_state(model, build_optimizer(
        "adam", 1e-3, weight_decay=0.0), process_group=group)
    sync = None
    if mode != "flat":
        sync = GradSync(group, state.params, GradSyncConfig(
            mode=mode, n_slices=2, bucket_mb=0.002))
        assert sync.layout.n_buckets > 1
        state = dataclasses.replace(state,
                                    grad_sync_residual=sync.init_residual())
    return state, sync


def _grad_sync_steps(rank: int, world: int, group, out: str) -> dict:
    import dataclasses

    import torch

    from pytorch_distributed_training_tpu_torch.comm import collectives
    from pytorch_distributed_training_tpu_torch.train import make_train_step

    init = dict(np.load(os.path.join(out, "init.npz")))
    res = {}
    for label, mode, accum, steps, zero in STEP_RUNS:
        state, sync = _tiny_state(group, init, mode)
        step = make_train_step(kind="lm", num_microbatches=accum,
                               process_group=group, grad_sync=sync)
        tokens = lm_tokens(accum)
        per = len(tokens) // world
        local = {"tokens": torch.from_numpy(
            tokens[rank * per:(rank + 1) * per]).long()}
        for i in range(steps):
            state, metrics = step(state, local)
            if i == 0 and sync is not None and sync.has_residual:
                res[f"{label}/resid1"] = state.grad_sync_residual.numpy()
            if zero and i == 0:
                state = dataclasses.replace(
                    state, grad_sync_residual=torch.zeros_like(
                        state.grad_sync_residual))
        res[f"{label}/loss"] = np.array(float(metrics["loss"]))
        for k, v in state.params.items():
            res[f"{label}/p/{k}"] = v.detach().numpy()
    res.update(_residual_resilience(rank, world, group, out))
    collectives.barrier(group)
    return res


def _residual_resilience(rank: int, world: int, group, out: str) -> dict:
    """The residual under the skip gate, a rollback and a checkpoint: a
    shallow ResNet (float images, so ``nan_batch`` poisons the loss)
    under hier-int8 over 2 slices."""
    import dataclasses

    import torch

    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from pytorch_distributed_training_tpu_torch.comm import (
        GradSync, GradSyncConfig,
    )
    from pytorch_distributed_training_tpu_torch.resilience import (
        AnomalyPolicy, RecoveryConfig, RecoveryManager,
        init_resilience_state,
    )
    from pytorch_distributed_training_tpu_torch.resilience.faults import (
        corrupt_batch,
    )
    from pytorch_distributed_training_tpu_torch.tools import dp_check
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_train_step,
    )

    def fresh():
        model = dp_check.build_model("resnet", "cpu", seed=0, filters=4)
        state = create_train_state(model, dp_check.optimizer("resnet"),
                                   process_group=group)
        sync = GradSync(group, state.params, GradSyncConfig(
            mode="hier-int8", n_slices=2, bucket_mb=0.002))
        return dataclasses.replace(
            state, grad_sync_residual=sync.init_residual(),
            resilience=init_resilience_state("cpu")), sync

    state, sync = fresh()
    step = make_train_step(kind="image_classifier", process_group=group,
                           grad_sync=sync, anomaly_policy=AnomalyPolicy())
    batches = dp_check.global_batches("resnet", 3, 8, 16, 5)
    rows = slice(rank * 2, rank * 2 + 2)
    local = [{k: torch.from_numpy(v[rows]) for k, v in b.items()}
             for b in batches]
    res = {}
    state, _ = step(state, local[0])
    res["gate/before"] = state.grad_sync_residual.clone().numpy()
    state, m = step(state, corrupt_batch(local[1], "nan"))
    res["gate/skipped"] = np.array(int(m["skipped"]))
    res["gate/after"] = state.grad_sync_residual.numpy()
    recovery = RecoveryManager(RecoveryConfig(rollback_after=1))
    recovery.stage(state, 2)
    res["rollback/staged"] = state.grad_sync_residual.clone().numpy()
    state, _ = step(state, local[2])
    res["rollback/moved"] = state.grad_sync_residual.clone().numpy()
    state = recovery.observe(state, 3, bad_streak=1)
    res["rollback/restored"] = state.grad_sync_residual.numpy()
    ckpt = os.path.join(out, "ckpt")
    mgr = CheckpointManager(ckpt, process_group=group)
    mgr.save(state, wait=True)
    mgr.close()
    template, _ = fresh()
    restored = CheckpointManager(ckpt, process_group=group).restore_latest(
        template)
    res["ckpt/restored"] = restored.grad_sync_residual.numpy()
    res["ckpt/names"] = np.array(sorted(
        CheckpointManager(ckpt).load_tensors(restored.step)))
    return res


# --- sharded training (tests/test_torch_parallel.py) -------------------------

TINY4 = dict(vocab_size=128, max_seq_len=32, num_layers=2, num_heads=4,
             hidden_dim=64)
SHARD_SEQ, SHARD_BATCH, SHARD_STEPS, SHARD_ACCUM, SHARD_LR = 32, 8, 2, 2, 3e-4
CLIP = 1e-3   # fires at the tiny model's gradient norm (~1)
# label -> (mesh sizes, options).  "min1": the rules at min_fsdp_size 1,
# as JAX's own FSDP and ZeRO-1 tests set them, so the tiny leaves shard.
SHARDED_CASES = {
    "fsdp4": (dict(fsdp=4), dict(min1=True)),
    "data2_fsdp2": (dict(fsdp=2), dict(min1=True)),
    "tp2": (dict(tensor=2), {}),
    "tp4": (dict(tensor=4), {}),
    "fsdp2_tp2": (dict(fsdp=2, tensor=2), dict(min1=True)),
    "zero1": (dict(), dict(zero1=True, min1=True)),
    "zero1_hier": (dict(), dict(zero1=True, min1=True, sync="hier")),
    "zero1_hier_int8": (dict(), dict(zero1=True, min1=True,
                                     sync="hier-int8")),
    "ring2": (dict(sequence=2), {}),
    "ulysses2": (dict(sequence=2), dict(mode="ulysses")),
    "ring4": (dict(sequence=4), {}),
    "ring2_tp2": (dict(sequence=2, tensor=2), {}),
    "ulysses2_tp2": (dict(sequence=2, tensor=2), dict(mode="ulysses")),
    "ring2_chunk": (dict(sequence=2), dict(chunk=8)),
    "clip_fsdp2": (dict(fsdp=2), dict(min1=True, clip=CLIP)),
    "clip_tp2": (dict(tensor=2), dict(clip=CLIP)),
}
SHARDED2_CASES = {
    "fsdp2": (dict(fsdp=2), dict(min1=True)),
    "tp2": (dict(tensor=2), {}),
    "ulysses2": (dict(sequence=2), dict(mode="ulysses")),
}


def shard_tokens() -> np.ndarray:
    """The parity runs' global batches: SHARD_STEPS x (8, 32) tokens."""
    rng = np.random.default_rng(11)
    return rng.integers(0, 128, (SHARD_STEPS, SHARD_BATCH, SHARD_SEQ),
                        np.int32)


def _sharded_state(init: dict, mesh_sizes: dict, opts: dict, *,
                   dropout: float = 0.0, world: int = 4):
    """A tiny GPT-2 from ``init`` on the mesh of ``mesh_sizes``, its
    layout's rules as the CLI picks them, and the step's options."""
    import dataclasses

    import torch

    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer,
    )
    from pytorch_distributed_training_tpu_torch.comm.mesh import (
        MeshConfig, make_mesh,
    )
    from pytorch_distributed_training_tpu_torch.models import (
        GPT2, GPT2Config,
    )
    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        DDP_RULES, ZERO1_OPT_RULES, tp_rules_for,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state,
    )

    model = GPT2(GPT2Config(**TINY4, dropout_rate=dropout))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    mesh = make_mesh(MeshConfig(data=-1, **mesh_sizes), world=world)
    rules = (tp_rules_for("gpt2") if mesh.shape["fsdp"] > 1
             or mesh.shape["tensor"] > 1 else DDP_RULES)
    opt_rules = ZERO1_OPT_RULES if opts.get("zero1") else None
    if opts.get("min1"):
        rules = dataclasses.replace(rules, min_fsdp_size=1)
        if opt_rules is not None:
            opt_rules = dataclasses.replace(opt_rules, min_fsdp_size=1)
    tx = build_optimizer("adamw", SHARD_LR, weight_decay=0.1,
                         grad_clip=opts.get("clip"))
    state = create_train_state(model, tx, mesh=mesh, rules=rules,
                               opt_rules=opt_rules,
                               sp_mode=opts.get("mode", "ring"))
    return state, mesh


def _sharded_run(label, mesh_sizes, opts, init, tokens, world, res,
                 ckpt=None):
    """One case: the probe, then SHARD_STEPS steps; rank 0 keeps the
    gathered results, every rank its gate norm and state bytes."""
    import dataclasses

    import torch

    from pytorch_distributed_training_tpu_torch.comm import GradSync
    from pytorch_distributed_training_tpu_torch.comm import GradSyncConfig
    from pytorch_distributed_training_tpu_torch.parallel.sharded import (
        state_bytes,
    )
    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        shard_batch,
    )
    from pytorch_distributed_training_tpu_torch.resilience import (
        AnomalyPolicy, init_resilience_state,
    )
    from pytorch_distributed_training_tpu_torch.tools import dp_check
    from pytorch_distributed_training_tpu_torch.train import (
        make_policy, make_train_step,
    )

    state, mesh = _sharded_state(init, mesh_sizes, opts, world=world)
    sync = None
    if opts.get("sync"):
        sync = GradSync(None if world == 1 else
                        torch.distributed.group.WORLD, state.params,
                        GradSyncConfig(mode=opts["sync"], n_slices=2,
                                       zero1=True, bucket_mb=0.002))
        state = dataclasses.replace(state,
                                    grad_sync_residual=sync.init_residual())
    gate = AnomalyPolicy() if opts.get("clip") else None
    if gate is not None:
        state = dataclasses.replace(state,
                                    resilience=init_resilience_state("cpu"))
    step = make_train_step(kind="lm", num_microbatches=SHARD_ACCUM,
                           lm_loss_chunk=opts.get("chunk"),
                           grad_sync=sync, anomaly_policy=gate,
                           state_shardings=state.shardings)
    res[f"{label}/bytes"] = np.array(state_bytes(state))
    losses, norms = [], []
    for i, b in enumerate(tokens):
        local = shard_batch({"tokens": torch.from_numpy(b).long()}, mesh,
                            num_microbatches=SHARD_ACCUM)
        if i == 0:
            probe = dp_check.probe("gpt2", state, local,
                                   policy=make_policy("f32"),
                                   accum=SHARD_ACCUM)
            for k, v in probe.items():
                res[f"{label}/probe/{k}"] = v
        state, m = step(state, local)
        losses.append(float(m["loss"]))
        if gate is not None:
            norms.append(float(m["grad_norm"]))
        if ckpt is not None and state.step == 1:
            ckpt(state)
    res[f"{label}/loss"] = np.array(losses)
    if norms:
        res[f"{label}/grad_norm"] = np.array(norms)
    for k, v in dp_check.whole(state).items():
        res[f"{label}/p/{k}"] = v.detach().numpy()
    return state, mesh


def _sharded(rank: int, world: int, group, out: str, cases: dict) -> dict:
    """``cases`` (``OUT/cases.json``: the labels of ``SHARDED_CASES``
    to run; every case without it), then at world 2 the checkpoints
    across layouts."""
    import json

    init = dict(np.load(os.path.join(out, "init.npz")))
    tokens = shard_tokens()
    path = os.path.join(out, "cases.json")
    if os.path.exists(path):
        with open(path) as f:
            cases = {label: cases[label] for label in json.load(f)}
    res: dict = {}
    for label, (mesh_sizes, opts) in cases.items():
        _sharded_run(label, mesh_sizes, opts, init, tokens, world, res)
    if world != 4:
        res.update(_ckpt_layouts(init, tokens, world, out))
    return res


def _sharded_extra(rank: int, world: int, group, out: str) -> dict:
    """Dropout under tensor 2 and the image models, sharded (4 ranks)."""
    init = dict(np.load(os.path.join(out, "init.npz")))
    return {**_dropout_tp(init, shard_tokens()),
            **_image_fsdp_tp(rank, world, out)}


def _dropout_tp(init, tokens) -> dict:
    """GPT-2 with dropout 0.1 under tensor 2: each rank's replicated
    leaves after the steps (the ranks of a tensor group must agree)."""
    import torch

    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        shard_batch,
    )
    from pytorch_distributed_training_tpu_torch.train import make_train_step

    state, mesh = _sharded_state(init, dict(tensor=2), {}, dropout=0.1)
    step = make_train_step(kind="lm", num_microbatches=SHARD_ACCUM, seed=5,
                           state_shardings=state.shardings)
    for b in tokens:
        local = shard_batch({"tokens": torch.from_numpy(b).long()}, mesh,
                            num_microbatches=SHARD_ACCUM)
        state, m = step(state, local)
    return {f"dropout/{n}": t.detach().numpy()
            for n, t in state.params.items()
            if not state.shardings.params[n].sharded}


# The image runs' sizes: the ViT at 32 px (2 x 2 patches), as
# test_torch_dp.py runs it; at 16 px its one patch and class token leave
# the key projection a gradient near rounding noise, which Adam turns
# into steps of up to lr.
IMAGE_SIZE = {"resnet": 16, "vit": 32}


def _image_fsdp_tp(rank: int, world: int, out: str) -> dict:
    """The shallow ResNet under data 2 x fsdp 2 (min size 1: every conv
    sharded) and the small ViT under tensor 2, 2 steps each from the
    JAX package's weights (``OUT/<kind>_init.npz``), gathered, with the
    one-process run beside them."""
    import dataclasses

    import torch

    from pytorch_distributed_training_tpu_torch.comm.mesh import (
        MeshConfig, make_mesh,
    )
    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        FSDP_RULES, shard_batch, tp_rules_for,
    )
    from pytorch_distributed_training_tpu_torch.tools import dp_check
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_train_step,
    )

    res = {}
    runs = {"resnet_fsdp": ("resnet", dict(fsdp=2),
                            dataclasses.replace(FSDP_RULES, min_fsdp_size=1)),
            "vit_tp2": ("vit", dict(tensor=2), tp_rules_for("vit_b16"))}
    for label, (kind, sizes, rules) in runs.items():
        size = IMAGE_SIZE[kind]
        batches = dp_check.global_batches(kind, 2, 8, size, 3)
        init = dict(np.load(os.path.join(out, f"{kind}_init.npz")))
        for sharded in (False, True):
            model = dp_check.build_model(kind, "cpu", init=init,
                                         image_size=size)
            tx = dp_check.optimizer(kind)
            if sharded:
                mesh = make_mesh(MeshConfig(data=-1, **sizes), world=world)
                state = create_train_state(model, tx, mesh=mesh, rules=rules)
                step = make_train_step(kind="image_classifier",
                                       num_microbatches=2,
                                       state_shardings=state.shardings)
            else:
                state = create_train_state(model, tx)
                step = make_train_step(kind="image_classifier",
                                       num_microbatches=2)
            losses = []
            for b in batches:
                b = {k: torch.from_numpy(v) for k, v in b.items()}
                if sharded:
                    b = shard_batch(b, mesh, num_microbatches=2)
                state, m = step(state, b)
                losses.append(float(m["loss"]))
            tag = f"{label}/{'sharded' if sharded else 'one'}"
            res[f"{tag}/loss"] = np.array(losses)
            for k, v in dp_check.whole(state).items():
                res[f"{tag}/p/{k}"] = v.detach().numpy()
    return res


def _ckpt_layouts(init, tokens, world, out) -> dict:
    """Train 1 step under fsdp 2 and save; restore into fsdp 2, zero1 and
    plain data-parallel templates and take step 2 in each."""
    import torch

    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        shard_batch,
    )
    from pytorch_distributed_training_tpu_torch.tools import dp_check
    from pytorch_distributed_training_tpu_torch.train import make_train_step

    group = torch.distributed.group.WORLD
    ckpt = os.path.join(out, "ckpt")
    mgr = CheckpointManager(ckpt, process_group=group)
    res: dict = {}
    _sharded_run("ckpt_src", dict(fsdp=2), dict(min1=True), init, tokens,
                 world, res, ckpt=lambda s: mgr.save(s, wait=True))
    mgr.close()
    for label, sizes, opts in (("fsdp2", dict(fsdp=2), dict(min1=True)),
                               ("zero1", dict(), dict(zero1=True,
                                                      min1=True)),
                               ("dp", None, {})):
        if sizes is None:
            # Plain data parallelism: the replicated state, no layout.
            from pytorch_distributed_training_tpu_torch.cli.main import (
                build_optimizer,
            )
            from pytorch_distributed_training_tpu_torch.data.loader import (
                rank_rows,
            )
            from pytorch_distributed_training_tpu_torch.models import (
                GPT2, GPT2Config,
            )
            from pytorch_distributed_training_tpu_torch.train import (
                create_train_state,
            )

            model = GPT2(GPT2Config(**TINY4))
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in init.items()})
            state = create_train_state(model, build_optimizer(
                "adamw", SHARD_LR, weight_decay=0.1), process_group=group)
            step_kw = dict(process_group=group)
            rank = torch.distributed.get_rank()
            local = {"tokens": torch.from_numpy(rank_rows(
                tokens[1], rank, world, SHARD_ACCUM)).long()}
        else:
            state, mesh = _sharded_state(init, sizes, opts, world=world)
            local = shard_batch({"tokens": torch.from_numpy(
                tokens[1]).long()}, mesh, num_microbatches=SHARD_ACCUM)
            step_kw = dict(state_shardings=state.shardings)
        state = CheckpointManager(ckpt, process_group=group).restore_latest(
            state)
        res[f"resume/{label}/step"] = np.array(state.step)
        step = make_train_step(kind="lm", num_microbatches=SHARD_ACCUM,
                               **step_kw)
        state, m = step(state, local)
        res[f"resume/{label}/loss"] = np.array(float(m["loss"]))
        for k, v in dp_check.whole(state).items():
            res[f"resume/{label}/p/{k}"] = v.detach().numpy()
    return res


SP_SHAPE = (2, 16, 4, 8)   # (B, L, H, D), L split over 4 sequence ranks


def sp_inputs(seed: int = 4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SP_SHAPE).astype(np.float32)
            for _ in range(4)]   # q, k, v, the cotangent


def _sp_attention(rank: int, world: int, group) -> dict:
    """Ring and Ulysses over a sequence axis of 4 (the world), causal and
    not: each rank's output and q/k/v gradients, gathered whole."""
    import torch

    from pytorch_distributed_training_tpu_torch.comm import collectives
    from pytorch_distributed_training_tpu_torch.comm.mesh import (
        MeshConfig, make_mesh,
    )
    from pytorch_distributed_training_tpu_torch.parallel import (
        configure_model, ring_self_attention, ulysses_attention,
    )

    mesh = make_mesh(MeshConfig(data=1, sequence=world), world=world)
    par = configure_model(torch.nn.Module(), mesh)
    ll = SP_SHAPE[1] // world
    q, k, v, dy = (torch.from_numpy(x[:, rank * ll:(rank + 1) * ll].copy())
                   for x in sp_inputs())
    res = {}
    for mode, fn in (("ring", ring_self_attention),
                     ("ulysses", ulysses_attention)):
        for causal in (False, True):
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            out = fn(qq, kk, vv, par, causal=causal)
            grads = torch.autograd.grad(out, (qq, kk, vv), dy)
            for name, t in (("out", out), ("dq", grads[0]),
                            ("dk", grads[1]), ("dv", grads[2])):
                res[f"{mode}/{causal}/{name}"] = collectives.all_gather(
                    t.detach().contiguous(), group, gather_axis=1).numpy()
    return res


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
                 "cache_rows": cache_rows, "collectives4": _collectives4,
                 "slices": _slices, "bucket_sync": _bucket_sync,
                 "grad_sync_steps": lambda *a: _grad_sync_steps(*a, out),
                 "sharded": lambda *a: _sharded(*a, out, SHARDED_CASES),
                 "sharded2": lambda *a: _sharded(*a, out, SHARDED2_CASES),
                 "sharded_extra": lambda *a: _sharded_extra(*a, out),
                 "sp_attention": _sp_attention}
        res = tasks[task](rank, world, group)
        os.makedirs(out, exist_ok=True)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        comm_init.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
