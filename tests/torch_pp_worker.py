"""Worker processes for the PyTorch port's pipeline-parallel tests.

Run as a script, this file is one rank of a four-rank gloo group on the
CPU (``tests/torch_dp_worker.py::launch`` starts the ranks):

    python tests/torch_pp_worker.py pipeline OUT
    python tests/torch_pp_worker.py card OUT    # two ranks, needs a card

``pipeline`` reads the JAX package's initial weights of the tiny GPT-2s under the
port's names (``OUT/init.npz``: 4 layers; ``OUT/init8.npz``: 8 layers)
and a JAX pipelined train state (``OUT/jax_state.pkl``), runs every
pipelined layout the tests hold against JAX, and rank 0 writes
``OUT/rank0.npz``: losses, gradients and parameters, gathered whole and
under the plain model's names.  ``card`` takes one GPipe and one 1F1B
step of a 2-stage tiny GPT-2 on the card (f32, TF32 off) and on the host
from the same weights; rank 0 writes both.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX's tiny pipelined GPT-2 (tests/test_pipeline.py::_pp_gpt2_cfg).
TINY = dict(vocab_size=128, max_seq_len=32, num_layers=4, num_heads=4,
            hidden_dim=32)
BATCH, SEQ, STEPS, MICRO = 8, 16, 3, 4
LR, WD = 1e-3, 0.1
# (schedule, pipeline stages, chunks, layers) of each layout; data takes
# the rest of the four ranks.
LAYOUTS = {
    "gpipe_pp4": ("gpipe", 4, 1, 4),
    "gpipe_pp2d2": ("gpipe", 2, 1, 4),
    "1f1b_pp4": ("1f1b", 4, 1, 4),
    "1f1b_pp2d2": ("1f1b", 2, 1, 4),
    "interleaved_pp2d2": ("interleaved", 2, 2, 4),
    "interleaved8_pp4": ("interleaved", 4, 2, 8),
}
STEP_LAYOUTS = ("gpipe_pp2d2", "1f1b_pp2d2", "interleaved_pp2d2",
                "gpipe_pp4", "1f1b_pp4")
# The compositions at PP 2 (JAX's tests/test_pipeline.py composition
# tests): (schedule, the other axis, width); FSDP at width 256 so that the
# big kernels reach MIN_FSDP_SIZE.  2 microbatches of (8, 32) tokens.
COMPOSITIONS = {
    f"{axis}_{sched}": (sched, axis, 256 if axis == "fsdp" else 32)
    for axis, scheds in (("fsdp", ("gpipe", "1f1b", "interleaved")),
                         ("tensor", ("gpipe", "1f1b", "interleaved")),
                         ("sequence", ("gpipe",)))
    for sched in scheds}
COMPOSITION_MICRO = 2


def composition_tokens() -> np.ndarray:
    return np.random.default_rng(1).integers(0, 128, (8, 32), np.int32)
SCHEDULES = ("gpipe", "1f1b", "interleaved")
# (schedule, --pp-compress) of the compressed gradients held against JAX.
COMPRESSED_VG = (("gpipe", "int8"), ("1f1b", "int8"),
                 ("interleaved", "int8"), ("gpipe", "bf16"))


def tokens(steps: int = STEPS) -> np.ndarray:
    """The global batches: ``steps`` x (8, 16) tokens."""
    rng = np.random.default_rng(7)
    return rng.integers(0, 128, (steps, BATCH, SEQ), np.int32)


def _model(init: dict, layers: int, schedule: str, stages: int,
           chunks: int, *, mode: str = "none", stripe: int = 1,
           dropout: float = 0.0, remat: bool = False, world: int = 4,
           device: str = "cpu", axes: dict | None = None, width: int = 32,
           micro: int = MICRO):
    """A pipelined tiny GPT-2 from ``init`` (plain names) and its sharded
    train state."""
    import torch

    from pytorch_distributed_training_tpu_torch.comm.mesh import (
        MeshConfig, make_mesh,
    )
    from pytorch_distributed_training_tpu_torch.models import GPT2Config
    from pytorch_distributed_training_tpu_torch.parallel.gpt2_pipeline import (
        PipelinedGPT2,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, optim,
    )

    cfg = GPT2Config(**{**TINY, "num_layers": layers, "hidden_dim": width},
                     dropout_rate=dropout)
    mesh = make_mesh(MeshConfig(data=-1, pipeline=stages, **(axes or {})),
                     world=world)
    pp = PipelinedGPT2(cfg, mesh, num_microbatches=micro, schedule=schedule,
                       num_chunks=chunks, pp_compress=mode, pp_stripe=stripe,
                       remat_ticks=remat, device=device)
    pp.load_plain({k: torch.from_numpy(v) for k, v in init.items()})
    state = create_train_state(pp, optim.adamw(LR, weight_decay=WD),
                               mesh=mesh, rules=pp.rules())
    return pp, state, mesh


def _local(batch: np.ndarray, mesh, device: str = "cpu",
           micro: int = MICRO):
    import torch

    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        shard_batch,
    )

    return shard_batch({"tokens": torch.from_numpy(batch).long().to(device)},
                       mesh, num_microbatches=micro)


def _plain(named: dict) -> dict:
    """Whole tensors under the plain model's names, as numpy."""
    from pytorch_distributed_training_tpu_torch.parallel.gpt2_pipeline import (
        to_plain,
    )

    return {k: v.detach().float().cpu().numpy()
            for k, v in to_plain(named).items()}


def _whole_grads(state, grads: dict) -> dict:
    layout = state.shardings
    return _plain({n: layout.gather_full(f"params/{n}", g)
                   for n, g in grads.items()})


def _card(rank: int, world: int, group, out: str) -> dict:
    """One GPipe and one 1F1B step at PP 2 on the card and on the host,
    from the same weights (drawn on the host from a seed)."""
    import torch

    from pytorch_distributed_training_tpu_torch.models import (
        GPT2, GPT2Config,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    plain = GPT2(GPT2Config(**TINY))
    plain.init_weights(torch.Generator().manual_seed(3))
    init = {k: v.detach().numpy() for k, v in plain.state_dict().items()}
    batch = tokens(1)[0]
    res = {}
    for device in ("cuda", "cpu"):
        for sched in ("gpipe", "1f1b"):
            pp, state, mesh = _model(init, 4, sched, 2, 1, world=world,
                                     device=device)
            state, losses = _train(pp, state, mesh, [batch], device=device)
            res[f"{device}/{sched}/loss"] = losses
            for k, v in _whole_params(state).items():
                res[f"{device}/{sched}/p/{k}"] = v
    return res


def _whole_params(state) -> dict:
    from pytorch_distributed_training_tpu_torch.tools import dp_check

    return _plain(dp_check.whole(state))


def _train(pp, state, mesh, batches, *, seed=None, device="cpu"):
    from pytorch_distributed_training_tpu_torch.parallel.gpt2_pipeline import (
        make_pipeline_grad_fn,
    )
    from pytorch_distributed_training_tpu_torch.train import make_train_step

    step = make_train_step(kind="lm", seed=seed,
                           grad_fn=make_pipeline_grad_fn(pp))
    losses = []
    for b in batches:
        state, m = step(state, _local(b, mesh, device))
        losses.append(float(m["loss"]))
    return state, np.array(losses)


def _pipeline(rank: int, world: int, group, out: str) -> dict:
    import torch

    inits = {4: dict(np.load(os.path.join(out, "init.npz"))),
             8: dict(np.load(os.path.join(out, "init8.npz")))}
    batches = tokens()
    res: dict = {}

    # Loss and gradients of the first batch, every layout.
    for label, (sched, stages, chunks, layers) in LAYOUTS.items():
        pp, state, mesh = _model(inits[layers], layers, sched, stages,
                                 chunks)
        loss, grads = pp.value_and_grad(state.params,
                                        _local(batches[0], mesh)["tokens"])
        res[f"vg/{label}/loss"] = np.array(float(loss))
        for k, v in _whole_grads(state, grads).items():
            res[f"vg/{label}/g/{k}"] = v
        if label == "interleaved_pp2d2":
            # The forward-only path: V successive GPipe ramps.
            with torch.no_grad():
                res["logits/interleaved_pp2d2"] = pp(
                    torch.from_numpy(batches[0]).long()).numpy()
    # The compressed hops' loss and gradients at PP 2 x data 2: int8 under
    # every schedule, bf16 under GPipe (JAX's tests of the two codecs).
    for sched, mode in COMPRESSED_VG:
        pp, state, mesh = _model(inits[4], 4, sched, 2,
                                 2 if sched == "interleaved" else 1,
                                 mode=mode)
        loss, grads = pp.value_and_grad(state.params,
                                        _local(batches[0], mesh)["tokens"])
        res[f"vgc/{sched}/{mode}/loss"] = np.array(float(loss))
        for k, v in _whole_grads(state, grads).items():
            res[f"vgc/{sched}/{mode}/g/{k}"] = v
    pp, state, mesh = _model(inits[4], 4, "gpipe", 2, 1, remat=True)
    loss, grads = pp.value_and_grad(state.params,
                                    _local(batches[0], mesh)["tokens"])
    res["vg/gpipe_remat_pp2d2/loss"] = np.array(float(loss))
    for k, v in _whole_grads(state, grads).items():
        res[f"vg/gpipe_remat_pp2d2/g/{k}"] = v
    # GPipe under --accum-steps 2: two pipeline passes of 2 microbatches.
    from pytorch_distributed_training_tpu_torch.parallel.gpt2_pipeline import (
        make_pipeline_grad_fn,
    )

    pp, state, mesh = _model(inits[4], 4, "gpipe", 2, 1, micro=2)
    loss, _, grads = make_pipeline_grad_fn(pp, accum_steps=2)(
        state, _local(batches[0], mesh, micro=4), None)
    res["vg/gpipe_accum2_pp2d2/loss"] = np.array(float(loss))
    for k, v in _whole_grads(state, grads).items():
        res[f"vg/gpipe_accum2_pp2d2/g/{k}"] = v

    # Three train steps.
    for label in STEP_LAYOUTS:
        sched, stages, chunks, layers = LAYOUTS[label]
        pp, state, mesh = _model(inits[layers], layers, sched, stages,
                                 chunks)
        state, losses = _train(pp, state, mesh, batches)
        res[f"steps/{label}/loss"] = losses
        for k, v in _whole_params(state).items():
            res[f"steps/{label}/p/{k}"] = v

    # --pp-compress and striping: one step at PP 2 x data 2.
    for sched in SCHEDULES:
        chunks = 2 if sched == "interleaved" else 1
        for mode in ("none", "bf16", "int8"):
            for stripe in ((1, 2) if mode != "bf16" else (1,)):
                pp, state, mesh = _model(inits[4], 4, sched, 2, chunks,
                                         mode=mode, stripe=stripe)
                state, losses = _train(pp, state, mesh, batches[:1])
                tag = f"pp/{sched}/{mode}/{stripe}"
                res[f"{tag}/loss"] = losses
                for k, v in _whole_params(state).items():
                    res[f"{tag}/p/{k}"] = v

    # Dropout replay: 1F1B's recompute draws GPipe's masks, so its
    # gradients equal autograd through those masks; interleaved runs
    # twice alike, three steps on one batch (JAX's test).
    for sched in ("gpipe", "1f1b"):
        pp, state, mesh = _model(inits[4], 4, sched, 2, 1, dropout=0.1)
        loss, grads = pp.value_and_grad(state.params,
                                        _local(batches[0], mesh)["tokens"],
                                        rng=(5, 0))
        res[f"drop/{sched}/loss"] = np.array(float(loss))
        for k, v in _whole_grads(state, grads).items():
            res[f"drop/{sched}/g/{k}"] = v
    for run in (0, 1):
        pp, state, mesh = _model(inits[4], 4, "interleaved", 2, 2,
                                 dropout=0.1)
        state, losses = _train(pp, state, mesh, [batches[0]] * STEPS,
                               seed=5)
        res[f"drop/interleaved/{run}/loss"] = losses

    # The compositions: loss and gradients of one batch.
    for label, (sched, axis, width) in COMPOSITIONS.items():
        init = dict(np.load(os.path.join(out, f"init_w{width}.npz")))
        pp, state, mesh = _model(init, 4, sched, 2, 2 if sched ==
                                 "interleaved" else 1, axes={axis: 2},
                                 width=width, micro=COMPOSITION_MICRO)
        loss, grads = pp.value_and_grad(state.params, _local(
            composition_tokens(), mesh, micro=COMPOSITION_MICRO)["tokens"])
        res[f"comp/{label}/loss"] = np.array(float(loss))
        for k, v in _whole_grads(state, grads).items():
            res[f"comp/{label}/g/{k}"] = v

    res.update(_jax_state(inits[4], batches, out))
    res.update(_checkpoints(rank, inits[4], batches, out))
    return res


def _jax_state(init: dict, batches, out: str) -> dict:
    """A JAX pipelined 1F1B state after one step (PP 2), continued by the
    port for the remaining steps."""
    from pytorch_distributed_training_tpu_torch.models import (
        train_state_from_jax, train_state_to_jax,
    )

    with open(os.path.join(out, "jax_state.pkl"), "rb") as f:
        arrays = pickle.load(f)
    pp, state, mesh = _model(init, 4, "1f1b", 2, 1)
    state = train_state_from_jax(arrays, state)
    state, losses = _train(pp, state, mesh, batches[1:])
    res = {"jaxstate/loss": losses, "jaxstate/step": np.array(state.step)}
    for k, v in _whole_params(state).items():
        res[f"jaxstate/p/{k}"] = v
    # And back: the continued state as JAX's pipelined tree (collective).
    back = train_state_to_jax(state)

    def flat(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                flat(v, f"{path}/{k}")
        else:
            res[f"jaxstate/tojax{path}"] = tree

    flat(back["params"], "/params")
    flat(back["opt_state"][0][1], "/mu")
    return res


def _checkpoints(rank: int, init: dict, batches, out: str) -> dict:
    """A PP 4 1F1B run saved after step 2, resumed for step 3 under PP 4
    (bitwise the uninterrupted run), PP 2 x data 2 and the plain model at
    world 1."""
    import torch

    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from pytorch_distributed_training_tpu_torch.models import (
        GPT2, GPT2Config,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_train_step, optim,
    )

    group = torch.distributed.group.WORLD
    ckpt = os.path.join(out, "ckpt")
    res: dict = {}
    pp, state, mesh = _model(init, 4, "1f1b", 4, 1)
    state, _ = _train(pp, state, mesh, batches[:2])
    mgr = CheckpointManager(ckpt, process_group=group)
    mgr.save(state, wait=True)
    mgr.close()
    state, losses = _train(pp, state, mesh, batches[2:])
    res["ckpt/straight/loss"] = losses
    for k, v in _whole_params(state).items():
        res[f"ckpt/straight/p/{k}"] = v
    for label, (sched, stages) in (("pp4", ("1f1b", 4)),
                                   ("pp2d2", ("1f1b", 2))):
        pp, state, mesh = _model(init, 4, sched, stages, 1)
        state = CheckpointManager(ckpt, process_group=group).restore_latest(
            state)
        res[f"ckpt/{label}/step"] = np.array(state.step)
        state, losses = _train(pp, state, mesh, batches[2:])
        res[f"ckpt/{label}/loss"] = losses
        for k, v in _whole_params(state).items():
            res[f"ckpt/{label}/p/{k}"] = v
    if rank == 0:
        model = GPT2(GPT2Config(**TINY))
        state = create_train_state(model, optim.adamw(LR, weight_decay=WD))
        state = CheckpointManager(ckpt).restore_latest(state)
        res["ckpt/plain/step"] = np.array(state.step)
        step = make_train_step(kind="lm", num_microbatches=MICRO)
        state, m = step(state, {"tokens": torch.from_numpy(
            batches[2]).long()})
        res["ckpt/plain/loss"] = np.array([float(m["loss"])])
    torch.distributed.barrier()
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
        res = {"pipeline": _pipeline, "card": _card}[task](
            rank, world, group, out)
        if rank == 0:
            np.savez(os.path.join(out, "rank0.npz"), **res)
    finally:
        comm_init.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
