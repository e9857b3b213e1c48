"""The rank side of ``tests/test_torch_moe.py`` and
``tests/test_torch_moe_pipeline.py``: gloo ranks on the CPU, launched
once per task by ``tests/torch_dp_worker.launch`` (every rank writes
``OUT/rank<r>.npz``).  Imports the port only, never JAX.

``moe`` (4 ranks): the tiny MoE GPT-2 (``init.npz``, JAX's weights
under the port's names) trained ``STEPS`` adamw steps of ``ACCUM``
microbatches under every layout of ``LAYOUTS``: plain data parallelism
(global routing over the group), and sharded meshes with expert, tensor
and fsdp axes; then a checkpoint of the expert-parallel state restored
into plain data parallelism and into PP 2 x data 2.

Then each rank evaluates the whole batch after the layouts that drop
tokens, and the CLI trains one step under ``--distributed`` and
evaluates (``CLI_EVAL``).

``moe_pipeline`` (4 ranks): PP 2 x data 2 GPipe on ``init_pp.npz`` (the
4-layer config): one batch's loss, drop rate and whole gradients, the
evaluation logits, then ``STEPS`` train steps.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX's tests/test_moe.py::test_gpt2_moe_trains_expert_parallel config
# at 4 layers (two MoE blocks; PP 2 takes an even number a stage).
TINY_MOE = dict(vocab_size=128, max_seq_len=16, num_layers=4, num_heads=2,
                hidden_dim=32, num_experts=4)
# tests/test_pipeline.py::_pp_moe_cfg.
PP_MOE = dict(vocab_size=128, max_seq_len=32, num_layers=4, num_heads=4,
              hidden_dim=32, num_experts=4)
STEPS, ACCUM, BATCH, SEQ = 3, 2, 8, 16
PP_MICRO = 2
LR, WD = 1e-3, 0.1
# label -> (mesh axes, dispatch, capacity factor, plain data parallelism)
LAYOUTS = {
    "dp4": (dict(), "scatter", 1.25, True),
    "dp4_drop": (dict(), "scatter", 0.5, True),
    "ep4": (dict(expert=4), "einsum", 1.25, False),
    "d2e2": (dict(expert=2), "einsum", 1.25, False),
    "d2e2_drop": (dict(expert=2), "scatter", 0.5, False),
    "e2t2": (dict(expert=2, tensor=2), "einsum", 1.25, False),
    "d2t2": (dict(tensor=2), "scatter", 1.25, False),
    "f2e2": (dict(fsdp=2, expert=2), "einsum", 1.25, False),
}
CKPT_SRC = "d2e2"
# The CLI under --distributed (``moe`` task): ``TINY_MOE`` at a capacity
# that drops tokens (the CLI's scatter dispatch), one train step (which
# routes over the group), then one eval batch, which every rank holds
# whole.
CLI_EVAL_CF = 0.5
CLI_EVAL = [
    "--use-cpu", "--model", "gpt2_moe", "--dataset", "synthetic-tokens",
    "--seq-len", "16", "--model-overrides",
    ",".join(f"{k}={v}" for k, v in TINY_MOE.items())
    + f",moe_capacity_factor={CLI_EVAL_CF}",
    "--batch-size", "8", "--steps-per-epoch", "1", "--num-workers", "0",
    "--learning-rate", "1e-3", "--eval", "--eval-steps", "1", "--distributed"]


def moe_tokens(seed: int = 5, steps: int = STEPS, batch: int = BATCH,
               seq: int = SEQ, vocab: int = 128) -> np.ndarray:
    """``steps`` global batches of (batch, seq) tokens."""
    return np.random.default_rng(seed).integers(
        0, vocab, (steps, batch, seq), np.int32)


def _cli_eval(argv: list) -> dict:
    """The CLI run of ``argv`` in this process, the group this process
    joined kept: the losses its eval step computed here (``eval``; the
    CLI logs rank 0's alone), the first eval batch (``batch``) and the
    trained parameters (``p/<name>``)."""
    import pytorch_distributed_training_tpu_torch.train as train
    from pytorch_distributed_training_tpu_torch.cli.main import main
    from pytorch_distributed_training_tpu_torch.comm import init as comm_init

    seen: dict = {"eval": []}
    make, shutdown = train.make_eval_step, comm_init.shutdown

    def recording(**kw):
        step = make(**kw)

        def run(state, batch):
            metrics = step(state, batch)
            seen["eval"].append(float(metrics["loss"]))
            seen.setdefault("batch", batch["tokens"].numpy().copy())
            return metrics

        return run

    train.make_eval_step, comm_init.shutdown = recording, lambda: None
    try:
        params = main(argv).state.params
    finally:
        train.make_eval_step, comm_init.shutdown = make, shutdown
    return {"eval": np.array(seen["eval"]), "batch": seen["batch"],
            **{f"p/{k}": v.detach().numpy().copy()
               for k, v in params.items()}}


def _model(init: dict, cfg: dict, dispatch: str, cf: float):
    import torch

    from pytorch_distributed_training_tpu_torch.models import (
        GPT2, GPT2Config,
    )

    model = GPT2(GPT2Config(**cfg, moe_dispatch=dispatch,
                            moe_capacity_factor=cf), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return model


def _state(init, axes, dispatch, cf, plain, group):
    """The train state of one layout and its step's keywords and mesh
    (None for plain data parallelism)."""
    from pytorch_distributed_training_tpu_torch.comm.mesh import (
        MeshConfig, make_mesh,
    )
    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        tp_rules_for,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, optim,
    )

    model = _model(init, TINY_MOE, dispatch, cf)
    tx = optim.adamw(LR, weight_decay=WD)
    if plain:
        state = create_train_state(model, tx, process_group=group)
        return state, dict(process_group=group), None
    mesh = make_mesh(MeshConfig(data=-1, **axes), world=4)
    state = create_train_state(model, tx, mesh=mesh,
                               rules=tp_rules_for("gpt2_moe"))
    return state, dict(state_shardings=state.shardings), mesh


def _local(batch: np.ndarray, mesh, rank: int, world: int,
           micro: int = ACCUM) -> dict:
    import torch

    from pytorch_distributed_training_tpu_torch.data.loader import rank_rows
    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        shard_batch,
    )

    if mesh is None:
        return {"tokens": torch.from_numpy(
            rank_rows(batch, rank, world, micro)).long()}
    return shard_batch({"tokens": torch.from_numpy(batch).long()}, mesh,
                       num_microbatches=micro)


def _whole(state) -> dict:
    from pytorch_distributed_training_tpu_torch.parallel.gpt2_pipeline import (
        to_plain,
    )
    from pytorch_distributed_training_tpu_torch.tools import dp_check

    # Copies: a replicated leaf is the live parameter, which the next
    # step updates in place.
    return {k: v.detach().float().numpy().copy()
            for k, v in to_plain(dp_check.whole(state)).items()}


def _moe(rank: int, world: int, group, out: str) -> dict:
    import torch

    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from pytorch_distributed_training_tpu_torch.parallel.sharded import (
        state_bytes,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        make_eval_step, make_train_step,
    )

    init = dict(np.load(os.path.join(out, "init.npz")))
    tokens = moe_tokens()
    res: dict = {}
    for label, (axes, dispatch, cf, plain) in LAYOUTS.items():
        state, kw, mesh = _state(init, axes, dispatch, cf, plain, group)
        step = make_train_step(kind="lm", num_microbatches=ACCUM, **kw)
        res[f"{label}/bytes"] = np.array(state_bytes(state))
        losses, drops = [], []
        for b in tokens:
            state, m = step(state, _local(b, mesh, rank, world))
            losses.append(float(m["loss"]))
            drops.append(float(m["moe_drop_rate"]))
        res[f"{label}/loss"] = np.array(losses)
        res[f"{label}/drop"] = np.array(drops)
        if cf < 1.0:
            # Every rank evaluates the whole batch, as the CLI does.
            ev = make_eval_step(kind="lm",
                                state_shardings=kw.get("state_shardings"))
            res[f"{label}/eval"] = np.array(float(ev(state, {
                "tokens": torch.from_numpy(moe_tokens(seed=7, steps=1)[0])
                .long()})["loss"]))
        for k, v in _whole(state).items():
            res[f"{label}/p/{k}"] = v
        if label == CKPT_SRC:
            mgr = CheckpointManager(os.path.join(out, "ckpt"),
                                    process_group=group)
            mgr.save(state, wait=True)
            mgr.close()
    res.update(_restores(init, rank, world, group, out))
    res.update({f"cli/{k}": v for k, v in _cli_eval(CLI_EVAL).items()})
    return res


def _restores(init, rank, world, group, out) -> dict:
    """The expert-parallel checkpoint into plain data parallelism and into
    PP 2 x data 2: the restored whole parameters and one more step; the
    data-parallel state after that step saved and restored into data 2
    x expert 2 again."""
    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from pytorch_distributed_training_tpu_torch.train import make_train_step

    _, dispatch, cf, _ = LAYOUTS[CKPT_SRC]
    extra = moe_tokens(seed=6, steps=1)[0]
    res: dict = {}
    for label in ("dp4", "pp2d2"):
        if label == "dp4":
            state, kw, mesh = _state(init, {}, dispatch, cf, True, group)
            batch = _local(extra, None, rank, world)
        else:
            pp, state, mesh = _pp_state(init, TINY_MOE, micro=PP_MICRO,
                                        dispatch=dispatch, cf=cf)
            kw = dict(grad_fn=_pp_grad_fn(pp))
            batch = _local(extra, mesh, rank, world, micro=PP_MICRO)
        state = CheckpointManager(os.path.join(out, "ckpt"),
                                  process_group=group).restore_latest(state)
        res[f"restore/{label}/step"] = np.array(state.step)
        for k, v in _whole(state).items():
            res[f"restore/{label}/p/{k}"] = v
        step = make_train_step(kind="lm", num_microbatches=(
            ACCUM if label == "dp4" else 1), **kw)
        state, m = step(state, batch)
        res[f"restore/{label}/loss"] = np.array(float(m["loss"]))
        if label == "dp4":
            for k, v in _whole(state).items():
                res[f"restore/dp4/p4/{k}"] = v
            mgr = CheckpointManager(os.path.join(out, "ckpt_dp4"),
                                    process_group=group)
            mgr.save(state, wait=True)
            mgr.close()
    axes = LAYOUTS[CKPT_SRC][0]
    state, _, _ = _state(init, axes, dispatch, cf, False, group)
    state = CheckpointManager(os.path.join(out, "ckpt_dp4"),
                              process_group=group).restore_latest(state)
    res["restore/e2_from_dp4/step"] = np.array(state.step)
    for k, v in _whole(state).items():
        res[f"restore/e2_from_dp4/p/{k}"] = v
    return res


def _pp_state(init: dict, cfg: dict, *, micro: int, dispatch="einsum",
              cf=1.25):
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

    mesh = make_mesh(MeshConfig(data=-1, pipeline=2), world=4)
    pp = PipelinedGPT2(GPT2Config(**cfg, moe_dispatch=dispatch,
                                  moe_capacity_factor=cf), mesh,
                       num_microbatches=micro)
    pp.load_plain({k: torch.from_numpy(v) for k, v in init.items()})
    state = create_train_state(pp, optim.adamw(LR, weight_decay=WD),
                               mesh=mesh, rules=pp.rules())
    return pp, state, mesh


def _pp_grad_fn(pp):
    from pytorch_distributed_training_tpu_torch.parallel.gpt2_pipeline import (
        make_pipeline_grad_fn,
    )

    return make_pipeline_grad_fn(pp)


def _moe_pipeline(rank: int, world: int, group, out: str) -> dict:
    import torch

    from pytorch_distributed_training_tpu_torch.train import make_train_step

    init = dict(np.load(os.path.join(out, "init_pp.npz")))
    batches = moe_tokens(seed=2, batch=4, vocab=PP_MOE["vocab_size"])
    res: dict = {}
    pp, state, mesh = _pp_state(init, PP_MOE, micro=PP_MICRO)
    local = _local(batches[0], mesh, rank, world, micro=PP_MICRO)
    loss, grads, stats = pp.value_grad_and_stats(state.params,
                                                 local["tokens"])
    res["vg/loss"] = np.array(float(loss))
    res["vg/drop"] = np.array(float(stats["moe_drop_rate"]))
    layout = state.shardings
    for k, v in _whole_grad(layout, grads).items():
        res[f"vg/g/{k}"] = v
    with torch.no_grad():
        logits = pp(local["tokens"])
    res["logits"] = logits.numpy()
    step = make_train_step(kind="lm", grad_fn=_pp_grad_fn(pp))
    losses, drops = [], []
    for b in batches:
        state, m = step(state, _local(b, mesh, rank, world, micro=PP_MICRO))
        losses.append(float(m["loss"]))
        drops.append(float(m["moe_drop_rate"]))
    res["steps/loss"] = np.array(losses)
    res["steps/drop"] = np.array(drops)
    for k, v in _whole(state).items():
        res[f"steps/p/{k}"] = v
    return res


def _whole_grad(layout, grads: dict) -> dict:
    from pytorch_distributed_training_tpu_torch.parallel.gpt2_pipeline import (
        to_plain,
    )

    return {k: v.detach().float().numpy() for k, v in to_plain(
        {n: layout.gather_full(f"params/{n}", g)
         for n, g in grads.items()}).items()}


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    from pytorch_distributed_training_tpu_torch.comm import init as comm_init

    torch.set_num_threads(1)
    task, out = sys.argv[1], sys.argv[2]
    group = comm_init.initialize("cpu")
    try:
        rank, world = comm_init.process_index(), comm_init.process_count()
        tasks = {"moe": _moe, "moe_pipeline": _moe_pipeline}
        res = tasks[task](rank, world, group, out)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        comm_init.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
