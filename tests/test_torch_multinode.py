"""The multi-node shape of BASELINE configs[4] on the CPU: the port's CLI
under ``--distributed --use-cpu`` launched by ``torch.distributed.run``
as two nodes (``--nnodes 2 --node_rank r --master_addr --master_port``,
the static rendezvous) of two processes each, over gloo.

- Two nodes of two equal one launch of four bit for bit (the step-4
  checkpoints' tensors), and come within 1e-4 of JAX's
  ``make_train_step`` on the global batches (the key bias to Adam's
  bound, as in ``tests/test_torch_dp.py``).
- Only rank 0 writes: node 1's own ``--checkpoint-dir`` stays empty.
- ``tools/dp_check.py`` saves on two nodes of one rank and one process
  resumes its step bit for bit (``chip_smoke.py``'s C3 on the host).
- The world-4 checkpoint of step 2 resumes at world 1 (one process) and
  at world 2 (two nodes of one; node 1 given an empty checkpoint
  directory, so it restores through the broadcast alone), and each
  resumed run's step-4 state is within 1e-5 of the world-4 run that was
  not interrupted (the same global batches; only the order of the
  summations differs).

Every launch picks a free port, so the file runs under xdist.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tpu.models import gpt2_124m as jax_gpt2
from pytorch_distributed_training_tpu.train import (
    TrainState as JaxTrainState, make_policy as jax_policy,
    make_train_step as jax_train_step,
)
from pytorch_distributed_training_tpu_torch.checkpoint import (
    CheckpointManager,
)
from pytorch_distributed_training_tpu_torch.data import (
    DataLoader, DataLoaderConfig, SyntheticTokens,
)
from pytorch_distributed_training_tpu_torch.models import (
    create_model, gpt2_params_to_jax,
)
from tests.test_torch_train import _assert_params_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_layers=1, hidden_dim=32, num_heads=2, vocab_size=64,
           max_seq_len=32)
SEQ, BATCH, PER_EPOCH, EPOCHS, LR, WD, SEED = 16, 8, 2, 2, 1e-3, 0.1, 0
ARGV = ["--use-cpu", "--model", "gpt2", "--dataset", "synthetic-tokens",
        "--seq-len", str(SEQ), "--model-overrides",
        ",".join(f"{k}={v}" for k, v in CFG.items()), "--batch-size",
        str(BATCH), "--num-workers", "0", "--steps-per-epoch",
        str(PER_EPOCH), "--epochs", str(EPOCHS), "--optimizer", "adamw",
        "--learning-rate", str(LR), "--weight-decay", str(WD), "--seed",
        str(SEED)]
CLI = ["-m", "pytorch_distributed_training_tpu_torch.cli.main"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(nodes: list[list[str]], nproc: int, timeout: float = 150.0
            ) -> list[str]:
    """One ``torch.distributed.run`` a node, all at once: ``nodes[r]`` is
    node r's CLI arguments.  A single node runs ``--standalone``.  Every
    process is killed on a failure; returns each node's stdout."""
    if len(nodes) == 1:
        rdzv = ["--standalone"]
    else:
        rdzv = ["--nnodes", str(len(nodes)), "--master_addr", "localhost",
                "--master_port", str(_free_port())]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = []
    deadline = time.monotonic() + timeout
    try:
        for r, argv in enumerate(nodes):
            node = ["--node_rank", str(r)] if len(nodes) > 1 else []
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", *rdzv,
                 *node, "--nproc_per_node", str(nproc), *CLI,
                 "--distributed", *argv],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, start_new_session=True))
        outs = []
        for p in procs:
            out, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            assert p.returncode == 0, out[-3000:] + err[-3000:]
            outs.append(out)
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()


def _final(ckpt) -> dict:
    mgr = CheckpointManager(str(ckpt))
    step = mgr.all_steps()[-1]
    assert step == PER_EPOCH * EPOCHS
    return mgr.load_tensors(step)


@pytest.fixture(scope="module")
def two_nodes(tmp_path_factory):
    """The uninterrupted world-4 run as two nodes of two: (node 0's and
    node 1's checkpoint dirs, stdouts)."""
    root = tmp_path_factory.mktemp("two_nodes")
    dirs = [root / "node0", root / "node1"]
    outs = _launch([[*ARGV, "--checkpoint-dir", str(d)] for d in dirs], 2)
    return dirs, outs


def test_two_nodes_of_two_equal_one_launch_of_four_and_jax(two_nodes,
                                                           tmp_path):
    dirs, outs = two_nodes
    joined = "".join(outs)
    for rank in range(4):
        assert (f"Process group initialized - WORLD_SIZE: 4, RANK: {rank}"
                in joined)
        assert f"process {rank}/4 | backend=cpu | devices=1" in joined
    assert outs[0].count("training finished") == 2   # ranks 0 and 1
    # Only rank 0 writes: node 1's directory holds nothing.
    assert not dirs[1].exists() or not any(dirs[1].iterdir())
    one = tmp_path / "one"
    _launch([[*ARGV, "--checkpoint-dir", str(one)]], 4)
    ref, got = _final(one), _final(dirs[0])
    assert ref.keys() == got.keys()
    for k in ref:
        assert torch.equal(ref[k], got[k]), k

    # JAX on the global batches from the same initial weights.
    model = create_model("gpt2", device="cpu", seed=SEED, cfg_overrides=CFG)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    gpt2_params_to_jax(model.state_dict()))
    jm = jax_gpt2(cfg_overrides=CFG)
    tx = optax.adamw(LR, weight_decay=WD)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats={},
                          apply_fn=jm.apply, tx=tx)
    step = jax_train_step(kind="lm", policy=jax_policy("f32"))
    loader = DataLoader(SyntheticTokens(seq_len=SEQ,
                                        vocab_size=CFG["vocab_size"]),
                        DataLoaderConfig(batch_size=BATCH, seed=SEED))
    for epoch in range(EPOCHS):
        loader.set_epoch(epoch)
        for _, b in zip(range(PER_EPOCH), loader):
            state, _ = step(state, {"tokens": jnp.asarray(b["tokens"])})
    got_tree = gpt2_params_to_jax({k[len("params/"):]: v for k, v in
                                   got.items() if k.startswith("params/")})
    _assert_params_close(got_tree, jax.tree_util.tree_map(np.asarray,
                                                          state.params),
                         atol=1e-4, lr_bound=2 * PER_EPOCH * EPOCHS * LR)


def _step2_copy(src, dst):
    """``src``'s checkpoints without the last step: step 2 only."""
    shutil.copytree(src, dst)
    CheckpointManager(str(dst))._drop_bad_step(PER_EPOCH * EPOCHS)
    assert CheckpointManager(str(dst)).all_steps() == [PER_EPOCH]


def _assert_close(got: dict, want: dict, atol: float) -> None:
    """Every tensor within ``atol``, except the key bias (the middle third
    of each qkv bias): its gradient is zero in exact arithmetic, so both
    runs step it on rounding noise, which Adam normalises into steps of
    up to the learning rate (``tests/test_torch_train.py``)."""
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if k.startswith("params/") and k.endswith("qkv.bias"):
            d = w.shape[0] // 3
            torch.testing.assert_close(g[d:2 * d], w[d:2 * d], rtol=0,
                                       atol=2 * PER_EPOCH * LR, msg=k)
            g, w = torch.cat([g[:d], g[2 * d:]]), torch.cat([w[:d], w[2 * d:]])
        torch.testing.assert_close(g, w, atol=atol, rtol=0, msg=k)


RESUMED = f"resumed from step {PER_EPOCH} (epoch 1, skipping 0 consumed " \
    "batches)"


def test_world_4_checkpoint_resumes_at_world_1(two_nodes, tmp_path):
    dirs, _ = two_nodes
    ckpt = tmp_path / "w1"
    _step2_copy(dirs[0], ckpt)
    res = subprocess.run(
        [sys.executable, *CLI, *ARGV, "--checkpoint-dir", str(ckpt),
         "--resume"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert RESUMED in res.stdout
    _assert_close(_final(ckpt), _final(dirs[0]), 1e-5)


def test_world_4_checkpoint_resumes_at_world_2_on_two_nodes(two_nodes,
                                                            tmp_path):
    """Node 1 gets an empty checkpoint directory of its own: it restores
    through rank 0's broadcasts and writes nothing."""
    dirs, _ = two_nodes
    ckpt, empty = tmp_path / "w2", tmp_path / "node1"
    _step2_copy(dirs[0], ckpt)
    empty.mkdir()
    outs = _launch([[*ARGV, "--checkpoint-dir", str(ckpt), "--resume"],
                    [*ARGV, "--checkpoint-dir", str(empty), "--resume"]], 1)
    for out in outs:
        assert RESUMED in out
    assert not any(empty.iterdir())
    _assert_close(_final(ckpt), _final(dirs[0]), 1e-5)


def test_dp_check_saves_on_two_nodes_and_resumes_in_one_process(tmp_path):
    """``tools/dp_check.py`` as ``chip_smoke.py``'s C3 runs it: two nodes
    of one rank train 4 steps of the shallow ResNet and rank 0 saves step
    2; one process restores it bit for bit and its steps 3-4 come within
    1e-4 of the two nodes' (sync-BN's sums in another order)."""
    from pytorch_distributed_training_tpu_torch.tools import dp_check

    out = tmp_path / "out"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
         "--nproc_per_node", "1", "--node_rank", str(node), "--master_addr",
         "localhost", "--master_port", port, "-m",
         "pytorch_distributed_training_tpu_torch.tools.dp_check", "--model",
         "resnet", "--device", "cpu", "--out", str(out), "--steps", "4",
         "--save-at", "2", "--checkpoint-dir", str(tmp_path / f"node{node}")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True) for node in range(2)]
    try:
        for node, p in enumerate(procs):
            stdout, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            assert f"RANK {node} LOCAL_RANK 0 GROUP_RANK {node}" in stdout
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    assert ranks[0]["checksums"] == ranks[1]["checksums"]
    assert not (tmp_path / "node1").exists()
    model = dp_check.build_model("resnet", "cpu", seed=1)
    losses, sums, state = dp_check.run_steps(
        "resnet", model, dp_check.global_batches("resnet", 4, 8, 16, 1),
        accum=dp_check.ACCUM, device="cpu", resume=True,
        checkpoint=CheckpointManager(str(tmp_path / "node0")))
    assert state.step == 4
    assert sums[0] == ranks[0]["checksums"][1]
    np.testing.assert_allclose(losses, ranks[0]["losses"][2:], atol=1e-4,
                               rtol=0)
    saved = np.load(out / "rank0.npz")
    for k, v in {**state.params, **state.batch_stats}.items():
        np.testing.assert_allclose(v.detach().numpy(), saved[k], atol=1e-4,
                                   rtol=0, err_msg=k)
