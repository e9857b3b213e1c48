"""Data-parallel training in the PyTorch port against one process and
against the JAX package, on the CPU with gloo.

- Sync-BN: ``batch_norm``, ``bn_relu``, ``bn_add_relu`` and the four norm
  modules on two ranks equal one process on the concatenated batch
  within 1e-5: outputs, statistics, ``dx`` and the ranks' mean of their
  local ``dgamma``/``dbeta`` (each rank's cotangent is twice the global
  loss's, as in the train step).
- The loader: for P in {2, 4} ranks and N in {1, 2, 4} microbatches, the
  rows the ranks hold of microbatch i, concatenated over ranks, are
  exactly JAX's microbatch i (the JAX loader's shards assembled
  process-major, split by JAX's ``_split_microbatches``).
- Train steps: two gloo ranks (``tools/dp_check.py``) against JAX's
  ``make_train_step`` on the global batch in one process: a ResNet (f32,
  ``batch_stats``, accumulation 2) within 1e-4, GPT-2 (2 layers, f32,
  dropout 0, accumulation 2) and a 2-layer ViT (width 64, 32 px,
  accumulation 2) within rtol 1e-5, three steps; the ViT under the bf16
  policy too, its losses within 2e-2 of JAX's; both ranks' parameters
  bit-identical after every step.
- The CLI under ``torch.distributed.run`` with ``--distributed
  --use-cpu``.

Every multi-process run has its own limit of at most 120 s.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu import data as jdata
from pytorch_distributed_training_tpu.parallel.grad_accum import (
    _split_microbatches as jax_split,
)
from pytorch_distributed_training_tpu_torch import data as tdata
from pytorch_distributed_training_tpu_torch.data.loader import rank_rows
from pytorch_distributed_training_tpu_torch.models import (
    gpt2_params_from_jax, gpt2_params_to_jax, resnet_params_from_jax,
    resnet_params_to_jax, vit_params_from_jax, vit_params_to_jax,
)
from pytorch_distributed_training_tpu_torch.tools import dp_check
from tests.test_torch_resnet import (
    CONFIGS, _assert_tree_close, _jax_init, _run_jax as _run_jax_resnet,
)
from tests.test_torch_train import (
    SMALL, _assert_params_close, _jax_params, _run_jax as _run_jax_gpt2,
)
from tests.test_torch_vit import (
    SMALL as VIT_SMALL, _jax_init as _jax_vit_init, run_jax as _run_jax_vit,
)
from tests.torch_shared import shared
from tests.torch_dp_worker import (
    FUNCTIONS, MODULES, REPO, bn_case, bn_inputs, launch,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- sync-BN ----------------------------------------------------------------

@pytest.fixture(scope="module")
def syncbn_ranks(request, tmp_path_factory):
    def compute():
        out = tmp_path_factory.mktemp("syncbn")
        launch(["tests/torch_dp_worker.py", "syncbn", str(out)])
        return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]

    return shared(request, tmp_path_factory, "torch_dp_syncbn", compute)


@pytest.mark.parametrize("name", FUNCTIONS + MODULES)
def test_sync_bn_two_ranks_equal_one_process(syncbn_ranks, name):
    x, r, dy, gamma, beta = bn_inputs()
    ref = bn_case(name, x, r, dy, gamma, beta)
    world = len(syncbn_ranks)
    got = {k: [res[f"{name}/{k}"] for res in syncbn_ranks] for k in ref}
    checks = {
        "y": np.concatenate(got["y"]),
        "dx": np.concatenate(got["dx"]) / world,
        "dgamma": np.mean(got["dgamma"], axis=0),
        "dbeta": np.mean(got["dbeta"], axis=0),
    }
    for k in ("mean", "var"):
        for rank_value in got[k]:
            np.testing.assert_allclose(rank_value, ref[k], atol=1e-5,
                                       rtol=1e-5, err_msg=f"{name} {k}")
    for k, v in checks.items():
        np.testing.assert_allclose(v, ref[k], atol=1e-5, rtol=1e-5,
                                   err_msg=f"{name} {k}")
    # The local sums are not the global ones: averaging is what makes
    # them right (summed, they would be twice the global dgamma).
    assert not np.allclose(got["dgamma"][0], ref["dgamma"], atol=1e-3)


# --- the loader -------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("micro", [1, 2, 4])
def test_loader_ranks_hold_jax_microbatches(world, micro):
    kw = dict(n=70, seq_len=4, vocab_size=1000)
    batch = 16
    jax_loaders = [jdata.DataLoader(
        jdata.SyntheticTokens(**kw), jdata.DataLoaderConfig(
            batch_size=batch, seed=5), shard_index=q, num_shards=world)
        for q in range(world)]
    port_loaders = [tdata.DataLoader(
        tdata.SyntheticTokens(**kw), tdata.DataLoaderConfig(
            batch_size=batch, seed=5), shard_index=p, num_shards=world,
        num_microbatches=micro) for p in range(world)]
    assert {len(lo) for lo in port_loaders} == {len(jax_loaders[0])}
    for epoch in range(2):
        for lo in jax_loaders + port_loaders:
            lo.set_epoch(epoch)
        steps = 0
        for jb, pb in zip(zip(*jax_loaders), zip(*port_loaders)):
            glob = {"tokens": np.concatenate([b["tokens"] for b in jb])}
            want = np.asarray(jax_split(glob, micro)["tokens"])
            m = batch // world // micro
            for i in range(micro):
                got = np.concatenate(
                    [b["tokens"][i * m:(i + 1) * m] for b in pb])
                np.testing.assert_array_equal(got, want[i])
            steps += 1
        assert steps == len(jax_loaders[0]) > 0


def test_loader_refuses_a_batch_that_does_not_deal():
    ds = tdata.SyntheticTokens(n=64, seq_len=4, vocab_size=10)
    with pytest.raises(ValueError, match="2 shards x 4 microbatches"):
        tdata.DataLoader(ds, tdata.DataLoaderConfig(batch_size=12),
                         shard_index=0, num_shards=2, num_microbatches=4)


def test_rank_rows_at_one_microbatch_is_the_shard_slice():
    rows = np.arange(12)
    for p in range(3):
        np.testing.assert_array_equal(rank_rows(rows, p, 3, 1),
                                      rows[p * 4:(p + 1) * 4])
    np.testing.assert_array_equal(rank_rows(rows, 1, 2, 2),
                                  [3, 4, 5, 9, 10, 11])


# --- train steps against JAX ------------------------------------------------

def _two_ranks(tmp_path, model: str, init: dict,
               extra: tuple = ()) -> list[dict]:
    path = tmp_path / "init.npz"
    np.savez(path, **{k: v.numpy() for k, v in init.items()})
    out = tmp_path / "out"
    launch(["-m", "pytorch_distributed_training_tpu_torch.tools.dp_check",
            "--model", model, "--device", "cpu", "--out", str(out),
            "--init", str(path), *extra])
    ranks = []
    for r in range(2):
        with open(out / f"rank{r}.json") as f:
            ranks.append({**json.load(f), **np.load(out / f"rank{r}.npz")})
    assert ranks[0]["checksums"] == ranks[1]["checksums"]
    assert len(set(ranks[0]["checksums"])) == dp_check.STEPS   # all moved
    assert ranks[0]["losses"] == ranks[1]["losses"]
    return ranks


def test_resnet_two_ranks_match_jax(tmp_path):
    cfg = CONFIGS["BasicBlock-fused"]
    _, params, stats = _jax_init(cfg)
    init = resnet_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                  jax.tree_util.tree_map(np.asarray, stats))
    ranks = _two_ranks(tmp_path, "resnet", init)
    batches = [(b["image"], b["label"]) for b in
               dp_check.global_batches("resnet", dp_check.STEPS, 8, 16, 1)]
    ref_losses, _, ref_state = _run_jax_resnet(
        cfg, params, stats, batches, opt="sgd", lr=0.05, wd=1e-3,
        accum=dp_check.ACCUM)
    np.testing.assert_allclose(ranks[0]["losses"], ref_losses, atol=1e-4,
                               rtol=0)
    got_params, got_stats = resnet_params_to_jax(
        {k: torch.from_numpy(ranks[0][k]) for k in init})
    _assert_tree_close(got_params, ref_state.params, 1e-4, "params")
    _assert_tree_close(got_stats, ref_state.batch_stats, 1e-4, "batch_stats")


def test_gpt2_two_ranks_match_jax(tmp_path):
    jm, params = _jax_params(SMALL)
    assert SMALL == dp_check.GPT2
    init = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    ranks = _two_ranks(tmp_path, "gpt2", init)
    batches = [b["tokens"] for b in
               dp_check.global_batches("gpt2", dp_check.STEPS, 8, 16, 1)]
    lr = 3e-4
    ref_losses, ref_params = _run_jax_gpt2(jm, params, batches, opt="adamw",
                                           lr=lr, wd=0.1,
                                           accum=dp_check.ACCUM)
    np.testing.assert_allclose(ranks[0]["losses"], ref_losses, rtol=1e-5)
    got = gpt2_params_to_jax(
        {k: torch.from_numpy(ranks[0][k]) for k in init})
    _assert_params_close(got, ref_params, atol=1e-5,
                         lr_bound=2 * dp_check.STEPS * lr)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_vit_two_ranks_match_jax(tmp_path, precision):
    assert {**VIT_SMALL, "patch_size": 16} == {**dp_check.VIT,
                                               "patch_size": 16}
    jm, params = _jax_vit_init(
        32, dtype=jax.numpy.bfloat16 if precision == "bf16" else
        jax.numpy.float32)
    init = vit_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    ranks = _two_ranks(tmp_path, "vit", init,
                       ("--image-size", "32", "--precision", precision))
    batches = [(b["image"], b["label"]) for b in
               dp_check.global_batches("vit", dp_check.STEPS, 8, 32, 1)]
    lr = 3e-4
    ref_losses, ref_state = _run_jax_vit(
        jm, params, batches, opt="adamw", lr=lr, wd=0.05,
        accum=dp_check.ACCUM, precision=precision)
    if precision == "bf16":
        np.testing.assert_allclose(ranks[0]["losses"], ref_losses,
                                   atol=2e-2, rtol=0)
        return
    np.testing.assert_allclose(ranks[0]["losses"], ref_losses, rtol=1e-5)
    got = vit_params_to_jax({k: torch.from_numpy(ranks[0][k]) for k in init})
    _assert_params_close(got, jax.tree_util.tree_map(np.asarray,
                                                     ref_state.params),
                         atol=1e-5, lr_bound=2 * dp_check.STEPS * lr)


# --- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("model", ["gpt2", "resnet18", "vit_b16"])
def test_cli_distributed_on_two_cpu_ranks(tmp_path, model):
    if model == "gpt2":
        extra = ["--dataset", "synthetic-tokens", "--seq-len", "32",
                 "--model-overrides", "num_layers=2,hidden_dim=64,"
                 "num_heads=2,vocab_size=256,max_seq_len=64",
                 "--accum-steps", "2"]
    elif model == "vit_b16":
        extra = ["--dataset", "cifar10", "--synthetic-data",
                 "--model-overrides", "depth=2,hidden_dim=64,num_heads=4,"
                 "mlp_dim=128", "--optimizer", "adamw", "--learning-rate",
                 "5e-4", "--precision", "bf16", "--accum-steps", "2"]
    else:
        extra = ["--dataset", "cifar10", "--synthetic-data",
                 "--model-overrides", "num_filters=8,small_stem=true",
                 "--optimizer", "sgd", "--learning-rate", "0.05"]
    metrics = tmp_path / "m.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "pytorch_distributed_training_tpu_torch.cli.main", "--distributed",
         "--use-cpu", "--model", model, "--batch-size", "8",
         "--steps-per-epoch", "2", "--num-workers", "0", "--metrics-jsonl",
         str(metrics), *extra],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "process 0/2 | backend=cpu | devices=1" in out
    assert "process 1/2 | backend=cpu | devices=1" in out
    assert "Process group initialized - WORLD_SIZE: 2, RANK: 1" in out
    assert out.count("training finished") == 2
    records = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert len(records) == 1                    # rank 0 logs, once
    assert records[0]["step"] == 2 and records[0]["examples"] == 16
    assert np.isfinite(records[0]["loss"])
