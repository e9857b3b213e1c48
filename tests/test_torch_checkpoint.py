"""The PyTorch port's checkpoints (``checkpoint/manager.py``), twins of the
JAX package's manager tests (``tests/test_resilience.py``), and the
cross-framework resume through ``models/convert.py``.

- Round trip: step, parameters, moments, momentum, counters and
  ``batch_stats`` come back bit for bit into a state of other weights,
  and the next step matches the uninterrupted run's.
- Async saves stage host copies: a step taken while the writer is held
  back never reaches the committed bytes (the torn-save check).
- Crash wreckage (an uncommitted tmp directory) is invisible; the
  manifest is written; a truncated newest step falls back and is deleted;
  a checksum-proven step is deleted; every step failing raises; a
  template mismatch raises and deletes nothing; a restore whose rank-0
  walk fails raises on both of two gloo ranks; the same-step dedupe; a
  re-save replaces a step that failed to deserialize; ``max_to_keep``
  retires steps with their manifests; ``restore_params``; the
  ``ckpt_truncate`` fault.
- Across frameworks: JAX trains k steps with ``make_train_step`` and
  saves through its own ``CheckpointManager``; the restored arrays go
  through ``train_state_from_jax`` and the port continues m steps beside
  JAX's continuation (ResNet with adam and sgd within 1e-4, statistics
  included; GPT-2 with adamw, warmup-cosine and clip within rtol 1e-5);
  ``train_state_to_jax`` gives back the JAX arrays exactly.
- ``--serve --checkpoint-dir``: the restore line, and greedy tokens equal
  to an engine built on the trained model; the two warnings without a
  committed step.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from pytorch_distributed_training_tpu.train import (
    TrainState as JaxTrainState, make_policy as jax_policy,
    make_train_step as jax_train_step,
)
from pytorch_distributed_training_tpu_torch.checkpoint import (
    CheckpointManager,
)
from pytorch_distributed_training_tpu_torch.cli.main import (
    build_optimizer, build_schedule, main as cli_main,
)
from pytorch_distributed_training_tpu_torch.models import (
    create_model, gpt2_params_to_jax, resnet_params_to_jax,
    train_state_from_jax, train_state_to_jax,
)
from pytorch_distributed_training_tpu_torch.resilience import (
    FaultInjector, parse_faults, truncate_checkpoint,
)
from pytorch_distributed_training_tpu_torch.train import (
    create_train_state, make_train_step,
)
from tests import test_torch_resnet as tr
from tests import test_torch_train as tt
from tests.torch_dp_worker import launch

GPT2 = dict(num_layers=2, hidden_dim=32, num_heads=2, vocab_size=64,
            max_seq_len=32)
RESNET = {"stage_sizes": (1, 1), "num_filters": 8, "small_stem": True}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(kind: str, seed: int = 0):
    """A small state and its step function: a ResNet with sgd momentum
    (``batch_stats``, a ``trace``) or a GPT-2 with adamw under
    warmup-cosine and a clip (Adam's and the schedule's counters)."""
    if kind == "resnet":
        model = create_model("resnet18", num_classes=10, device="cpu",
                             seed=seed, cfg_overrides=RESNET)
        tx = build_optimizer("sgd", 0.05, weight_decay=1e-3)
        step = make_train_step(kind="image_classifier")
    else:
        model = create_model("gpt2", device="cpu", seed=seed,
                             cfg_overrides=GPT2)
        lr = build_schedule("warmup-cosine", 1e-3, total_steps=8,
                            warmup_steps=2)
        tx = build_optimizer("adamw", lr, weight_decay=0.1, grad_clip=1.0)
        step = make_train_step(kind="lm")
    return create_train_state(model, tx), step


def _batch(kind: str, i: int) -> dict:
    rng = np.random.default_rng(100 + i)
    if kind == "resnet":
        return {"image": torch.from_numpy(rng.random((4, 16, 16, 3),
                                                     np.float32)),
                "label": torch.from_numpy(rng.integers(0, 10, 4))}
    return {"tokens": torch.from_numpy(rng.integers(0, 64, (4, 16)))}


def _train(state, step, kind, steps, start=0):
    for i in range(start, start + steps):
        state, _ = step(state, _batch(kind, i))
    return state


def _tensors(state) -> dict:
    from pytorch_distributed_training_tpu_torch.checkpoint.manager import (
        flatten_state,
    )

    tensors, scalars = flatten_state(state)
    return {**{k: v.detach().clone() for k, v in tensors.items()},
            **scalars}


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _fill(state, value: float):
    with torch.no_grad():
        for p in state.params.values():
            p.fill_(value)
    return state


# --- round trip and async staging --------------------------------------------

@pytest.mark.parametrize("kind", ["resnet", "gpt2"])
def test_round_trip_is_bitwise_and_resumes_the_run(tmp_path, kind):
    state, step = _state(kind)
    state = _train(state, step, kind, 3)
    saved = _tensors(state)
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(state)
    other, _ = _state(kind, seed=1)
    restored = CheckpointManager(str(tmp_path)).restore_latest(other)
    assert restored.step == 3
    _assert_same(_tensors(restored), saved)
    # The live tensors were filled, not rebound.
    assert all(restored.params[n] is p
               for n, p in dict(restored.model.named_parameters()).items())
    # The counters matter: the next steps match the uninterrupted run.
    ref = _train(state, step, kind, 2, start=3)
    got = _train(restored, step, kind, 2, start=3)
    _assert_same(_tensors(got), _tensors(ref))


def test_async_save_stages_host_copies(tmp_path, monkeypatch):
    """The writer is held back until a step has updated the state in
    place: the committed bytes are still the state at the save."""
    state, step = _state("resnet")
    state = _train(state, step, "resnet", 1)
    at_save = _tensors(state)
    gate = threading.Event()
    real_save = torch.save

    def held(obj, path, *a, **kw):
        assert gate.wait(30)
        return real_save(obj, path, *a, **kw)

    monkeypatch.setattr(torch, "save", held)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state)
    assert mgr.all_steps() == []               # not committed yet
    assert all(mgr._buffers[n].data_ptr() != t.data_ptr() for n, t in
               [(f"params/{k}", v) for k, v in state.params.items()])
    state = _train(state, step, "resnet", 1, start=1)
    gate.set()
    mgr.close()
    monkeypatch.setattr(torch, "save", real_save)
    restored = CheckpointManager(str(tmp_path)).restore_latest(
        _state("resnet", seed=1)[0])
    _assert_same(_tensors(restored), at_save)
    assert not torch.equal(state.params["head.weight"],
                           at_save["params/head.weight"])


def test_crash_wreckage_is_invisible(tmp_path):
    state, _ = _state("gpt2")
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(state, step=3)
    wreck = tmp_path / "7.tmp-4242"
    wreck.mkdir()
    (wreck / "tensors.pt").write_bytes(b"half a checkpoint")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [3]
    assert mgr.restore_latest(_state("gpt2", seed=1)[0]).step == 3


# --- the manifest and the fallback rules --------------------------------------

def test_manifest_written_and_restore_verified(tmp_path):
    state, _ = _state("resnet")
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(_fill(state, 1.0), step=1)
    doc = CheckpointManager(str(tmp_path)).manifest(1)
    assert doc["step"] == 1
    assert any(k.startswith("batch_stats/") for k in doc["leaves"])
    assert "opt_state/1/0/head.weight" in doc["leaves"]   # the momentum
    assert all({"crc32", "dtype", "shape"} <= set(r)
               for r in doc["leaves"].values())
    assert doc["files"]["tensors.pt"] == os.path.getsize(
        tmp_path / "1" / "tensors.pt")
    restored = CheckpointManager(str(tmp_path)).restore_latest(
        _state("resnet", seed=1)[0])
    assert restored.step == 1
    assert float(restored.params["head.weight"][0, 0].detach()) == 1.0


def test_truncated_newest_step_falls_back_and_is_deleted(tmp_path):
    state, _ = _state("resnet")
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(_fill(state, 1.0), step=1, wait=True)
        mgr.save(_fill(state, 2.0), step=2, wait=True)
    truncate_checkpoint(str(tmp_path), 2)
    anomalies = []
    fresh = CheckpointManager(
        str(tmp_path), on_anomaly=lambda kind, **f: anomalies.append((kind,
                                                                      f)))
    restored = fresh.restore_latest(_state("resnet", seed=1)[0])
    assert restored.step == 1
    assert float(restored.params["head.weight"][0, 0].detach()) == 1.0
    assert anomalies[0][0] == "checkpoint_restore_failed"
    assert anomalies[0][1]["step"] == 2 and anomalies[0][1]["deleted"]
    assert fresh.all_steps() == [1]
    assert not (tmp_path / "manifest-2.json").exists()


def test_all_checkpoints_corrupt_raises_not_fresh_start(tmp_path):
    state, _ = _state("resnet")
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(state, step=1)
    truncate_checkpoint(str(tmp_path), 1)
    fresh = CheckpointManager(str(tmp_path), on_anomaly=lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="no committed checkpoint"):
        fresh.restore_latest(_state("resnet", seed=1)[0])
    empty = CheckpointManager(str(tmp_path / "empty"))
    assert empty.restore_latest(_state("resnet", seed=1)[0]) is None


def test_checksum_proven_corruption_drops_step(tmp_path):
    state, _ = _state("gpt2")
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(_fill(state, 1.0), step=1, wait=True)
        mgr.save(_fill(state, 2.0), step=2, wait=True)
    manifest = tmp_path / "manifest-2.json"
    doc = json.loads(manifest.read_text())
    doc["leaves"]["params/wte"]["crc32"] ^= 0xFFFF
    manifest.write_text(json.dumps(doc))
    anomalies = []
    fresh = CheckpointManager(
        str(tmp_path), on_anomaly=lambda kind, **f: anomalies.append(f))
    restored = fresh.restore_latest(_state("gpt2", seed=1)[0])
    assert restored.step == 1
    assert anomalies[0]["deleted"] is True
    assert "CheckpointCorrupted" in anomalies[0]["error"]
    assert fresh.all_steps() == [1]
    assert not manifest.exists()


def test_checksum_catches_a_bitflip(tmp_path):
    state, _ = _state("gpt2")
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(state, step=1, wait=True)
        mgr.save(state, step=2, wait=True)
    path = tmp_path / "2" / "tensors.pt"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    fresh = CheckpointManager(str(tmp_path), on_anomaly=lambda *a, **k: None)
    assert fresh.restore_latest(_state("gpt2", seed=1)[0]).step == 1


def test_template_mismatch_raises_and_deletes_nothing(tmp_path):
    state, _ = _state("gpt2")
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(state, step=1)
    wider = create_model("gpt2", device="cpu", seed=0,
                         cfg_overrides={**GPT2, "hidden_dim": 64})
    template = create_train_state(wider, build_optimizer(
        "adamw", 1e-3, weight_decay=0.1))
    anomalies = []
    fresh = CheckpointManager(
        str(tmp_path), on_anomaly=lambda kind, **f: anomalies.append(f))
    with pytest.raises(RuntimeError, match="no committed checkpoint") as e:
        fresh.restore_latest(template)
    assert "ValueError" in str(e.value) and "structure mismatch" in str(
        e.value)
    assert anomalies[0]["deleted"] is False
    assert fresh.all_steps() == [1]
    assert (tmp_path / "manifest-1.json").exists()


def test_a_failed_walk_on_rank_0_raises_on_every_rank(tmp_path):
    # Rank 0 cannot list the directory (an error outside the per-step
    # checks): it raises its own error, the other rank raises rank 0's at
    # once instead of waiting in the outcome's broadcast.
    launch(["tests/torch_dp_worker.py", "restore_error", str(tmp_path)],
           timeout=60)
    r = [np.load(tmp_path / f"rank{i}.npz") for i in range(2)]
    assert str(r[0]["type"]) == "PermissionError"
    assert str(r[1]["type"]) == "RuntimeError"
    assert str(r[1]["msg"]) == ("rank 0's restore failed: PermissionError: "
                                "the checkpoint directory cannot be listed")


def test_save_dedupes_the_same_step(tmp_path):
    state, _ = _state("resnet")
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(_fill(state, 1.0), step=3, wait=True)
        mgr.save(_fill(state, 99.0), step=3, wait=True)
        assert mgr.all_steps() == [3]
    # A fresh manager (a relaunch) dedupes against the directory.
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(_fill(state, 7.0), step=3, wait=True)
    restored = CheckpointManager(str(tmp_path)).restore_latest(
        _state("resnet", seed=1)[0])
    assert float(restored.params["head.weight"][0, 0].detach()) == 1.0


def test_resave_replaces_a_step_that_failed_to_load(tmp_path):
    """A step that fails to DESERIALIZE is not checksum-proven, so it is
    kept — but the resumed run's save at the same counter replaces it
    instead of deduping against the unreadable bytes."""
    state, _ = _state("resnet")
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(_fill(state, 1.0), step=1, wait=True)
        mgr.save(_fill(state, 2.0), step=2, wait=True)
    (tmp_path / "2" / "scalars.json").write_text("{")
    anomalies = []
    fresh = CheckpointManager(
        str(tmp_path), on_anomaly=lambda kind, **f: anomalies.append(f))
    restored = fresh.restore_latest(_state("resnet", seed=1)[0])
    assert restored.step == 1
    assert anomalies[0]["step"] == 2 and anomalies[0]["deleted"] is False
    assert fresh.all_steps() == [1, 2]
    fresh.save(_fill(state, 5.0), step=2, wait=True)
    assert fresh.all_steps() == [1, 2]
    replaced = CheckpointManager(str(tmp_path)).restore_latest(
        _state("resnet", seed=1)[0])
    assert replaced.step == 2
    assert float(replaced.params["head.weight"][0, 0].detach()) == 5.0


def test_max_to_keep_retires_steps_with_their_manifests(tmp_path):
    state, _ = _state("gpt2")
    (tmp_path / "manifest-9.json").write_text("{}")   # a step never made
    with CheckpointManager(str(tmp_path), max_to_keep=2) as mgr:
        for s in range(1, 5):
            mgr.save(state, step=s)
    assert mgr.all_steps() == [3, 4]
    assert sorted(p.name for p in tmp_path.glob("manifest-*.json")) == [
        "manifest-3.json", "manifest-4.json"]


def test_restore_params_for_serving(tmp_path):
    state, step = _state("gpt2")
    state = _train(state, step, "gpt2", 1)
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(state, step=1, wait=True)
        mgr.save(_fill(state, 3.0), step=2, wait=True)
    manifest = tmp_path / "manifest-2.json"
    doc = json.loads(manifest.read_text())
    doc["leaves"]["params/wpe"]["crc32"] ^= 1
    manifest.write_text(json.dumps(doc))
    got = CheckpointManager(str(tmp_path),
                            on_anomaly=lambda *a, **k: None).restore_params()
    assert got.keys() == state.params.keys()
    restored = CheckpointManager(str(tmp_path / "one"))
    assert restored.restore_params() is None
    ref = CheckpointManager(str(tmp_path)).load_tensors(1)
    for n, t in got.items():
        assert torch.equal(t, ref[f"params/{n}"]), n


def test_ckpt_truncate_fault_corrupts_a_committed_step(tmp_path):
    state, _ = _state("resnet")
    inj = FaultInjector(parse_faults("ckpt_truncate@2"),
                        state_dir=str(tmp_path / "fs"))
    with CheckpointManager(str(tmp_path / "ck"), fault_injector=inj) as mgr:
        mgr.save(state, step=1, wait=True)
        mgr.save(state, step=2)              # async; the fault waits
    anomalies = []
    fresh = CheckpointManager(str(tmp_path / "ck"),
                              on_anomaly=lambda kind, **f: anomalies.append(
                                  kind))
    assert fresh.restore_latest(_state("resnet", seed=1)[0]).step == 1
    assert anomalies == ["checkpoint_restore_failed"]
    inj2 = FaultInjector(parse_faults("ckpt_truncate@2"),
                         state_dir=str(tmp_path / "fs"))
    with CheckpointManager(str(tmp_path / "ck"),
                           fault_injector=inj2) as mgr2:
        mgr2.save(state, step=3, wait=True)
    assert CheckpointManager(str(tmp_path / "ck")).restore_latest(
        _state("resnet", seed=1)[0]).step == 3


# --- across frameworks --------------------------------------------------------

def _jax_save_restore(tmp_path, state, fresh):
    """Save ``state`` through the JAX manager and restore it into
    ``fresh``: the arrays a JAX run resumes from, as numpy."""
    with JaxCheckpointManager(str(tmp_path / "jax")) as mgr:
        mgr.save(state, wait=True)
    restored = JaxCheckpointManager(str(tmp_path / "jax")).restore_latest(
        fresh)
    return jax.tree_util.tree_map(np.asarray, {
        "step": restored.step, "params": restored.params,
        "opt_state": restored.opt_state,
        "batch_stats": restored.batch_stats})


def _assert_exact_to_jax(port_state, arrays, scheduled=True):
    out = train_state_to_jax(port_state, scheduled=scheduled)
    assert int(out["step"]) == int(arrays["step"])
    for key in ("params", "batch_stats", "opt_state"):
        want = jax.tree_util.tree_leaves(arrays[key])
        got = jax.tree_util.tree_leaves(out[key])
        assert len(want) == len(got), key
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=key)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_jax_saved_resnet_continues_in_the_port(tmp_path, opt):
    cfg = tr.CONFIGS["BasicBlock-fused"]
    jm, params, stats = tr._jax_init(cfg)
    k, m, lr, wd = 2, 2, 0.01, 1e-3
    batches = [tr._images(seed=10 + i) for i in range(k + m)]
    tx = tr._optax_tx(opt, lr, wd)

    def jax_state(p, s):
        p = jax.tree_util.tree_map(jnp.array, p)
        return JaxTrainState(step=jnp.zeros((), jnp.int32), params=p,
                             opt_state=tx.init(p),
                             batch_stats=jax.tree_util.tree_map(jnp.array, s),
                             apply_fn=jm.apply, tx=tx)

    step = jax_train_step(kind="image_classifier", policy=jax_policy("f32"))
    state = jax_state(params, stats)
    for x, y in batches[:k]:
        state, _ = step(state, {"image": jnp.asarray(x),
                                "label": jnp.asarray(y)})
    arrays = _jax_save_restore(tmp_path, state, jax_state(params, stats))
    ref_losses = []
    for x, y in batches[k:]:
        state, mets = step(state, {"image": jnp.asarray(x),
                                   "label": jnp.asarray(y)})
        ref_losses.append(float(mets["loss"]))

    model = tr._port_model(cfg, params, stats)
    port = create_train_state(model, build_optimizer(opt, lr,
                                                     weight_decay=wd))
    port = train_state_from_jax(arrays, port)
    assert port.step == k
    _assert_exact_to_jax(port, arrays, scheduled=False)    # a constant rate
    tstep = make_train_step(kind="image_classifier")
    losses = []
    for x, y in batches[k:]:
        port, mets = tstep(port, {"image": torch.from_numpy(x),
                                  "label": torch.from_numpy(y)})
        losses.append(float(mets["loss"]))
    np.testing.assert_allclose(losses, ref_losses, atol=1e-4, rtol=0)
    got_params, got_stats = resnet_params_to_jax(
        {**port.params, **port.batch_stats})
    tr._assert_tree_close(got_params, state.params, 1e-4, "params")
    tr._assert_tree_close(got_stats, state.batch_stats, 1e-4, "batch_stats")


def test_jax_saved_gpt2_continues_in_the_port(tmp_path, small_init):
    jm, params = small_init
    k, m, lr, wd, clip = 2, 2, 1e-3, 0.1, 1.0
    batches = tt._batches(n=k + m)
    tx = tt._optax_tx("adamw", tt._optax_schedule("warmup-cosine", lr,
                                                  k + m, 2), wd, clip)

    def jax_state():
        p = jax.tree_util.tree_map(jnp.array, params)
        return JaxTrainState(step=jnp.zeros((), jnp.int32), params=p,
                             opt_state=tx.init(p), batch_stats={},
                             apply_fn=jm.apply, tx=tx)

    step = jax_train_step(kind="lm", policy=jax_policy("f32"))
    state = jax_state()
    for b in batches[:k]:
        state, _ = step(state, {"tokens": jnp.asarray(b)})
    arrays = _jax_save_restore(tmp_path, state, jax_state())
    ref_losses = []
    for b in batches[k:]:
        state, mets = step(state, {"tokens": jnp.asarray(b)})
        ref_losses.append(float(mets["loss"]))

    model = tt._port_model(params, tt.SMALL)
    port = create_train_state(model, build_optimizer(
        "adamw", build_schedule("warmup-cosine", lr, total_steps=k + m,
                                warmup_steps=2),
        weight_decay=wd, grad_clip=clip))
    port = train_state_from_jax(arrays, port)
    assert port.opt_state[1][2].count == k      # the schedule's count
    _assert_exact_to_jax(port, arrays)
    tstep = make_train_step(kind="lm")
    losses = []
    for b in batches[k:]:
        port, mets = tstep(port, {"tokens": torch.from_numpy(b)})
        losses.append(float(mets["loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    tt._assert_params_close(gpt2_params_to_jax(port.params),
                            jax.tree_util.tree_map(np.asarray, state.params),
                            atol=1e-5, lr_bound=2 * (k + m) * lr)


@pytest.fixture(scope="module")
def small_init():
    return tt._jax_params(tt.SMALL)


# --- serving a checkpoint -----------------------------------------------------

SERVE = ["--serve", "--use-cpu", "--model", "gpt2", "--model-overrides",
         "num_layers=2,hidden_dim=32,num_heads=2,vocab_size=64,"
         "max_seq_len=32", "--seq-len", "16", "--serve-requests", "4",
         "--serve-slots", "2", "--serve-max-new", "6"]


def test_serve_restores_the_trained_params(tmp_path, capsys, monkeypatch):
    ckpt = str(tmp_path / "ck")
    trainer = cli_main([
        "--use-cpu", "--model", "gpt2", "--dataset", "synthetic-tokens",
        "--seq-len", "16", "--model-overrides",
        "num_layers=2,hidden_dim=32,num_heads=2,vocab_size=64,max_seq_len=32",
        "--batch-size", "4", "--steps-per-epoch", "3", "--num-workers", "0",
        "--learning-rate", "3e-3", "--checkpoint-dir", ckpt])
    capsys.readouterr()
    served = cli_main([*SERVE, "--checkpoint-dir", ckpt])
    out = capsys.readouterr().out
    assert f"serving params restored from {ckpt}" in out
    assert "FRESH-INIT" not in out
    assert "completed=4" in out

    # An engine built on the trained model itself serves the same tokens.
    import pytorch_distributed_training_tpu_torch.models as models

    trained = trainer.state.model.eval()
    monkeypatch.setattr(models, "create_model", lambda *a, **k: trained)
    direct = cli_main(SERVE)
    assert served["tokens"] == direct["tokens"]
    assert len(served["tokens"]) == 4


def test_serve_warns_without_a_committed_step(tmp_path, capsys):
    empty = str(tmp_path / "none")
    cli_main([*SERVE, "--checkpoint-dir", empty])
    out = capsys.readouterr().out
    assert f"warning: no committed checkpoint in {empty}" in out
    assert ("warning: serving FRESH-INIT weights (pass --checkpoint-dir "
            "with a trained run for real outputs)") in out
