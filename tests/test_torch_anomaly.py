"""The port's skip gate and recovery (``resilience/anomaly.py``,
``resilience/recovery.py``, the gated optimizer of ``train/optim.py``),
twins of ``tests/test_resilience.py``'s skip-policy, recovery and trainer
cases, on small models on the host:

- a NaN or spiking step leaves the parameters, the optimizer state (its
  counts included) and ``batch_stats`` bitwise as they were, advances
  ``step`` and counts the skip; the policy without the state's counters
  raises;
- with nothing firing, the gated run is bitwise the ungated one (GPT-2
  under adamw with warmup-cosine and a clip; a ResNet under sgd with
  momentum and under adam);
- a NaN batch at step 2 of 4 stays within rtol 1e-5 of JAX's guarded
  ``make_train_step`` (a small ViT, adamw under warmup-cosine): the
  learning rate and Adam's bias correction after the skip are JAX's;
- rollback and abort, the snapshot cadence, the trainer's skip, rollback
  and abort;
- the counters through a checkpoint (and a checkpoint saved without the
  gate restoring them at 0), preempt-and-resume bitwise with the gate
  and with ``--device-cache``, the CLI's flags and the supervisor
  relaunching an aborted run.
"""

import dataclasses
import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tpu.resilience import (
    AnomalyPolicy as JaxPolicy, init_resilience_state as jax_resilience,
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
from pytorch_distributed_training_tpu_torch.data import (
    DataLoader, DataLoaderConfig, DeviceCachedImages, SyntheticImages,
)
from pytorch_distributed_training_tpu_torch.models import (
    create_model, vit_params_to_jax,
)
from pytorch_distributed_training_tpu_torch.resilience import (
    AnomalyPolicy, FaultInjector, Preempted, PreemptionHandler,
    RecoveryAborted, RecoveryConfig, RecoveryManager, ResilienceState,
    init_resilience_state, parse_faults,
)
from pytorch_distributed_training_tpu_torch.train import (
    Trainer, TrainerConfig, create_train_state, make_train_step,
)
from pytorch_distributed_training_tpu_torch.train.optim import AdamState
from tests.test_torch_train import _assert_params_close
from tests.test_torch_vit import _jax_init, _port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _guarded(state):
    return dataclasses.replace(state, resilience=init_resilience_state("cpu"))


def _resnet(opt="sgd", guard=True, threshold=None, seed=0):
    model = create_model("resnet18", num_classes=10, device="cpu", seed=seed,
                         cfg_overrides={"stage_sizes": (1, 1),
                                        "num_filters": 8, "small_stem": True})
    state = create_train_state(model, build_optimizer(
        opt, 0.05 if opt == "sgd" else 1e-3, weight_decay=1e-3))
    policy = AnomalyPolicy(threshold) if guard else None
    return (_guarded(state) if guard else state,
            make_train_step(kind="image_classifier", anomaly_policy=policy))


def _gpt2(guard=True, threshold=None):
    model = create_model("gpt2", device="cpu", seed=0, cfg_overrides=dict(
        num_layers=2, hidden_dim=32, num_heads=2, vocab_size=64,
        max_seq_len=32))
    tx = build_optimizer("adamw", build_schedule(
        "warmup-cosine", 1e-2, total_steps=6, warmup_steps=2),
        weight_decay=0.1, grad_clip=1.0)
    state = create_train_state(model, tx)
    policy = AnomalyPolicy(threshold) if guard else None
    return (_guarded(state) if guard else state,
            make_train_step(kind="lm", anomaly_policy=policy))


def _images(rng, n=4):
    return {"image": torch.from_numpy(rng.random((n, 8, 8, 3), np.float32)),
            "label": torch.from_numpy(rng.integers(0, 10, n).astype(
                np.int32))}


def _tokens(rng):
    return {"tokens": torch.from_numpy(rng.integers(0, 64, (4, 16)))}


def _learned(state) -> dict:
    """Every tensor a skipped step must leave alone, cloned."""
    from pytorch_distributed_training_tpu_torch.checkpoint.manager import (
        flatten_state,
    )

    return {n: t.clone() for n, t in flatten_state(state)[0].items()
            if not n.startswith("resilience/")}


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n


# --- the gate ---------------------------------------------------------------------

def test_guarded_step_skips_nan_and_spike_and_counts():
    """A NaN batch, then a finite step over the threshold (the norm's
    threshold set below this batch's: BatchNorm after the stem cancels an
    input scale, so a scaled batch would not spike this model)."""
    state, step = _resnet(opt="adam", threshold=100.0)
    spike_step = make_train_step(kind="image_classifier",
                                 anomaly_policy=AnomalyPolicy(1e-3))
    rng = np.random.default_rng(0)
    good = _images(rng)
    nan = {"image": torch.full_like(good["image"], float("nan")),
           "label": good["label"]}

    s1, m1 = step(state, good)
    assert int(m1["skipped"]) == 0 and int(m1["bad_streak"]) == 0
    assert m1["skipped"].dtype == torch.int32
    before = _learned(s1)
    count = s1.opt_state[1].count           # Adam's, a device tensor now
    assert isinstance(count, torch.Tensor) and int(count) == 1

    s2, m2 = step(s1, nan)
    assert int(m2["skipped"]) == 1 and int(m2["bad_streak"]) == 1
    assert not np.isfinite(float(m2["loss"]))
    _assert_same(_learned(s2), before)      # params, moments, counts, stats
    assert s2.step == 2                     # the step still advances

    s3, m3 = spike_step(s2, good)           # finite, over the threshold
    assert np.isfinite(float(m3["loss"])) and float(m3["grad_norm"]) > 1e-3
    assert int(m3["skipped"]) == 1 and int(m3["bad_streak"]) == 2
    _assert_same(_learned(s3), before)

    s4, m4 = step(s3, good)
    assert int(m4["skipped"]) == 0 and int(m4["bad_streak"]) == 0
    assert int(m4["skipped_total"]) == 2
    assert int(s4.opt_state[1].count) == 2
    assert not torch.equal(s4.params["head.weight"], before[
        "params/head.weight"])


def test_guarded_step_requires_resilience_state():
    state, step = _resnet()
    state = dataclasses.replace(state, resilience=())
    with pytest.raises(ValueError, match="resilience"):
        step(state, _images(np.random.default_rng(0)))


@pytest.mark.parametrize("case", ["gpt2-adamw-warmup-cosine-clip",
                                  "resnet-sgd-momentum", "resnet-adam"])
def test_no_fault_policy_is_bitwise_noop(case):
    """With nothing firing, gated and ungated runs give bitwise the same
    losses and end states (the gated update's tables hold the host
    path's values rounded once, as its scalars are)."""
    if case.startswith("gpt2"):
        make, batch = (lambda guard: _gpt2(guard, threshold=1e9)), _tokens
    else:
        opt = case.split("-")[1]
        make, batch = (lambda guard: _resnet(opt, guard)), _images
    (off, off_step), (on, on_step) = make(False), make(True)
    rng = np.random.default_rng(1)
    for i in range(8):          # past the schedule's horizon of 6
        b = batch(rng)
        off, mo = off_step(off, b)
        on, mn = on_step(on, b)
        assert float(mo["loss"]) == float(mn["loss"]), i
        assert int(mn["skipped"]) == 0
    want = {n: t for n, t in _learned(off).items() if t.is_floating_point()}
    got = {n: t for n, t in _learned(on).items() if t.is_floating_point()}
    _assert_same(got, want)


class _NoHostReads(torch.overrides.TorchFunctionMode):
    """Fails every torch call that reads a tensor's value back to the
    host (on a card, each would wait for the device), a subscript by a
    0-dim integer or a boolean tensor among them."""

    READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.cpu,
             torch.Tensor.numpy, torch.Tensor.__bool__, torch.Tensor.__int__,
             torch.Tensor.__float__, torch.Tensor.__index__,
             torch.Tensor.nonzero, torch.nonzero}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        assert func not in self.READS, f"host read: {func.__name__}"
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            for i in index:
                assert not (isinstance(i, torch.Tensor) and (
                    i.dtype == torch.bool or (i.dim() == 0 and not
                                              i.is_floating_point()))), \
                    f"host read: a subscript by {i.dtype} {tuple(i.shape)}"
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["gpt2-adamw-warmup-cosine-clip",
                                  "resnet-sgd-momentum", "resnet-adam"])
def test_warm_gated_step_reads_nothing_back(case):
    """After the first gated step (the counts and the optimizer's tables
    uploaded once) a gated step reads no device value on the host: the lr
    and the bias corrections come from their tables on the device."""
    if case.startswith("gpt2"):
        (state, step), batch = _gpt2(), _tokens
    else:
        (state, step), batch = _resnet(case.split("-")[1]), _images
    rng = np.random.default_rng(1)
    state, _ = step(state, batch(rng))
    with _NoHostReads():
        for _ in range(2):
            state, m = step(state, batch(rng))
    assert int(m["skipped_total"]) == 0 and state.step == 3


def _vit_batches(n=4, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, 2).astype(np.int32)) for _ in range(n)]


def test_nan_at_step_2_of_4_tracks_jaxs_guarded_step():
    """A NaN batch at step 2 of 4 through JAX's and the port's guarded
    steps (adamw under warmup-cosine with horizon 4, clip 1.0): the same
    skip, the same counters, and every later step's loss and the final
    weights within rtol 1e-5 — which holds only if the skipped step
    moved neither the schedule's position nor the bias correction."""
    jm, params = _jax_init(32)
    batches = _vit_batches()
    nan = np.full_like(batches[1][0], np.nan)
    batches[1] = (nan, batches[1][1])
    lr, total = 3e-4, 4
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=1,
                                               decay_steps=total)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=0.05))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=jax.tree_util.tree_map(jnp.array, params),
                           opt_state=tx.init(params), batch_stats={},
                           apply_fn=jm.apply, tx=tx,
                           resilience=jax_resilience())
    jstep = jax_train_step(kind="image_classifier", policy=jax_policy("f32"),
                           anomaly_policy=JaxPolicy())
    model = _port(params, 32)
    state = _guarded(create_train_state(model, build_optimizer(
        "adamw", build_schedule("warmup-cosine", lr, total_steps=total,
                                warmup_steps=1),
        weight_decay=0.05, grad_clip=1.0)))
    step = make_train_step(kind="image_classifier",
                           anomaly_policy=AnomalyPolicy())
    for i, (x, y) in enumerate(batches):
        jstate, jm_ = jstep(jstate, {"image": jnp.asarray(x),
                                     "label": jnp.asarray(y)})
        state, m = step(state, {"image": torch.from_numpy(x),
                                "label": torch.from_numpy(y)})
        for k in ("skipped", "bad_streak", "skipped_total"):
            assert int(m[k]) == int(jm_[k]), (i, k)
        if i == 1:
            assert int(m["skipped"]) == 1
            continue
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-5)
    _assert_params_close(vit_params_to_jax(state.params),
                         jax.tree_util.tree_map(np.asarray, jstate.params),
                         atol=1e-5, lr_bound=2 * total * lr)
    # clip, then adamw's (scale_by_adam, decay, schedule): three applied
    # updates of four
    j_adam, _, j_sched = jstate.opt_state[1]
    adam, _, sched = state.opt_state[1]
    assert isinstance(adam, AdamState)
    assert int(adam.count) == int(j_adam.count) == 3
    assert int(sched.count) == int(j_sched.count) == 3


# --- recovery ---------------------------------------------------------------------

def test_recovery_rollback_and_abort():
    state, _ = _resnet()
    rec = RecoveryManager(RecoveryConfig(rollback_after=3, max_rollbacks=1))
    rec.stage(state, 10)
    snap = _learned(state)
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
    state.resilience.bad_streak.fill_(5)
    state.resilience.skipped_total.fill_(7)
    # below the threshold: untouched
    assert rec.observe(state, 11, bad_streak=2) is state
    # at it: rolled back; the streak resets, the run's total does not
    back = rec.observe(state, 12, bad_streak=3)
    _assert_same(_learned(back), snap)
    assert int(back.resilience.bad_streak) == 0
    assert int(back.resilience.skipped_total) == 7
    assert back.step == state.step and rec.rollbacks == 1
    with pytest.raises(RecoveryAborted):
        rec.observe(back, 13, bad_streak=4)


def test_recovery_snapshot_cadence():
    state, _ = _resnet()
    rec = RecoveryManager(RecoveryConfig(snapshot_every_steps=10))
    rec.maybe_stage(state, 0)
    assert rec._snapshot_step == 0
    rec.maybe_stage(state, 5)
    assert rec._snapshot_step == 0
    rec.maybe_stage(state, 10)
    assert rec._snapshot_step == 10
    assert len(rec.stage_seconds) == 2


def test_rollback_restores_the_gated_counts():
    """A snapshot taken while the counts were host ints restores into the
    device counts the gate made of them."""
    state, step = _resnet(opt="adam")
    rec = RecoveryManager()
    rec.stage(state, 0)
    rng = np.random.default_rng(0)
    for _ in range(2):
        state, _ = step(state, _images(rng))
    adam = state.opt_state[1]
    assert int(adam.count) == 2
    state.resilience.bad_streak.fill_(8)
    state = rec.observe(state, 2, bad_streak=8)
    assert isinstance(adam.count, torch.Tensor) and int(adam.count) == 0


# --- the trainer ------------------------------------------------------------------

def test_trainer_skips_nan_fault_and_completes():
    state, step = _resnet()
    rec = RecoveryManager(RecoveryConfig(snapshot_every_steps=2))
    trainer = Trainer(state, step, "cpu",
                      TrainerConfig(log_every=1, prefetch=0),
                      faults=FaultInjector(parse_faults("nan_batch@2")),
                      recovery=rec)
    rng = np.random.default_rng(2)
    summary = trainer.run_epoch([_images(rng) for _ in range(6)])
    assert summary["skipped_total"] == 1.0
    assert summary["rollbacks"] == 0
    assert np.isfinite(summary["loss"])
    assert rec._snapshot_step == 5       # staged at steps 1, 3 and 5


def test_trainer_rollback_restores_snapshot_params():
    """Bad data past ``rollback_after`` rolls the state back to the
    staged snapshot, and the run continues on the next batches."""
    state, step = _resnet()
    rec = RecoveryManager(RecoveryConfig(rollback_after=2, max_rollbacks=5,
                                         snapshot_every_steps=1))
    trainer = Trainer(state, step, "cpu",
                      TrainerConfig(log_every=1, prefetch=0), recovery=rec)
    rng = np.random.default_rng(3)
    nan = {"image": torch.full((4, 8, 8, 3), float("nan")),
           "label": torch.zeros(4, dtype=torch.int32)}
    trainer.run_epoch([_images(rng), _images(rng), nan, nan, _images(rng)])
    assert rec.rollbacks == 1
    assert all(torch.isfinite(p).all()
               for p in trainer.state.params.values())


def test_trainer_abort_after_rollback_budget():
    state, step = _resnet()
    trainer = Trainer(state, step, "cpu",
                      TrainerConfig(log_every=1, prefetch=0),
                      recovery=RecoveryManager(RecoveryConfig(
                          rollback_after=1, max_rollbacks=1,
                          snapshot_every_steps=1)))
    nan = {"image": torch.full((4, 8, 8, 3), float("nan")),
           "label": torch.zeros(4, dtype=torch.int32)}
    with pytest.raises(RecoveryAborted):
        trainer.run_epoch([_images(np.random.default_rng(4))] + [nan] * 5)


# --- the batch faults ---------------------------------------------------------------

def test_batch_faults_touch_only_float_leaves():
    inj = FaultInjector(parse_faults("nan_batch@1,spike_batch@2:100"))
    batch = {"image": torch.ones(2, 3), "label": torch.arange(2),
             "u8": torch.ones(2, dtype=torch.uint8)}
    nan = inj.on_step(1, batch)
    assert torch.isnan(nan["image"]).all()
    assert nan["label"] is batch["label"] and nan["u8"] is batch["u8"]
    spike = inj.on_step(2, batch)
    assert torch.equal(spike["image"], torch.full((2, 3), 100.0))
    assert spike["label"] is batch["label"]
    assert inj.on_step(1, batch) is batch   # fired once
    tokens = {"tokens": torch.arange(6).reshape(2, 3)}
    out = FaultInjector(parse_faults("nan_batch@0")).on_step(0, tokens)
    assert out["tokens"] is tokens["tokens"]   # an LM batch: no effect
    spike = FaultInjector(parse_faults("spike_batch@0")).on_step(
        0, {"x": torch.ones(2)})
    assert torch.equal(spike["x"], torch.full((2,), 1e4))   # default 1e4


# --- checkpoints ------------------------------------------------------------------

def test_counters_go_through_a_checkpoint(tmp_path):
    """The gated counts and the gate's counters are saved (as tensors,
    staged with the rest) and restored into a fresh template, whose counts
    are host ints until its first gated step."""
    state, step = _resnet(opt="adam")
    rng = np.random.default_rng(0)
    good = _images(rng)
    nan = {"image": torch.full_like(good["image"], float("nan")),
           "label": good["label"]}
    for b in (good, nan, good, nan):
        state, _ = step(state, b)
    with CheckpointManager(str(tmp_path)) as ck:
        ck.save(state, wait=True)
    fresh, _ = _resnet(opt="adam", seed=1)
    restored = CheckpointManager(str(tmp_path)).restore_latest(fresh)
    assert restored.step == 4
    assert restored.opt_state[1].count == 2         # a host int again
    assert restored.opt_state[2].count == 2
    assert int(restored.resilience.skipped_total) == 2
    assert int(restored.resilience.bad_streak) == 1
    want = {n: t for n, t in _learned(state).items()
            if not n.endswith("/count")}
    _assert_same(_learned(restored), want)


def test_a_checkpoint_without_the_gate_restores_the_counters_at_zero(
        tmp_path):
    plain, step = _resnet(guard=False)
    plain, _ = step(plain, _images(np.random.default_rng(0)))
    with CheckpointManager(str(tmp_path)) as ck:
        ck.save(plain, wait=True)
    guarded, _ = _resnet(seed=1)
    guarded.resilience.skipped_total.fill_(3)
    restored = CheckpointManager(str(tmp_path)).restore_latest(guarded)
    assert restored.step == 1
    assert int(restored.resilience.skipped_total) == 0
    assert isinstance(restored.resilience, ResilienceState)
    # and a gated checkpoint restores into an ungated run
    gated, gstep = _resnet(opt="sgd", seed=2)
    gated, _ = gstep(gated, _images(np.random.default_rng(1)))
    with CheckpointManager(str(tmp_path / "g")) as ck:
        ck.save(gated, wait=True)
    back = CheckpointManager(str(tmp_path / "g")).restore_latest(
        _resnet(guard=False)[0])
    assert back.step == 1 and back.resilience == ()
    assert back.opt_state[1][1].count == 1          # sgd's schedule count


def _run_epochs(trainer, batches_of, tap, epochs, per_epoch, start=0,
                skip=0):
    """The CLI's epoch loop; ``tap`` gets a digest of every batch."""
    def tapped(it):
        for b in it:
            tap.append(float(sum(torch.as_tensor(v).double().sum()
                                 for v in b.values())))
            yield b

    for epoch in range(start, epochs):
        s = skip if epoch == start else 0
        trainer.run_epoch(tapped(itertools.islice(batches_of(epoch), s,
                                                  per_epoch)), epoch=epoch)


@pytest.mark.parametrize("source", ["loader", "device-cache"])
def test_preempt_resume_with_the_gate_is_bitwise(tmp_path, source):
    """2 epochs x 6 steps with the gate (adam, ``nan_batch@1``)
    uninterrupted; again preempted before step 3 and resumed from the
    synchronous checkpoint: the batches and every tensor of the end state,
    the gate's counters and the device counts included, match bit for
    bit.  The loader's float batch is skipped; the cache's uint8 batch
    passes the fault untouched, as in JAX."""
    epochs, per_epoch = 2, 6
    ds = SyntheticImages(n=48, image_size=10, num_classes=10, seed=3)

    def make(seed=0):
        state, step = _resnet(opt="adam", seed=seed)
        if source == "loader":
            loader = DataLoader(ds, DataLoaderConfig(batch_size=8,
                                                     num_workers=0, seed=4))

            def batches_of(epoch):
                loader.set_epoch(epoch)
                return iter(loader)
        else:
            cache = DeviceCachedImages(ds, crop_size=8, device="cpu", seed=4)

            def batches_of(epoch):
                return cache.batches(epoch, 8)
        return state, step, batches_of

    config = TrainerConfig(log_every=1, prefetch=0)
    state, step, batches_of = make()
    ref_tap: list = []
    ref = Trainer(state, step, "cpu", config,
                  faults=FaultInjector(parse_faults("nan_batch@1")),
                  recovery=RecoveryManager())
    _run_epochs(ref, batches_of, ref_tap, epochs, per_epoch)
    assert int(ref.state.resilience.skipped_total) == (
        1 if source == "loader" else 0)

    state, step, batches_of = make()
    tap: list = []
    ck = CheckpointManager(str(tmp_path))
    with PreemptionHandler() as handler:
        t1 = Trainer(state, step, "cpu", config,
                     faults=FaultInjector(parse_faults(
                         "nan_batch@1,sigterm@2")),
                     preemption=handler, recovery=RecoveryManager(),
                     checkpoint_fn=lambda s, wait=False: ck.save(s,
                                                                 wait=wait))
        with pytest.raises(Preempted):
            _run_epochs(t1, batches_of, tap, epochs, per_epoch)
    ck.close()
    state, step, batches_of = make(seed=1)
    resumed = CheckpointManager(str(tmp_path)).restore_latest(state)
    assert resumed.step == 3
    t2 = Trainer(resumed, step, "cpu", config, recovery=RecoveryManager())
    _run_epochs(t2, batches_of, tap, epochs, per_epoch, start=0, skip=3)
    assert tap == ref_tap
    from pytorch_distributed_training_tpu_torch.checkpoint.manager import (
        flatten_state,
    )
    want, got = flatten_state(ref.state)[0], flatten_state(t2.state)[0]
    assert want.keys() == got.keys()
    for n in want:
        assert torch.equal(got[n], want[n]), n


# --- the CLI ----------------------------------------------------------------------

RESNET = ["--use-cpu", "--synthetic-data", "--batch-size", "8",
          "--num-workers", "0", "--model-overrides",
          "num_filters=8,small_stem=true"]


def test_cli_skips_a_nan_batch(capsys):
    trainer = cli_main([*RESNET, "--steps-per-epoch", "3",
                        "--skip-bad-steps", "--inject-faults",
                        "nan_batch@0"])
    out = capsys.readouterr().out
    assert "skipped_total=1" in out and "rollbacks=0" in out
    assert int(trainer.state.resilience.skipped_total) == 1
    assert trainer.history[-1]["skipped"] == 1.0


@pytest.mark.parametrize("flag", ["--skip-bad-steps", "--device-cache"])
def test_cli_preempt_and_resume_is_bitwise(tmp_path, flag):
    """``--skip-bad-steps`` (a NaN batch skipped at step 1) or
    ``--device-cache``, preempted by ``sigterm@2`` and resumed: the
    step-8 checkpoint equals the uninterrupted run's, tensor for
    tensor."""
    argv = [*RESNET, "--steps-per-epoch", "4", "--epochs", "2", flag,
            "--ckpt-every-steps", "2"]

    def cli(extra, ckpt):
        return subprocess.run(
            [sys.executable, "-m", "pytorch_distributed_training_tpu_torch"
             ".cli.main", *argv, *extra, "--checkpoint-dir", str(ckpt)],
            cwd=REPO, env=ENV, capture_output=True, text=True, timeout=120)

    gate = flag == "--skip-bad-steps"
    nan = ["--inject-faults", "nan_batch@1"] if gate else []
    ref = cli(nan, tmp_path / "ref")
    assert ref.returncode == 0, ref.stderr[-2000:]
    ckpt = tmp_path / "ck"
    faults = ["--inject-faults", "nan_batch@1,sigterm@2" if gate
              else "sigterm@2"]
    first = cli(faults, ckpt)
    assert first.returncode == 75, first.stderr[-2000:]
    second = cli([*faults, "--resume"], ckpt)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "resumed from step 3 (epoch 0, skipping 3 consumed batches)" in \
        second.stdout
    manifests = [CheckpointManager(str(d)).manifest(8)["leaves"]
                 for d in (tmp_path / "ref", ckpt)]
    assert manifests[0] == manifests[1]
    if gate:
        leaves = CheckpointManager(str(ckpt)).load_tensors(8)
        assert int(leaves["resilience/skipped_total"]) == 1


def test_cli_rollback_abort_and_the_supervisors_relaunch(tmp_path):
    """A threshold below every gradient norm, one epoch of 101 steps (log
    points at steps 0, 50 and 100, no checkpoint before the end): the
    second log point rolls back, the third aborts nonzero; under
    ``--elastic --max-restarts 1`` the relaunch, finding no checkpoint,
    fails the same way."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_training_tpu_torch"
         ".cli.main", *RESNET, "--steps-per-epoch", "101",
         "--skip-bad-steps", "--grad-spike-threshold", "1e-9",
         "--rollback-after", "2", "--max-rollbacks", "1",
         "--elastic", "--max-restarts", "1",
         "--checkpoint-dir", str(tmp_path)],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert proc.stderr.count("recovery: rollback 1 at step 50") == 2
    assert proc.stderr.count("recovery: abort at step 100") == 2
    assert proc.stderr.count(
        "resilience.recovery.RecoveryAborted: ") == 2
    assert "supervisor: finished after 1 restarts" in proc.stdout
