"""The PyTorch port's resilience plane, twins of the JAX package's
``tests/test_resilience.py``: the fault plan, the preemption latch, the
trainer's preemption and checkpoint cadence, preempt-and-resume bitwise
(the batch sequence too), and the CLI's preemption exit and resume line
against the JAX CLI's.
"""

import itertools
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu_torch.checkpoint import (
    CheckpointManager,
)
from pytorch_distributed_training_tpu_torch.cli.main import (
    build_optimizer, build_schedule,
)
from pytorch_distributed_training_tpu_torch.data import (
    DataLoader, DataLoaderConfig, SyntheticImages, SyntheticTokens,
)
from pytorch_distributed_training_tpu_torch.models import create_model
from pytorch_distributed_training_tpu_torch.resilience import (
    CRASH_EXIT_CODE, PREEMPTED_EXIT_CODE, FaultInjector, Preempted,
    PreemptionHandler, parse_faults,
)
from pytorch_distributed_training_tpu_torch.train import (
    Trainer, TrainerConfig, create_train_state, make_train_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the fault plan -----------------------------------------------------------

def test_fault_plan_parse_and_defaults():
    faults = parse_faults("crash@5, stall@3:0.5,ckpt_truncate@6,sigterm@7")
    assert [(f.kind, f.step) for f in faults] == [
        ("crash", 5), ("stall", 3), ("ckpt_truncate", 6), ("sigterm", 7)]
    assert faults[1].arg == 0.5
    assert parse_faults("stall@1")[0].arg == 3600.0
    with pytest.raises(ValueError):
        parse_faults("meteor@3")
    with pytest.raises(ValueError):
        parse_faults("crash@soon")


@pytest.mark.parametrize("kind", ["replica_crash@3:0", "slice_lost@4:1"])
def test_unported_fault_kinds_are_refused(kind):
    """The training plan refuses the serving kinds (they run at router
    ticks, through ``--serve-inject-faults``) and the elastic ones (the
    membership plane's, through ``--elastic-resize``), with JAX's
    message."""
    match = {"replica_crash@3:0": "serving fault .* --serve-inject-faults",
             "slice_lost@4:1": "elastic membership fault .* "
                               "--elastic-resize, not --inject-faults"}[kind]
    with pytest.raises(ValueError, match=match):
        parse_faults(f"crash@1,{kind}")


@pytest.mark.parametrize("kind,arg", [("nan_batch@2", None),
                                      ("spike_batch@4:10", 10.0)])
def test_batch_fault_kinds_are_accepted(kind, arg):
    """The skip gate's faults, refused until it was ported."""
    fault = parse_faults(f"crash@1,{kind}")[1]
    assert (fault.kind, fault.arg) == (kind.split("@")[0], arg)
    assert parse_faults("spike_batch@3")[0].arg == 1e4


def test_fault_injector_fires_once_and_persists_markers(tmp_path):
    calls = []
    spec = "crash@5,sigterm@3,stall@4:0.01"

    def injector():
        return FaultInjector(
            parse_faults(spec), state_dir=str(tmp_path),
            _exit=lambda c: calls.append(("exit", c)),
            _kill=lambda p, s: calls.append(("kill", s)),
            _sleep=lambda s: calls.append(("sleep", s)))

    inj = injector()
    batch = {"x": np.ones(2)}
    assert inj.on_step(2, batch) is batch
    for step in (3, 4, 5, 5):
        inj.on_step(step, batch)
    assert calls == [("kill", signal.SIGTERM), ("sleep", 0.01),
                     ("exit", CRASH_EXIT_CODE)]
    # Markers persist: a FRESH injector (the relaunched process) refires
    # nothing.
    calls.clear()
    inj2 = injector()
    for step in (3, 4, 5):
        inj2.on_step(step, batch)
    assert calls == []


# --- the latch and the trainer --------------------------------------------------

def test_preemption_handler_latches_and_uninstalls():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler() as h:
        assert not h.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.triggered
    assert signal.getsignal(signal.SIGTERM) is prev
    h = PreemptionHandler().install()
    h.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev


def _linear_state():
    model = create_model("gpt2", device="cpu", seed=0, cfg_overrides=dict(
        num_layers=1, hidden_dim=16, num_heads=2, vocab_size=32,
        max_seq_len=16))
    return (create_train_state(model, build_optimizer("adam", 1e-2,
                                                      weight_decay=0.0)),
            make_train_step(kind="lm"))


def _token_batches(n):
    rng = np.random.default_rng(5)
    return [{"tokens": torch.from_numpy(rng.integers(0, 32, (2, 8)))}
            for _ in range(n)]


def test_trainer_preemption_checkpoints_at_step_boundary():
    """sigterm before step 2 dispatches → step 2 completes, a SYNC save of
    step 3 lands at the boundary, Preempted carries the step."""
    state, step = _linear_state()
    saves = []
    with PreemptionHandler() as handler:
        trainer = Trainer(
            state, step, "cpu", TrainerConfig(log_every=100, prefetch=0),
            faults=FaultInjector(parse_faults("sigterm@2")),
            preemption=handler,
            checkpoint_fn=lambda s, wait=False: saves.append((s.step, wait)))
        with pytest.raises(Preempted) as exc:
            trainer.run_epoch(_token_batches(10))
    assert exc.value.step == 3 and exc.value.saved
    assert saves == [(3, True)]
    assert trainer.state.step == 3


def test_trainer_step_checkpoint_cadence():
    state, step = _linear_state()
    saves = []
    trainer = Trainer(
        state, step, "cpu", TrainerConfig(log_every=100, prefetch=0,
                                          checkpoint_every_steps=2),
        checkpoint_fn=lambda s, wait=False: saves.append((s.step, wait)))
    trainer.run_epoch(_token_batches(7))
    assert saves == [(2, False), (4, False), (6, False)]


# --- preempt, resume, bitwise ---------------------------------------------------

def _run(kind, seed=0):
    """(state, step fn, loader) of a small ResNet with ``batch_stats``
    (sgd momentum) or a GPT-2 with dropout 0.1 (adamw, warmup-cosine)."""
    if kind == "resnet":
        model = create_model("resnet18", num_classes=10, device="cpu",
                             seed=seed, cfg_overrides={
                                 "stage_sizes": (1, 1), "num_filters": 8,
                                 "small_stem": True})
        tx = build_optimizer("sgd", 0.05, weight_decay=1e-3)
        step = make_train_step(kind="image_classifier")
        ds = SyntheticImages(n=48, image_size=8, num_classes=10, seed=3)
    else:
        model = create_model("gpt2", device="cpu", seed=seed, cfg_overrides=dict(
            num_layers=2, hidden_dim=32, num_heads=2, vocab_size=64,
            max_seq_len=32, dropout_rate=0.1))
        tx = build_optimizer("adamw", build_schedule(
            "warmup-cosine", 1e-3, total_steps=12, warmup_steps=3),
            weight_decay=0.1)
        step = make_train_step(kind="lm", seed=11)
        ds = SyntheticTokens(n=48, seq_len=16, vocab_size=64, seed=3)
    loader = DataLoader(ds, DataLoaderConfig(batch_size=8, num_workers=0,
                                             seed=4))
    return create_train_state(model, tx), step, loader


class _Tap:
    """Record a digest of every batch an iterator yields."""

    def __init__(self):
        self.digests = []

    def __call__(self, it):
        for b in it:
            self.digests.append(float(sum(np.asarray(v, np.float64).sum()
                                          for v in b.values())))
            yield b


@pytest.mark.parametrize("kind", ["resnet", "gpt2"])
def test_preempt_resume_is_bitwise_deterministic(tmp_path, kind):
    """2 epochs x 6 steps uninterrupted; again with a SIGTERM before step
    3 dispatches, the synchronous step checkpoint, and a resume that
    skips the consumed batches: the batch sequence and every tensor of
    the final state match bit for bit (dropout redraws the same masks
    from the restored step; the schedule reads the restored count)."""
    epochs, per_epoch = 2, 6
    config = TrainerConfig(log_every=100, prefetch=0)

    def run_epochs(trainer, loader, tap, start_epoch=0, skip=0):
        for epoch in range(start_epoch, epochs):
            loader.set_epoch(epoch)
            s = skip if epoch == start_epoch else 0
            batches = itertools.islice(iter(loader), s, per_epoch)
            trainer.run_epoch(tap(batches), epoch=epoch)

    state, step, loader = _run(kind)
    ref_tap = _Tap()
    ref = Trainer(state, step, "cpu", config)
    run_epochs(ref, loader, ref_tap)

    state, step, loader = _run(kind)
    tap = _Tap()
    ck = CheckpointManager(str(tmp_path))
    with PreemptionHandler() as handler:
        t1 = Trainer(state, step, "cpu", config,
                     faults=FaultInjector(parse_faults("sigterm@2")),
                     preemption=handler,
                     checkpoint_fn=lambda s, wait=False: ck.save(s,
                                                                 wait=wait))
        with pytest.raises(Preempted):
            run_epochs(t1, loader, tap)
    ck.close()

    state, step, loader = _run(kind, seed=1)    # other weights, restored
    resumed = CheckpointManager(str(tmp_path)).restore_latest(state)
    assert resumed.step == 3
    start_epoch = resumed.step // per_epoch
    t2 = Trainer(resumed, step, "cpu", config)
    run_epochs(t2, loader, tap, start_epoch=start_epoch,
               skip=resumed.step - start_epoch * per_epoch)

    assert tap.digests == ref_tap.digests
    assert t2.state.step == ref.state.step == 12
    for name in {**ref.state.params, **ref.state.batch_stats}:
        want = {**ref.state.params, **ref.state.batch_stats}[name]
        got = {**t2.state.params, **t2.state.batch_stats}[name]
        assert torch.equal(got, want), name


# --- the CLI --------------------------------------------------------------------

TINY = ["--use-cpu", "--model", "gpt2", "--dataset", "synthetic-tokens",
        "--seq-len", "16", "--model-overrides",
        "num_layers=1,hidden_dim=32,num_heads=2,vocab_size=64,max_seq_len=32",
        "--batch-size", "8", "--num-workers", "0", "--steps-per-epoch", "4",
        "--epochs", "2"]


def _cli(package: str, argv: list, ckpt) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", f"{package}.cli.main", *argv,
         "--checkpoint-dir", str(ckpt)], cwd=REPO, env=ENV,
        capture_output=True, text=True, timeout=120)


def _resumed_line(out: str) -> str:
    return next(ln for ln in out.splitlines()
                if ln.startswith("resumed from step"))


@pytest.mark.parametrize("fault,line", [
    ("sigterm@2", "resumed from step 3 (epoch 0, skipping 3 consumed "
                  "batches)"),
    ("sigterm@5", "resumed from step 6 (epoch 1, skipping 2 consumed "
                  "batches)"),
])
def test_cli_resume_line_and_exit_equal_the_jax_clis(tmp_path, fault, line):
    """The same flags through both CLIs (different inits, so only the
    preemption exit and the resume line are compared)."""
    argv = [*TINY, "--ckpt-every-steps", "2", "--inject-faults", fault]
    lines = {}
    for package in ("pytorch_distributed_training_tpu",
                    "pytorch_distributed_training_tpu_torch"):
        ckpt = tmp_path / package
        first = _cli(package, argv, ckpt)
        assert first.returncode == PREEMPTED_EXIT_CODE, first.stderr[-2000:]
        assert (f"checkpoint committed; exiting {PREEMPTED_EXIT_CODE}"
                in first.stdout)
        second = _cli(package, [*argv, "--resume"], ckpt)
        assert second.returncode == 0, second.stderr[-2000:]
        lines[package] = _resumed_line(second.stdout)
    assert lines["pytorch_distributed_training_tpu_torch"] == line
    assert lines["pytorch_distributed_training_tpu"] == line


def test_cli_preempt_then_resume_equals_the_uninterrupted_run(tmp_path):
    """``sigterm@2`` with step checkpoints every 2: exit 75 with steps 2
    and 3 committed; ``--resume`` prints the resume line and ends with
    the uninterrupted run's weights bit for bit (the step-8 manifests)."""
    argv = ["--use-cpu", "--synthetic-data", "--steps-per-epoch", "4",
            "--epochs", "2", "--batch-size", "8", "--num-workers", "0",
            "--model-overrides", "num_filters=8,small_stem=true",
            "--ckpt-every-steps", "2"]
    ref = _cli("pytorch_distributed_training_tpu_torch", argv,
               tmp_path / "ref")
    assert ref.returncode == 0, ref.stderr[-2000:]
    ckpt = tmp_path / "ck"
    first = _cli("pytorch_distributed_training_tpu_torch",
                 [*argv, "--inject-faults", "sigterm@2"], ckpt)
    assert first.returncode == PREEMPTED_EXIT_CODE, first.stderr[-2000:]
    assert "preempted at step 3; checkpoint committed; exiting 75" in \
        first.stdout
    assert CheckpointManager(str(ckpt)).all_steps() == [2, 3]
    second = _cli("pytorch_distributed_training_tpu_torch",
                  [*argv, "--inject-faults", "sigterm@2", "--resume"], ckpt)
    assert second.returncode == 0, second.stderr[-2000:]
    assert ("resumed from step 3 (epoch 0, skipping 3 consumed batches)"
            in second.stdout)
    assert "training finished" in second.stdout
    manifests = [CheckpointManager(str(d)).manifest(8)["leaves"]
                 for d in (tmp_path / "ref", ckpt)]
    assert manifests[0] == manifests[1]
    assert any(k.startswith("batch_stats/") for k in manifests[0])
