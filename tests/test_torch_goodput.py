"""The port's goodput ledger (``obs/ledger.py``) and its wiring, against
the JAX package's, on the CPU.

- Scripted sequences under an injected clock (JAX's
  ``tests/test_goodput.py``: the quota split, bracket nesting, rollback
  re-classification, the restart watermark, the inherited backoff, pure
  snapshots) give JAX's integer-ns attribution, field for field, and the
  identity ``sum(categories) == wall`` exactly; ``fleet_ledger`` merges
  rank records as JAX's does.
- The recovery manager's rollback and abort, and a fired fault, are
  anomaly events on the emitter (stderr only without one); a rollback
  moves its steps' charges to ``rework``.
- The CLI: a run preempted by ``sigterm@2`` closes its log with a
  ``goodput_ledger`` record whose categories sum to its wall with a
  ``ckpt_save`` above 0, and its resume charges ``ckpt_restore``, no
  ``rework``, and restores the ``supervisor_backoff`` it inherits.
"""

import os

import pytest
import torch

import pytorch_distributed_training_tpu.obs as jobs
import pytorch_distributed_training_tpu_torch.obs as tobs
from pytorch_distributed_training_tpu_torch.cli.main import main as cli
from pytorch_distributed_training_tpu_torch.utils.supervisor import (
    BACKOFF_ENV,
)


class Clock:
    """Virtual monotonic clock; durations are multiples of 2^-3 s so the
    ns conversion is exact."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _quota(mod):
    clock = Clock()
    led = mod.GoodputLedger(clock=clock, inherited_backoff_s=0.0)
    led.set_grad_sync_model(0.25, ici_share=0.5, model={"mode": "hier"})

    def pulls():
        for b in range(3):
            clock.advance(0.125)
            yield b

    step = 0
    for _ in led.wrap_batches(pulls()):
        clock.advance(0.5)
        led.begin_step(step)
        clock.advance(0.25)
        step += 1
    clock.advance(0.5)
    return led.finalize()


def _brackets(mod):
    clock = Clock()
    led = mod.GoodputLedger(clock=clock, inherited_backoff_s=0.0)
    led.begin_step(0)
    clock.advance(0.25)
    with led.bracket("ckpt_save"):
        clock.advance(1.0)
        with led.bracket("ckpt_restore"):
            clock.advance(0.375)
    clock.advance(0.125)
    with pytest.raises(ValueError):
        led.bracket("not_a_category")
    return led.finalize()


def _rollback(mod):
    clock = Clock()
    led = mod.GoodputLedger(clock=clock, inherited_backoff_s=0.0)
    led.set_grad_sync_model(0.25, ici_share=0.5)
    led.begin_step(0)
    clock.advance(0.5)
    for step in (1, 2, 3):
        led.begin_step(step)
        clock.advance(0.75)
    led.note_snapshot(1)
    led.note_rollback(2, 3)
    clock.advance(0.25)
    led.begin_step(4)
    clock.advance(0.5)
    return led.finalize()


def _watermark(mod):
    clock = Clock()
    led = mod.GoodputLedger(clock=clock, inherited_backoff_s=0.0)
    led.set_rework_until(5)
    for step in (3, 4, 5, 6):
        led.begin_step(step)
        clock.advance(0.5)
    return led.finalize()


def _backoff(mod):
    clock = Clock()
    led = mod.GoodputLedger(clock=clock, inherited_backoff_s=2.5)
    clock.advance(1.0)
    return led.finalize()


def _snapshots(mod):
    clock = Clock()
    led = mod.GoodputLedger(clock=clock, inherited_backoff_s=0.125)
    led.begin_step(0)
    clock.advance(0.5)
    a, b = led.snapshot(), led.snapshot()
    assert a == b
    clock.advance(0.25)
    final = led.finalize()
    assert led.finalize() == final
    return a, final


SCRIPTS = {"quota": _quota, "brackets": _brackets, "rollback": _rollback,
           "watermark": _watermark, "backoff": _backoff,
           "snapshots": _snapshots}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_ledger_attribution_equals_jax(name):
    got, want = SCRIPTS[name](tobs), SCRIPTS[name](jobs)
    assert got == want
    for snap in (got if isinstance(got, tuple) else (got,)):
        assert snap["identity_ok"]
        assert sum(snap["categories_ns"].values()) == snap["wall_ns"]


def test_ledger_pinned_values():
    snap = _quota(tobs)
    ns = 1_000_000_000
    assert snap["categories_ns"]["compile"] == int(0.75 * ns)
    assert snap["categories_ns"]["grad_sync"] == int(0.5 * ns)
    assert snap["grad_sync_ici_ns"] == snap["grad_sync_dcn_ns"] == \
        int(0.25 * ns)
    snap = _rollback(tobs)
    assert snap["step_intervals"]["rework"] == 2
    snap = _watermark(tobs)
    assert snap["step_intervals"] == {"compile": 1, "step_compute": 2,
                                      "rework": 1}


def test_inherited_backoff_from_env(monkeypatch):
    monkeypatch.setenv(BACKOFF_ENV, repr(0.25))
    assert tobs.GoodputLedger(clock=Clock()).inherited_backoff_ns == \
        jobs.GoodputLedger(clock=Clock()).inherited_backoff_ns == 250_000_000


def test_progress_file_roundtrip(tmp_path):
    path = str(tmp_path / ".progress")
    led = tobs.GoodputLedger(clock=Clock(), progress_path=path)
    for step in (1, 2, 7):
        led.note_progress(step)
    led.finalize()
    assert tobs.GoodputLedger.read_progress(path) == \
        jobs.GoodputLedger.read_progress(path) == 7
    assert tobs.GoodputLedger.read_progress(str(tmp_path / "none")) is None


def _records():
    recs = {}
    for rank, scale in ((0, 1.0), (1, 1.5), (2, 1.25)):
        clock = Clock()
        led = tobs.GoodputLedger(clock=clock, inherited_backoff_s=0.0)
        for step in range(4):
            clock.advance(0.125 * scale)
            led.begin_step(step)
            clock.advance(0.5 * scale)
        recs[rank] = led.finalize()
    return recs


@pytest.mark.parametrize("straggler", [None, 2])
def test_fleet_ledger_equals_jax(straggler):
    recs = _records()
    got = tobs.fleet_ledger(recs, straggler_rank=straggler)
    assert got == jobs.fleet_ledger(recs, straggler_rank=straggler)
    assert got["identity_ok"] and got["n_ranks"] == 3
    assert got["idle_attributed_to"] == (1 if straggler is None else 2)
    with pytest.raises(ValueError):
        tobs.fleet_ledger({})


def test_ledger_gauges_and_record_from_one_snapshot(tmp_path):
    clock = Clock()
    em = tobs.MetricsEmitter(str(tmp_path), rank=0, clock=clock)
    agg = tobs.LiveAggregator(clock=clock)
    em.attach_sink(agg)
    led = tobs.GoodputLedger(clock=clock, inherited_backoff_s=0.0)
    led.begin_step(0)
    clock.advance(0.5)
    led.begin_step(1)
    clock.advance(0.5)
    snap = led.finalize(em)
    em.close()
    rec = [e for e in tobs.read_events(em.path)
           if e.get("record") == "goodput_ledger"][0]
    assert rec["goodput_fraction"] == snap["goodput_fraction"] == \
        agg.snapshot()["gauges"]["goodput_fraction"]
    for cat in tobs.LEDGER_CATEGORIES:
        assert tobs.check_metric_name(f"ledger_{cat}_s", "gauge") is None


# --- recovery, faults -------------------------------------------------------

def _tiny_state():
    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.resilience import (
        init_resilience_state,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, optim,
    )
    import dataclasses

    net = create_model("gpt2", device="cpu", seed=0, cfg_overrides=dict(
        num_layers=1, hidden_dim=32, num_heads=2, vocab_size=64,
        max_seq_len=16))
    state = create_train_state(net, optim.adamw(1e-3, weight_decay=0.0),
                               policy=make_policy("f32"))
    return dataclasses.replace(state,
                               resilience=init_resilience_state("cpu"))


@pytest.mark.parametrize("live", [True, False])
def test_recovery_events_and_rework(tmp_path, capsys, live):
    from pytorch_distributed_training_tpu_torch.resilience import (
        RecoveryAborted, RecoveryConfig, RecoveryManager,
    )

    clock = Clock()
    em = tobs.MetricsEmitter(str(tmp_path) if live else None, rank=0,
                             clock=clock)
    led = tobs.GoodputLedger(clock=clock, inherited_backoff_s=0.0)
    mgr = RecoveryManager(RecoveryConfig(rollback_after=2, max_rollbacks=1,
                                         snapshot_every_steps=10),
                          emitter=em if live else None, ledger=led)
    state = _tiny_state()
    led.begin_step(0)
    mgr.maybe_stage(state, 1)
    for step in (1, 2, 3):
        clock.advance(0.5)
        led.begin_step(step)
    before = {n: p.clone() for n, p in state.params.items()}
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
    state = mgr.observe(state, 3, bad_streak=2)
    assert all(torch.equal(before[n], p) for n, p in state.params.items())
    with pytest.raises(RecoveryAborted):
        mgr.observe(state, 4, bad_streak=3)
    snap = led.finalize()
    assert snap["identity_ok"] and snap["step_intervals"]["rework"] == 3
    assert snap["categories_ns"]["ckpt_restore"] >= 0
    err = capsys.readouterr().err
    if live:
        em.close()
        kinds = [e["anomaly"] for e in tobs.read_events(em.path)
                 if e["kind"] == "anomaly"]
        assert kinds == ["rollback", "recovery_abort"]
        assert "recovery:" not in err
    else:
        assert "recovery: rollback 1 at step 3" in err
        assert "recovery: abort at step 4" in err


def test_fired_fault_is_an_anomaly(tmp_path):
    from pytorch_distributed_training_tpu_torch.resilience import (
        FaultInjector,
    )

    em = tobs.MetricsEmitter(str(tmp_path), rank=0)
    killed = []
    inj = FaultInjector.from_spec(
        "sigterm@1,nan_batch@2", emitter=em,
        _kill=lambda pid, sig: killed.append(sig))
    batch = {"x": torch.ones(2)}
    for step in range(4):
        batch = inj.on_step(step, batch)
    em.close()
    got = [(e["anomaly"], e["fault"], e["fault_step"])
           for e in tobs.read_events(em.path) if e["kind"] == "anomaly"]
    assert got == [("fault_injected", "sigterm", 1),
                   ("fault_injected", "nan_batch", 2)]
    assert len(killed) == 1 and torch.isnan(batch["x"]).all()


# --- the CLI's ledger through a preemption and a resume ---------------------

def test_cli_preempted_and_resumed_ledger(tmp_path, monkeypatch):
    argv = ["--use-cpu", "--model", "gpt2", "--dataset", "synthetic-tokens",
            "--seq-len", "16", "--model-overrides",
            "num_layers=1,hidden_dim=32,num_heads=2,vocab_size=64,"
            "max_seq_len=16", "--batch-size", "4", "--steps-per-epoch", "5",
            "--num-workers", "0", "--checkpoint-dir", str(tmp_path / "ck"),
            "--ckpt-every-steps", "2", "--goodput", "--trace"]
    with pytest.raises(SystemExit) as e:
        cli(argv + ["--inject-faults", "sigterm@2", "--metrics-dir",
                    str(tmp_path / "a")])
    assert e.value.code == 75
    monkeypatch.setenv(BACKOFF_ENV, "0.5")
    cli(argv + ["--resume", "--metrics-dir", str(tmp_path / "b")])
    ledgers, kinds = [], []
    for d in ("a", "b"):
        events = tobs.read_events(str(tmp_path / d / "events.rank00000.jsonl"))
        tobs.validate_events(events)
        assert events[-1]["kind"] == "summary"
        ledgers.append(next(ev for ev in events
                            if ev.get("record") == "goodput_ledger"))
        kinds.append([ev.get("anomaly") for ev in events
                      if ev["kind"] == "anomaly"])
    first, resumed = ledgers
    for led in ledgers:
        assert led["identity_ok"]
        assert sum(led["categories_ns"].values()) == led["wall_ns"]
        assert led["categories_ns"]["rework"] == 0
    assert first["categories_ns"]["ckpt_save"] > 0
    assert first["step_intervals"] == {"compile": 1, "step_compute": 2,
                                       "rework": 0}
    assert resumed["categories_ns"]["ckpt_restore"] > 0
    assert resumed["categories_ns"]["supervisor_backoff"] == 500_000_000
    assert kinds[0] == ["fault_injected", "preemption"]
    assert open(tmp_path / "ck" / ".progress").read().strip() == "5"
    assert os.path.exists(tmp_path / "ck" / "5")
