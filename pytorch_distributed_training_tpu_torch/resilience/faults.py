"""Deterministic fault injection, the training half of the JAX package's
``resilience/faults.py``: the plane that proves the checkpoint, the
preemption exit and the supervisor.

A fault spec is a comma-separated list of ``kind@step[:arg]`` entries,
passed via ``--inject-faults`` (or the ``PDT_FAULTS`` env var) and
evaluated against the trainer's GLOBAL step counter, so a fault lands at
the same optimizer step regardless of epochs, resumes, or data skips:

- ``crash@N``         — hard process death (``os._exit``) before step N
  dispatches: the rank-kill scenario.  Exit code :data:`CRASH_EXIT_CODE`.
- ``stall@N[:S]``     — sleep S seconds (default 3600) before step N
  WITHOUT beating the heartbeat: the hung-collective scenario the
  supervisor's staleness watcher must kill.
- ``sigterm@N``       — deliver SIGTERM to self before step N: the
  preemption notice.  The step completes; the trainer then takes a
  synchronous step checkpoint and exits ``PREEMPTED_EXIT_CODE``.
- ``nan_batch@N``     — overwrite every float leaf of step N's batch with
  NaN: the poisoned-batch scenario the skip gate (``--skip-bad-steps``)
  must turn into a no-op update.
- ``spike_batch@N[:F]`` — scale the float leaves by F (default 1e4): a
  finite gradient spike, for ``--grad-spike-threshold``.
- ``ckpt_truncate@N`` — after the first checkpoint for a step >= N
  commits, truncate its largest payload file: the corrupt-checkpoint
  scenario ``restore_latest``'s manifest verification must catch and
  fall back from.

The batch faults act on the batch's own device and only on float leaves:
integer leaves (token ids, labels) and uint8 images (packed records, the
device cache) pass through, as in JAX, so they change nothing in an LM
run or a uint8 one.  The JAX package's serving and elastic kinds need
their tiers; none is ported yet, and a spec naming one is refused rather
than silently ignored.

**Once-per-run semantics.**  A crash/preemption relaunch resumes from a
checkpoint *below* the fault step and would re-reach it — so each fault
writes a marker file into ``state_dir`` when it fires and never refires
while the marker exists.  Without a ``state_dir`` (unit tests, single
process) markers are in-memory only.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time

FAULT_KINDS = ("crash", "stall", "sigterm", "nan_batch", "spike_batch",
               "ckpt_truncate")
# The JAX package's other kinds, refused here until their slices land.
_NOT_PORTED = ("replica_crash", "replica_stall", "replica_slow",
               "handoff_drop", "slice_lost", "slice_return", "host_hang")

# Distinct from real Python tracebacks (1) and signal deaths (negative /
# 128+N) so the chaos harness can assert WHICH death it injected.
CRASH_EXIT_CODE = 13

FAULTS_ENV = "PDT_FAULTS"

_DEFAULT_ARGS = {"stall": 3600.0, "spike_batch": 1e4}


class _FiredMarkers:
    """Once-per-RUN firing markers: a fault writes a marker file into
    ``state_dir`` when it fires and never refires while the marker
    exists — a supervised relaunch that re-reaches the fault step sees
    the marker and skips.  Without a ``state_dir`` markers are in-memory
    only."""

    def __init__(self, state_dir: str | None):
        self.state_dir = state_dir
        self._fired: set[str] = set()
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)

    def _path(self, name: str) -> str | None:
        if self.state_dir is None:
            return None
        return os.path.join(
            self.state_dir, name.replace("@", "_").replace(":", "_")
        )

    def fired(self, name: str) -> bool:
        path = self._path(name)
        if path is not None:
            return os.path.exists(path)
        return name in self._fired

    def mark(self, name: str) -> None:
        """Record the firing BEFORE the fault lands — a crash must not
        lose its marker, or the relaunch refires it forever."""
        self._fired.add(name)
        path = self._path(name)
        if path is not None:
            with open(path, "w") as f:
                f.write(str(time.time()))


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    step: int
    arg: float | None = None

    @property
    def name(self) -> str:
        return f"{self.kind}@{self.step}"


def parse_faults(spec: str) -> list[Fault]:
    """Parse ``kind@step[:arg],...`` into :class:`Fault` entries."""
    faults = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        kind, sep, rest = item.partition("@")
        if sep and kind in _NOT_PORTED:
            # A silently ignored fault would make a chaos run vacuously
            # green — refuse loudly.
            raise ValueError(
                f"fault entry {item!r}: {kind} is not ported yet (the port "
                f"injects {', '.join(FAULT_KINDS)})"
            )
        if not sep or kind not in FAULT_KINDS:
            raise ValueError(
                f"fault entry {item!r} is not kind@step[:arg] with kind in "
                f"{FAULT_KINDS}"
            )
        step_s, _, arg_s = rest.partition(":")
        try:
            step = int(step_s)
            arg = float(arg_s) if arg_s else _DEFAULT_ARGS.get(kind)
        except ValueError:
            raise ValueError(f"fault entry {item!r}: bad step/arg") from None
        faults.append(Fault(kind, step, arg))
    return faults


class FaultInjector:
    """Evaluates a fault plan at step boundaries and checkpoint commits.

    ``_exit``/``_kill``/``_sleep`` are injectable so unit tests can
    observe a crash/stall/sigterm instead of suffering it.
    """

    def __init__(self, faults: list[Fault], *, state_dir: str | None = None,
                 emitter=None, _exit=os._exit, _kill=os.kill,
                 _sleep=time.sleep):
        self.faults = list(faults)
        self.state_dir = state_dir
        # A fired fault is an anomaly event on the telemetry emitter
        # (``--metrics-dir``), as in JAX.
        self.emitter = emitter
        self._markers = _FiredMarkers(state_dir)
        self._exit, self._kill, self._sleep = _exit, _kill, _sleep

    @classmethod
    def from_spec(cls, spec: str, **kwargs) -> "FaultInjector":
        return cls(parse_faults(spec), **kwargs)

    def fired(self, fault: Fault) -> bool:
        return self._markers.fired(fault.name)

    def _mark(self, fault: Fault) -> None:
        self._markers.mark(fault.name)
        if self.emitter is not None:
            self.emitter.anomaly(
                "fault_injected", fault=fault.kind, fault_step=fault.step)

    def on_step(self, global_step: int, batch):
        """Fire any fault armed for this step; returns the (possibly
        corrupted) batch.  Called by the trainer before the step
        dispatches."""
        for fault in self.faults:
            if fault.step != global_step or fault.kind == "ckpt_truncate" \
                    or self.fired(fault):
                continue
            self._mark(fault)
            if fault.kind == "crash":
                self._exit(CRASH_EXIT_CODE)
            elif fault.kind == "stall":
                # No heartbeat during the sleep: exactly the stale-mtime
                # signature the supervisor's watcher kills on.
                self._sleep(fault.arg or _DEFAULT_ARGS["stall"])
            elif fault.kind == "sigterm":
                self._kill(os.getpid(), signal.SIGTERM)
            elif fault.kind == "nan_batch":
                batch = corrupt_batch(batch, "nan")
            elif fault.kind == "spike_batch":
                batch = corrupt_batch(
                    batch, "spike", fault.arg or _DEFAULT_ARGS["spike_batch"])
        return batch

    def on_checkpoint_saved(self, manager, step: int) -> None:
        """``ckpt_truncate@N``: corrupt the first committed checkpoint at
        step >= N.  Waits for the (possibly async) save to commit first —
        truncating a temporary directory would only test the rename's
        atomicity."""
        for fault in self.faults:
            if fault.kind != "ckpt_truncate" or step < fault.step \
                    or self.fired(fault):
                continue
            manager.wait_until_finished()
            self._mark(fault)
            truncate_checkpoint(manager.directory, step)


def corrupt_batch(batch: dict, mode: str, factor: float = 1e4) -> dict:
    """NaN-fill (``mode="nan"``) or scale by ``factor`` the float tensors
    of a batch on their own device (the trainer's batches are on it);
    integer and uint8 leaves pass through untouched."""
    import torch

    def fix(x: torch.Tensor) -> torch.Tensor:
        if not x.is_floating_point():
            return x
        return torch.full_like(x, float("nan")) if mode == "nan" \
            else x * factor

    return {k: fix(v) for k, v in batch.items()}


def truncate_checkpoint(directory: str, step: int) -> str:
    """Truncate the largest payload file of ``directory``'s committed
    ``step`` (``<directory>/<step>/``) to half its size; returns the
    mangled path.  Raises FileNotFoundError when the step directory does
    not exist."""
    step_dir = os.path.join(directory, str(step))
    if not os.path.isdir(step_dir):
        raise FileNotFoundError(f"no committed step {step} under {directory}")
    largest, size = None, -1
    for name in os.listdir(step_dir):
        path = os.path.join(step_dir, name)
        if os.path.isfile(path) and os.path.getsize(path) > size:
            largest, size = path, os.path.getsize(path)
    if largest is None:
        raise FileNotFoundError(f"step dir {step_dir} holds no files")
    with open(largest, "r+b") as f:
        f.truncate(max(size // 2, 1))
    return largest
