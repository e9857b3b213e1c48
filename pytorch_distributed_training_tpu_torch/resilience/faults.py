"""Deterministic fault injection, the counterpart of the JAX package's
``resilience/faults.py``: the training plane that proves the checkpoint,
the preemption exit and the supervisor, and the serving tier's chaos
plane that proves the router's failover (``serve/failover.py``).

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
run or a uint8 one.

The serving faults (:data:`SERVE_FAULT_KINDS`, ``--serve-inject-faults``
or ``PDT_SERVE_FAULTS``) are ``kind@tick[:replica[:arg]]`` entries
evaluated against the ``ReplicaRouter``'s 1-based tick counter by
:class:`ServeFaultInjector`: ``replica_crash@T:K[:role]`` (replica K, or
one role pool of a disaggregated replica, stops responding at tick T),
``replica_stall@T:K[:N]`` (misses N ticks, default 8),
``replica_slow@T:K:F`` (responds once in every F ticks) and
``handoff_drop@T`` (one parked prefill->decode handoff is lost).

The elastic membership faults (:data:`ELASTIC_FAULT_KINDS`,
``--elastic-resize``, :func:`parse_elastic_faults`) are evaluated by the
elastic resize plane (``resilience/elastic.py``) against the global
step: ``slice_lost@N:K`` (slice K's ranks stop beating at step N),
``slice_return@N`` (they beat again; the run grows back) and
``host_hang@N[:S]`` (rank 0 misses S boundaries of heartbeats, default
8).  ``--inject-faults`` refuses them, naming ``--elastic-resize``.

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
SERVE_FAULT_KINDS = ("replica_crash", "replica_stall", "replica_slow",
                     "handoff_drop")
# Elastic-membership faults (evaluated by the elastic resize plane,
# resilience/elastic.py, against the GLOBAL step): they mutate the
# heartbeat stream, and the SliceHealthMonitor has to notice from
# staleness alone, never from an exit code.
#
# - ``slice_lost@N:K``   — slice K's ranks stop beating at step N.
# - ``slice_return@N``   — the lost slice's ranks beat again at step N;
#   the run grows back at that boundary after the shared backoff.
# - ``host_hang@N[:S]``  — rank 0 misses S steps of heartbeats (default
#   8) then resumes: below the monitor's patience this must flag a
#   ``host_stall`` anomaly WITHOUT declaring the slice lost.
ELASTIC_FAULT_KINDS = ("slice_lost", "slice_return", "host_hang")

_SERVE_ROLES = ("prefill", "decode")
_DEFAULT_STALL_TICKS = 8
_DEFAULT_HANG_STEPS = 8

# Distinct from real Python tracebacks (1) and signal deaths (negative /
# 128+N) so the chaos harness can assert WHICH death it injected.
CRASH_EXIT_CODE = 13

FAULTS_ENV = "PDT_FAULTS"
SERVE_FAULTS_ENV = "PDT_SERVE_FAULTS"

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
        if sep and kind in SERVE_FAULT_KINDS:
            raise ValueError(
                f"fault entry {item!r}: {kind} is a serving fault evaluated "
                "at router ticks — pass it via --serve-inject-faults, not "
                "--inject-faults"
            )
        if sep and kind in ELASTIC_FAULT_KINDS:
            # A silently ignored membership fault would make a chaos
            # run vacuously green — refuse loudly with the right flag.
            raise ValueError(
                f"fault entry {item!r}: {kind} is an elastic membership "
                "fault evaluated by the elastic resize plane — pass it "
                "via --elastic-resize, not --inject-faults"
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



def parse_elastic_faults(spec: str) -> list[Fault]:
    """Parse the elastic membership plan ``kind@step[:arg],...`` (see
    :data:`ELASTIC_FAULT_KINDS` for the grammar per kind).  Validation is
    fail-fast: a plan that would fire as a no-op (fractional hang,
    missing slice index) is refused at parse time, before any marker
    could be written."""
    faults = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        kind, sep, rest = item.partition("@")
        if not sep or kind not in ELASTIC_FAULT_KINDS:
            raise ValueError(
                f"elastic fault entry {item!r} is not kind@step[:arg] with "
                f"kind in {ELASTIC_FAULT_KINDS}"
            )
        step_s, _, arg_s = rest.partition(":")
        try:
            step = int(step_s)
        except ValueError:
            raise ValueError(
                f"elastic fault entry {item!r}: bad step {step_s!r}"
            ) from None
        if step < 0:
            raise ValueError(
                f"elastic fault entry {item!r}: step must be >= 0"
            )
        arg = None
        try:
            if kind == "slice_lost":
                if not arg_s:
                    raise ValueError("slice_lost wants step:slice_index")
                arg = float(int(arg_s))
                if arg < 0:
                    raise ValueError("slice index must be >= 0")
            elif kind == "slice_return":
                if arg_s:
                    raise ValueError("slice_return takes no arg")
            else:  # host_hang
                arg = float(arg_s) if arg_s else float(_DEFAULT_HANG_STEPS)
                # A fractional hang would truncate to a shorter stall at
                # fire time (the monitor counts whole steps): refused.
                if arg != int(arg) or arg < 1:
                    raise ValueError("hang steps must be an integer >= 1")
        except ValueError as e:
            raise ValueError(
                f"elastic fault entry {item!r}: {e}"
            ) from None
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


# ---------------------------------------------------------------------- #
# serving-tier faults (the chaos plane of serve/failover.py)
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ServeFault:
    kind: str
    tick: int
    replica: int | None = None
    arg: float | None = None      # stall ticks / slow factor
    role: str | None = None       # replica_crash only: prefill | decode

    @property
    def name(self) -> str:
        parts = [str(self.tick)]
        if self.replica is not None:
            parts.append(str(self.replica))
        if self.arg is not None:
            parts.append(f"{self.arg:g}")
        if self.role is not None:
            parts.append(self.role)
        return f"{self.kind}@{':'.join(parts)}"


def parse_serve_faults(spec: str) -> list[ServeFault]:
    """Parse ``kind@tick[:replica[:arg]],...`` into :class:`ServeFault`
    entries (the grammar per kind in the module docstring).  A plan that
    would fire as a no-op (tick 0, a fractional slow factor) is refused
    here, before any marker could be written."""
    faults = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        kind, sep, rest = item.partition("@")
        if not sep or kind not in SERVE_FAULT_KINDS:
            raise ValueError(
                f"serve fault entry {item!r} is not kind@tick[:replica"
                f"[:arg]] with kind in {SERVE_FAULT_KINDS}"
            )
        fields = rest.split(":")
        try:
            tick = int(fields[0])
        except ValueError:
            raise ValueError(
                f"serve fault entry {item!r}: bad tick {fields[0]!r}"
            ) from None
        if tick < 1:
            # Router ticks are 1-based: a tick-0 fault would validate and
            # then never fire.
            raise ValueError(
                f"serve fault entry {item!r}: ticks are 1-based"
            )
        replica, arg, role = None, None, None
        try:
            if kind == "handoff_drop":
                if len(fields) != 1:
                    raise ValueError("handoff_drop takes no args")
            else:
                if len(fields) < 2:
                    raise ValueError(f"{kind} wants a replica index")
                replica = int(fields[1])
                if replica < 0:
                    raise ValueError("replica index must be >= 0")
                if kind == "replica_crash":
                    if len(fields) == 3:
                        if fields[2] not in _SERVE_ROLES:
                            raise ValueError(
                                f"role must be one of {_SERVE_ROLES}"
                            )
                        role = fields[2]
                    elif len(fields) > 3:
                        raise ValueError("too many fields")
                elif kind == "replica_stall":
                    if len(fields) > 3:
                        raise ValueError("too many fields")
                    arg = float(fields[2]) if len(fields) == 3 \
                        else float(_DEFAULT_STALL_TICKS)
                    if arg < 1:
                        raise ValueError("stall ticks must be >= 1")
                else:  # replica_slow
                    if len(fields) != 3:
                        raise ValueError(
                            "replica_slow wants tick:replica:factor"
                        )
                    arg = float(fields[2])
                    # "One tick in every F": a fractional factor would
                    # truncate at arm time into a no-op fault.
                    if arg != int(arg) or arg < 2:
                        raise ValueError(
                            "slow factor must be an integer >= 2"
                        )
        except ValueError as e:
            raise ValueError(f"serve fault entry {item!r}: {e}") from None
        faults.append(ServeFault(kind, tick, replica, arg, role))
    return faults


class ServeFaultInjector:
    """Evaluates a serving fault plan at router tick boundaries
    (``ReplicaRouter.tick`` calls :meth:`on_tick` first every tick).  A
    fault only sets the router's per-replica fault state: the router
    then skips or throttles the replica's scheduler, so a dead replica
    presents as it would (silent, its heartbeat gauges stale) and the
    failover controller has to notice; the injector never tells it.
    Fired faults keep the training plane's once-per-run markers in
    ``state_dir``."""

    def __init__(self, faults: list[ServeFault], *,
                 state_dir: str | None = None, emitter=None):
        self.faults = list(faults)
        self.emitter = emitter
        self._markers = _FiredMarkers(state_dir)

    @classmethod
    def from_spec(cls, spec: str, **kwargs) -> "ServeFaultInjector":
        return cls(parse_serve_faults(spec), **kwargs)

    def validate(self, n_replicas: int) -> None:
        """Refuse a replica index the tier does not have (the router calls
        this when it is built): firing would write the marker first, and
        a supervised relaunch would then skip the fault silently."""
        for fault in self.faults:
            if fault.replica is not None and not (
                    0 <= fault.replica < n_replicas):
                raise ValueError(
                    f"serve fault {fault.name}: replica {fault.replica} "
                    f"out of range for a {n_replicas}-replica tier"
                )

    def fired(self, fault: ServeFault) -> bool:
        return self._markers.fired(fault.name)

    def _mark(self, fault: ServeFault) -> None:
        self._markers.mark(fault.name)
        if self.emitter is not None:
            self.emitter.anomaly(
                "fault_injected", fault=fault.kind, tick=fault.tick,
                **({"replica": fault.replica}
                   if fault.replica is not None else {}),
            )

    def on_tick(self, tick: int, router) -> None:
        """Fire any fault armed for this router tick."""
        for fault in self.faults:
            if fault.tick != tick or self.fired(fault):
                continue
            self._mark(fault)
            if fault.kind == "replica_crash":
                if fault.role is not None:
                    router.inject_role_death(fault.replica, fault.role)
                else:
                    router.set_fault(fault.replica, "crash")
            elif fault.kind == "replica_stall":
                router.set_fault(
                    fault.replica, "stall",
                    until_tick=tick + int(fault.arg or _DEFAULT_STALL_TICKS),
                )
            elif fault.kind == "replica_slow":
                router.set_fault(fault.replica, "slow",
                                 period=int(fault.arg))
            elif fault.kind == "handoff_drop":
                router.drop_handoff()


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
