"""Failure detection and elastic restart for training runs: the JAX
package's ``utils/supervisor.py``, copied so the port needs no JAX (it
never imported any).

The reference's failure-handling story is three asserts; any rank crash
hangs the NCCL collective and the job dies with no recovery.  This module
is the equivalent of torchelastic's supervision loop:

- ``Heartbeat``: the training process touches a file at epoch starts, log
  points and saves; a stall past ``timeout_s`` marks the run hung (a
  collective whose peer died hangs until its timeout — a wall-clock
  heartbeat is the portable detector).
- ``supervise()``: run the training command as a child process, watch exit
  codes and the heartbeat, and relaunch with ``--resume`` up to
  ``max_restarts`` times.  Combined with the per-epoch checkpoint
  (``checkpoint/manager.py``) and the step-derived start epoch
  (``cli/main.py --resume``), a crash costs at most one epoch of work
  (one ``--ckpt-every-steps`` interval with step checkpoints).

The CLI exposes this as ``--elastic --max-restarts N`` (cli/main.py): the
entrypoint re-executes itself under supervision with ``--resume`` appended
on every relaunch.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

from .backoff import BackoffPolicy

# Single source of truth for the supervisor<->trainer wiring; read via
# Heartbeat.from_env() so a rename cannot silently disable hang detection.
HEARTBEAT_ENV = "PDT_HEARTBEAT_FILE"

# Cumulative crash-backoff seconds this supervisor has slept, exported to
# each relaunched child, whose goodput ledger (obs/ledger.py, --goodput)
# charges them to ``supervisor_backoff`` and widens its wall clock by
# them.
BACKOFF_ENV = "PDT_BACKOFF_S"

# Exit code of a run that checkpointed and exited on SIGTERM (a
# preemption notice; resilience/preemption.py).  75 = EX_TEMPFAIL:
# "temporary failure, retry" — the supervisor relaunches WITHOUT charging
# max_restarts (platform's fault) and without backoff (nothing is
# crash-looping).  Defined here, next to HEARTBEAT_ENV, because it is the
# other half of the supervisor<->trainer contract.
PREEMPTED_EXIT_CODE = 75


@dataclasses.dataclass
class Heartbeat:
    """Liveness file the training loop touches; watchers test staleness."""

    path: str
    timeout_s: float = 600.0

    @classmethod
    def from_env(cls) -> "Heartbeat | None":
        path = os.environ.get(HEARTBEAT_ENV)
        return cls(path) if path else None

    def beat(self) -> None:
        # In-place mtime touch; the watcher uses mtime only, so readers must
        # not rely on the (informational, possibly mid-write) content.
        with open(self.path, "w") as f:
            f.write(str(time.time()))

    def age_s(self) -> float | None:
        try:
            return time.time() - os.path.getmtime(self.path)
        except OSError:
            return None

    def is_stale(self) -> bool:
        age = self.age_s()
        return age is not None and age > self.timeout_s


@dataclasses.dataclass
class SupervisorResult:
    exit_code: int
    restarts: int
    hung_kills: int
    preemptions: int = 0


def supervise(
    argv: list[str],
    *,
    max_restarts: int = 3,
    heartbeat_path: str | None = None,
    heartbeat_timeout_s: float = 600.0,
    poll_s: float = 5.0,
    make_resume_args=None,
    backoff_base_s: float = 1.0,
    backoff_max_s: float = 60.0,
    backoff_jitter: float = 0.5,
    max_preemptions: int = 100,
    _print=print,
    _sleep=time.sleep,
) -> SupervisorResult:
    """Run ``argv`` as a child; relaunch on crash or hang, up to
    ``max_restarts`` times.

    ``make_resume_args(attempt)`` maps the base argv to the relaunch argv
    (default: append ``--resume`` once).  Exit code 0 ends supervision;
    nonzero exits and heartbeat stalls trigger a relaunch.

    Crash relaunches back off exponentially with jitter —
    ``backoff_base_s * 2**(restart-1)`` capped at ``backoff_max_s``,
    scaled by a uniform ``1 ± backoff_jitter`` draw — so a crash-looping
    child cannot burn the whole restart budget in seconds (and a fleet of
    supervisors doesn't relaunch in lockstep).  ``backoff_base_s=0``
    disables the wait (tests).  The schedule is
    ``utils.backoff.BackoffPolicy``.

    Exit code :data:`PREEMPTED_EXIT_CODE` is the trainer's
    "checkpointed on SIGTERM" signal: relaunched immediately, counted in
    ``preemptions``, NOT charged against ``max_restarts`` (capped at
    ``max_preemptions`` as a runaway guard — a child that exits 75 in a
    loop without the platform actually preempting it is a bug, not a
    preemption storm).
    """
    if make_resume_args is None:
        def make_resume_args(attempt: int) -> list[str]:
            return argv if "--resume" in argv else argv + ["--resume"]

    hb = Heartbeat(heartbeat_path, heartbeat_timeout_s) if heartbeat_path else None
    restarts = 0
    hung_kills = 0
    preemptions = 0
    cum_backoff_s = 0.0
    backoff = BackoffPolicy(
        base_s=backoff_base_s, max_s=backoff_max_s, jitter=backoff_jitter,
    )
    attempt_argv = argv
    while True:
        if hb is not None:
            hb.beat()  # fresh epoch for the watcher
        env = dict(os.environ)
        if hb is not None:
            # The training loop beats through this (train/trainer.py).
            env[HEARTBEAT_ENV] = hb.path
        # Cumulative backoff slept so far (each attempt's ledger is
        # truncated on open, so the last one must carry the whole run's).
        env[BACKOFF_ENV] = repr(cum_backoff_s)
        proc = subprocess.Popen(attempt_argv, env=env)
        code = None
        while code is None:
            try:
                code = proc.wait(timeout=poll_s)
            except subprocess.TimeoutExpired:
                if hb is not None and hb.is_stale():
                    _print(
                        f"supervisor: heartbeat stale (> {hb.timeout_s:.0f}s), "
                        "killing hung training process"
                    )
                    proc.kill()
                    # The child may have finished in the staleness/kill race
                    # window: wait() then reports its real status (0 =
                    # success, not a hang) rather than our SIGKILL.
                    code = proc.wait()
                    if code != 0:
                        hung_kills += 1
        if code == 0:
            return SupervisorResult(0, restarts, hung_kills, preemptions)
        if code == PREEMPTED_EXIT_CODE and preemptions < max_preemptions:
            preemptions += 1
            _print(
                f"supervisor: preempted (exit {code}), checkpoint committed; "
                f"relaunch {preemptions} (not counted against max_restarts)"
            )
            attempt_argv = make_resume_args(restarts)
            continue
        if restarts >= max_restarts:
            _print(
                f"supervisor: giving up after {restarts} restarts "
                f"(last exit code {code})"
            )
            return SupervisorResult(code, restarts, hung_kills, preemptions)
        restarts += 1
        delay = backoff.delay(restarts)
        _print(
            f"supervisor: training exited with {code}; "
            f"restart {restarts}/{max_restarts} in {delay:.1f}s "
            "(resuming from checkpoint)"
        )
        if delay > 0:
            _sleep(delay)
        cum_backoff_s += delay
        attempt_argv = make_resume_args(restarts)
