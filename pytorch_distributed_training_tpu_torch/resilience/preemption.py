"""Preemption-aware shutdown: SIGTERM → step checkpoint → distinct exit
(the JAX package's ``resilience/preemption.py``).

A preemption arrives as SIGTERM with a short grace window.  Python's
default handling kills the process wherever it stands — up to a full
epoch of work gone, and the supervisor charges the death against
``max_restarts`` as if the code were at fault.  The handler here converts
the signal into a *flag* the trainer polls at step boundaries: the
in-flight step completes, a synchronous step-granular checkpoint commits,
and the process exits :data:`~..utils.supervisor.PREEMPTED_EXIT_CODE` —
which ``supervise()`` relaunches (with ``--resume``) WITHOUT counting a
restart, because preemption is the platform's fault, not the run's.

Under data parallelism each rank latches its own signal: a SIGTERM that
reaches the ranks at different steps leaves the ranks still training
blocked in the next all-reduce until the group's timeout, as in JAX.
"""

from __future__ import annotations

import signal


class Preempted(RuntimeError):
    """Raised by the trainer at the step boundary after the preemption
    checkpoint committed; the CLI converts it into the distinct exit."""

    def __init__(self, step: int, saved: bool):
        super().__init__(
            f"preempted at global step {step} "
            f"({'checkpoint committed' if saved else 'no checkpoint dir'})"
        )
        self.step = step
        self.saved = saved


class PreemptionHandler:
    """Latches termination signals into a pollable flag.

    ``install()`` must run in the main thread (CPython restricts signal
    registration); ``uninstall()`` restores the previous handlers, so
    tests and nested uses don't leak the latch.  Usable as a context
    manager.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.triggered = False
        self._prev: dict = {}

    def _latch(self, signum, frame) -> None:
        self.triggered = True

    def install(self) -> "PreemptionHandler":
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._latch)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
