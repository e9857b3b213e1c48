"""Step timing and profiler captures: the counterpart of the JAX
package's ``utils/profiling.py`` (``StepTimer``; ``start_trace`` /
``stop_trace`` / ``trace`` in the place of ``jax.profiler``'s).

A capture is a ``torch.profiler`` session with CPU and, where there is a
card, CUDA activities; it ends as a Chrome trace,
``<profile_dir>/trace.rank<r>.json`` (``r`` the ``torch.distributed``
rank, 0 without a group), which ``chrome://tracing`` and Perfetto open.
The phase names of ``obs/trace.py`` appear in it as
``user_annotation`` ranges and the kernels as ``kernel`` events."""

from __future__ import annotations

import contextlib
import os
import time

_active: tuple | None = None   # (profiler, profile_dir) of the capture


def start_trace(profile_dir: str) -> None:
    """Start the process's capture into ``profile_dir``."""
    global _active
    import torch

    if _active is not None:
        raise RuntimeError("a profiler capture is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _active = (prof, profile_dir)


def stop_trace() -> str:
    """End the capture and write its Chrome trace; returns its path.
    Waits for the card first, so the trace holds the device work of the
    steps it brackets (the one host wait a capture adds)."""
    global _active
    import torch

    if _active is None:
        raise RuntimeError("no profiler capture is running")
    prof, profile_dir = _active
    _active = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    rank = 0
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        rank = torch.distributed.get_rank()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace.rank{rank}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(profile_dir: str):
    """A capture of the bracketed code into ``profile_dir``."""
    start_trace(profile_dir)
    try:
        yield
    finally:
        stop_trace()


class StepTimer:
    """Rolling wall-clock over the last ``window`` steps: the host's
    dispatch rate, read without a device sync."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []

    def tick(self) -> None:
        self._times.append(time.perf_counter())
        if len(self._times) > self.window + 1:
            self._times.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / span if span > 0 else 0.0

    def examples_per_sec(self, batch_size: int) -> float:
        return self.steps_per_sec * batch_size
