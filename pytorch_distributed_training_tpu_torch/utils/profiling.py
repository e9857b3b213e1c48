"""Step timing: the counterpart of the JAX package's
``utils/profiling.py::StepTimer`` (its ``trace`` capture comes with the
profiling slice; ``tools/train_profile.py`` drives ``torch.profiler``)."""

from __future__ import annotations

import time


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
