"""Capped exponential backoff with jitter: the restart-delay policy of
the JAX package's ``utils/backoff.py``, copied so the port needs no JAX.

The training supervisor (``utils/supervisor.supervise`` relaunching a
crashed trainer) waits by it: double per consecutive failure from
``base_s``, cap at ``max_s``, scale by a uniform ``1 ± jitter`` draw so a
fleet doesn't relaunch in lockstep.  The constants are the JAX package's
(its serving failover controller shares them; that tier is not ported).

The jitter rng is owned by the policy and seeded deterministically, so a
given sequence of ``delay()`` calls replays exactly — scripted chaos
tests pin respawn times to the tick.
"""

from __future__ import annotations

import dataclasses
import random

# Default schedule shared by the training supervisor and replica respawn:
# 1s, 2s, 4s, ... capped at 60s, ±50% jitter.
DEFAULT_BASE_S = 1.0
DEFAULT_MAX_S = 60.0
DEFAULT_JITTER = 0.5
_JITTER_SEED = 0xB0FF


@dataclasses.dataclass
class BackoffPolicy:
    """``delay(attempt)`` for attempt 1, 2, 3, ... is
    ``min(base_s * 2**(attempt-1), max_s)`` scaled by a uniform draw in
    ``[1 - jitter, 1 + jitter]``.  ``base_s = 0`` disables the wait
    entirely (tests); ``jitter = 0`` makes the schedule exact."""

    base_s: float = DEFAULT_BASE_S
    max_s: float = DEFAULT_MAX_S
    jitter: float = DEFAULT_JITTER
    seed: int = _JITTER_SEED

    def __post_init__(self):
        if self.base_s < 0 or self.max_s < 0:
            raise ValueError(
                f"backoff wants base_s/max_s >= 0, got "
                f"{self.base_s}/{self.max_s}"
            )
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        self._rng = random.Random(self.seed)

    def delay(self, attempt: int) -> float:
        """Seconds to wait before relaunch ``attempt`` (1-based: the
        first relaunch after the first failure is attempt 1)."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        d = min(self.base_s * (2.0 ** (attempt - 1)), self.max_s)
        if self.jitter and d > 0:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return d
