"""Resilience of the port's training runs: the fault-injection plane
(``faults``: ``crash``, ``stall``, ``sigterm``, ``ckpt_truncate``) and the
preemption latch (``preemption``: SIGTERM → step checkpoint → exit
:data:`PREEMPTED_EXIT_CODE`).  The JAX package's skip-step anomaly
policy, rollback recovery and elastic resizing are not ported yet."""

from ..utils.supervisor import PREEMPTED_EXIT_CODE
from .faults import (
    CRASH_EXIT_CODE, FAULT_KINDS, Fault, FaultInjector, parse_faults,
    truncate_checkpoint,
)
from .preemption import Preempted, PreemptionHandler

__all__ = [
    "CRASH_EXIT_CODE", "FAULT_KINDS", "Fault", "FaultInjector",
    "PREEMPTED_EXIT_CODE", "Preempted", "PreemptionHandler", "parse_faults",
    "truncate_checkpoint",
]
