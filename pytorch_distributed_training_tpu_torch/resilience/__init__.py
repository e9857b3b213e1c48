"""Resilience of the port's training runs: the fault-injection plane
(``faults``: ``crash``, ``stall``, ``sigterm``, ``nan_batch``,
``spike_batch``, ``ckpt_truncate``; and the serving tier's chaos plane,
``ServeFaultInjector``: ``replica_crash``, ``replica_stall``,
``replica_slow``, ``handoff_drop`` at router ticks), the preemption latch
(``preemption``: SIGTERM → step checkpoint → exit
:data:`PREEMPTED_EXIT_CODE`), the skip-step gate (``anomaly``) and the
snapshot rollback (``recovery``).  The JAX package's elastic resizing is
not ported yet."""

from ..utils.supervisor import PREEMPTED_EXIT_CODE
from .anomaly import (
    AnomalyPolicy, ResilienceState, guarded_apply, init_resilience_state,
)
from .faults import (
    CRASH_EXIT_CODE, FAULT_KINDS, SERVE_FAULT_KINDS, Fault, FaultInjector,
    ServeFault, ServeFaultInjector, parse_faults, parse_serve_faults,
    truncate_checkpoint,
)
from .preemption import Preempted, PreemptionHandler
from .recovery import RecoveryAborted, RecoveryConfig, RecoveryManager

__all__ = [
    "AnomalyPolicy", "CRASH_EXIT_CODE", "FAULT_KINDS", "Fault",
    "FaultInjector", "PREEMPTED_EXIT_CODE", "Preempted", "PreemptionHandler",
    "RecoveryAborted", "RecoveryConfig", "RecoveryManager",
    "ResilienceState", "SERVE_FAULT_KINDS", "ServeFault",
    "ServeFaultInjector", "guarded_apply", "init_resilience_state",
    "parse_faults", "parse_serve_faults", "truncate_checkpoint",
]
