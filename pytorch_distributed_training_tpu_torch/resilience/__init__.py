"""Resilience of the port's training runs: the fault-injection plane
(``faults``: ``crash``, ``stall``, ``sigterm``, ``nan_batch``,
``spike_batch``, ``ckpt_truncate``; and the serving tier's chaos plane,
``ServeFaultInjector``: ``replica_crash``, ``replica_stall``,
``replica_slow``, ``handoff_drop`` at router ticks), the preemption latch
(``preemption``: SIGTERM → step checkpoint → exit
:data:`PREEMPTED_EXIT_CODE`), the skip-step gate (``anomaly``), the
snapshot rollback (``recovery``), and the membership plane (``elastic``,
``--elastic-resize``): heartbeat-staleness slice-loss detection, peer
snapshots mirrored to cross-slice buddies, shrink to the survivors with
the global batch kept by accumulation, and grow-back over the
supervisor's backoff, chaos-tested by its own fault grammar
(``slice_lost@N:K``, ``slice_return@N``, ``host_hang@N:S``)."""

from ..utils.supervisor import PREEMPTED_EXIT_CODE
from .anomaly import (
    AnomalyPolicy, ResilienceState, guarded_apply, init_resilience_state,
)
from .elastic import (
    ELASTIC_TRANSITIONS, RESTORE_SOURCES, ElasticConfig, ElasticWorld,
    PeerSnapshotStore, SliceHealthMonitor, oracle_batch_digests,
    run_elastic_episode,
)
from .faults import (
    CRASH_EXIT_CODE, ELASTIC_FAULT_KINDS, FAULT_KINDS, SERVE_FAULT_KINDS,
    Fault, FaultInjector, ServeFault, ServeFaultInjector,
    parse_elastic_faults, parse_faults, parse_serve_faults,
    truncate_checkpoint,
)
from .preemption import Preempted, PreemptionHandler
from .recovery import RecoveryAborted, RecoveryConfig, RecoveryManager

__all__ = [
    "AnomalyPolicy", "CRASH_EXIT_CODE", "ELASTIC_FAULT_KINDS",
    "ELASTIC_TRANSITIONS", "ElasticConfig", "ElasticWorld", "FAULT_KINDS",
    "Fault", "FaultInjector", "PREEMPTED_EXIT_CODE", "PeerSnapshotStore",
    "Preempted", "PreemptionHandler", "RESTORE_SOURCES", "RecoveryAborted",
    "RecoveryConfig", "RecoveryManager", "ResilienceState",
    "SERVE_FAULT_KINDS", "ServeFault", "ServeFaultInjector",
    "SliceHealthMonitor", "guarded_apply", "init_resilience_state",
    "oracle_batch_digests", "parse_elastic_faults", "parse_faults",
    "parse_serve_faults", "run_elastic_episode", "truncate_checkpoint",
]
