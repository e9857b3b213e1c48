"""Continuous-batching serving over the contiguous or the paged KV cache.

- ``kv_pool``   — the contiguous slot pool (per-slot lengths, O(1)
  allocate/release, idle-slot sentinel) and the paged block pool (block
  tables, prefix cache, LRU eviction, copy on write).
- ``kv_store``  — the host-RAM tier evicted prefix blocks spill to, and
  the cross-replica sibling fetch.
- ``engine``    — chunked prefill + decode + speculative verify over the
  slot array, per-slot EOS/budget retirement, token streaming; the
  prefill/decode roles and their KV handoff.
- ``disagg``    — the disaggregated tier: a prefill-role and a
  decode-role engine behind one engine surface.
- ``router``    — N replicas behind prefix-affinity, least-loaded
  routing with the sibling fetch, and the chaos plane's hooks.
- ``failover``  — replica failover: missed-tick, heartbeat and straggler
  detection, fence, drain and requeue exactly once, retry budgets,
  brown-out, backoff respawn.
- ``autoscale`` — the closed loop: replica scaling, role re-splits, the
  pressure ladder.
- ``policy``    — priority classes and the SLO-weighted deficit
  admission.
- ``tp``        — the lockstep driver of a tensor-parallel engine's
  ranks, and tensor-parallel replicas led by other processes.
- ``draft``     — the prompt-lookup drafter and shared n-gram index.
- ``scheduler`` — admission into freed slots every tick, bounded queue,
  deadlines, per-request records.
- ``metrics``   — TTFT/TPOT/goodput summaries.
"""

from .autoscale import AutoscaleController
from .disagg import DisaggServingEngine
from .draft import NgramIndex, PromptLookupDrafter
from .engine import Event, Handoff, ServingEngine
from .failover import FailoverController, ReplicaHealth
from .kv_pool import (
    BlockPool, KVCachePool, PagedKVCachePool, SlotExport, hash_prompt_blocks,
)
from .kv_store import HostKVStore, sibling_fetch, sibling_fetch_striped
from .metrics import finalize_record, percentile, summarize_records
from .policy import PriorityClass, ServePolicy, parse_priority_spec
from .router import ReplicaRouter
from .scheduler import ContinuousScheduler, Request, VirtualClock
from .tp import LockstepEngine, follow

__all__ = [
    "AutoscaleController", "FailoverController", "ReplicaHealth",
    "PriorityClass", "ServePolicy", "parse_priority_spec", "NgramIndex",
    "PromptLookupDrafter", "Event", "Handoff",
    "ServingEngine", "DisaggServingEngine", "ReplicaRouter",
    "KVCachePool", "BlockPool", "PagedKVCachePool", "SlotExport",
    "hash_prompt_blocks", "HostKVStore", "sibling_fetch",
    "sibling_fetch_striped", "finalize_record", "percentile",
    "summarize_records", "ContinuousScheduler", "Request", "VirtualClock",
    "LockstepEngine", "follow",
]
