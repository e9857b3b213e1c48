"""Continuous-batching serving over the contiguous or the paged KV cache.

- ``kv_pool``   — the contiguous slot pool (per-slot lengths, O(1)
  allocate/release, idle-slot sentinel) and the paged block pool (block
  tables, prefix cache, LRU eviction, copy on write).
- ``kv_store``  — the host-RAM tier evicted prefix blocks spill to.
- ``engine``    — chunked prefill + decode + speculative verify over the
  slot array, per-slot EOS/budget retirement, token streaming.
- ``draft``     — the prompt-lookup drafter and shared n-gram index.
- ``scheduler`` — admission into freed slots every tick, bounded queue,
  deadlines, per-request records.
- ``metrics``   — TTFT/TPOT/goodput summaries.
"""

from .draft import NgramIndex, PromptLookupDrafter
from .engine import Event, ServingEngine
from .kv_pool import BlockPool, KVCachePool, PagedKVCachePool
from .kv_store import HostKVStore
from .metrics import finalize_record, percentile, summarize_records
from .scheduler import ContinuousScheduler, Request, VirtualClock

__all__ = [
    "NgramIndex", "PromptLookupDrafter", "Event", "ServingEngine",
    "KVCachePool", "BlockPool", "PagedKVCachePool", "HostKVStore",
    "finalize_record", "percentile", "summarize_records",
    "ContinuousScheduler", "Request", "VirtualClock",
]
