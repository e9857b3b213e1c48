"""The host-RAM tier under the paged block pool: the counterpart of the
JAX package's ``serve/kv_store.py::HostKVStore`` (host numpy only).

When the block pool (``serve/kv_pool.py::BlockPool``) evicts a cached
prefix block under pressure, it spills the block's K/V bytes here, keyed
by the chained content hash its device registry uses, and a later
hash-chain hit restores them into a fresh device block instead of
recomputing the prefix: a lossless host round trip.

:class:`HostKVStore` is a capacity-bounded LRU byte store with exact
accounting.  All chain semantics (parent links, cascade drops of
unrestorable descendants) live in ``BlockPool``.  The cross-replica
sibling fetch of the JAX module waits for the router's port.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


class _HostBlock:
    """One spilled block: its K/V arrays (leaf order) + exact bytes."""

    __slots__ = ("arrays", "nbytes")

    def __init__(self, arrays: list[np.ndarray]):
        self.arrays = arrays
        self.nbytes = int(sum(int(a.nbytes) for a in arrays))


class HostKVStore:
    """Capacity-bounded LRU host-RAM store of spilled KV blocks.

    Keys are the block pool's chained content hashes; values are the
    block's per-layer K/V arrays as host numpy.  ``put`` evicts
    oldest-first until the new entry fits and returns the dropped hashes
    so the caller can cascade-invalidate their descendants; an entry
    larger than the whole capacity is refused (``stored=False``).
    """

    def __init__(self, capacity_bytes: int):
        if capacity_bytes < 0:
            raise ValueError(
                f"capacity_bytes must be >= 0, got {capacity_bytes}"
            )
        self.capacity_bytes = int(capacity_bytes)
        self._entries: OrderedDict[object, _HostBlock] = OrderedDict()
        self.bytes_used = 0
        self.stored_blocks = 0
        self.dropped_blocks = 0
        self.hit_blocks = 0

    def __len__(self) -> int:
        return len(self._entries)

    def has(self, h) -> bool:
        return h in self._entries

    def pop(self, h) -> list[np.ndarray] | None:
        """Remove ``h`` and return its arrays (a restore claims the entry
        out of the store: the device registry holds the hash again)."""
        entry = self._entries.pop(h, None)
        if entry is None:
            return None
        self.bytes_used -= entry.nbytes
        self.hit_blocks += 1
        return entry.arrays

    def put(self, h, arrays: list[np.ndarray]) -> tuple[bool, list]:
        """Store ``h``; returns ``(stored, dropped_hashes)``.  Oldest
        entries are dropped until the new one fits; the caller treats
        every dropped hash as unresolvable."""
        if h in self._entries:
            self._entries.move_to_end(h)
            return True, []
        entry = _HostBlock([np.asarray(a) for a in arrays])
        if entry.nbytes > self.capacity_bytes:
            return False, []
        dropped: list = []
        while self.bytes_used + entry.nbytes > self.capacity_bytes:
            old_h, old = self._entries.popitem(last=False)
            self.bytes_used -= old.nbytes
            self.dropped_blocks += 1
            dropped.append(old_h)
        self._entries[h] = entry
        self.bytes_used += entry.nbytes
        self.stored_blocks += 1
        return True, dropped

    def drop(self, h) -> bool:
        """Remove ``h`` without reading it (a cascade invalidation, or a
        device registration superseding the host copy)."""
        entry = self._entries.pop(h, None)
        if entry is None:
            return False
        self.bytes_used -= entry.nbytes
        self.dropped_blocks += 1
        return True

    def stats(self) -> dict:
        return {
            "host_blocks": len(self._entries),
            "host_bytes": self.bytes_used,
            "host_capacity_bytes": self.capacity_bytes,
            "host_stored_blocks": self.stored_blocks,
            "host_dropped_blocks": self.dropped_blocks,
            "host_hit_blocks": self.hit_blocks,
        }

    def check_accounting(self) -> None:
        """Exact-bytes audit (test hook): the ledger equals the sum of the
        live entries' array bytes."""
        actual = sum(e.nbytes for e in self._entries.values())
        if actual != self.bytes_used:
            raise AssertionError(
                f"host tier byte ledger drift: ledger {self.bytes_used} "
                f"!= live entries {actual}"
            )

    def reset(self) -> None:
        self._entries.clear()
        self.bytes_used = 0
        self.stored_blocks = 0
        self.dropped_blocks = 0
        self.hit_blocks = 0
