"""The host-RAM tier under the paged block pool and the cross-replica
sibling fetch: the counterpart of the JAX package's ``serve/kv_store.py``
(host numpy only).

When the block pool (``serve/kv_pool.py::BlockPool``) evicts a cached
prefix block under pressure, it spills the block's K/V bytes here, keyed
by the chained content hash its device registry uses, and a later
hash-chain hit restores them into a fresh device block instead of
recomputing the prefix: a lossless host round trip.

:class:`HostKVStore` is a capacity-bounded LRU byte store with exact
accounting.  All chain semantics (parent links, cascade drops of
unrestorable descendants) live in ``BlockPool``.

:func:`sibling_fetch` / :func:`sibling_fetch_striped` copy a prompt's
hot prefix blocks from other replicas' pools into one pool's host tier
(the router's rebalance, ``serve/router.py``): a block live in a source
pool is read device to host from that pool's device, so replicas on
different cards exchange bytes through host RAM.
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


def sibling_fetch(dst, src, prompt: np.ndarray) -> int:
    """Copy ``prompt``'s hot prefix blocks from ``src`` into ``dst``'s
    host tier (both ``BlockPool``s); returns the blocks fetched.

    Walks the chained block hashes in order: a hash ``dst`` resolves
    already (either tier) is skipped, one only ``src`` resolves is copied
    (device to host when it is live in ``src``), and the walk stops at
    the first hash neither resolves, so the fetched chain stays a
    contiguous leading run.  The bytes land in the host tier: the next
    admission on ``dst`` restores the blocks it needs."""
    if dst.host is None:
        raise ValueError(
            "sibling_fetch needs a host tier on the destination pool "
            "(construct it with a HostKVStore)"
        )
    if dst.block_size != src.block_size:
        raise ValueError(
            f"block size mismatch: dst {dst.block_size} != src "
            f"{src.block_size} — the chained hashes would never align"
        )
    return sibling_fetch_striped(dst, [src], prompt)


def sibling_fetch_striped(dst, srcs, prompt: np.ndarray) -> int:
    """:func:`sibling_fetch` from several sources: missing block *i* is
    read from source ``i % len(srcs)``, falling back to the others in
    order when that one cannot resolve it.  With one source it is
    ``sibling_fetch``, byte for byte and counter for counter."""
    from .kv_pool import hash_prompt_blocks

    if dst.host is None:
        raise ValueError(
            "sibling_fetch needs a host tier on the destination pool "
            "(construct it with a HostKVStore)"
        )
    srcs = [s for s in srcs if s is not None and s is not dst]
    for src in srcs:
        if dst.block_size != src.block_size:
            raise ValueError(
                f"block size mismatch: dst {dst.block_size} != src "
                f"{src.block_size} — the chained hashes would never align"
            )
    if not srcs:
        return 0
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    chain = hash_prompt_blocks(prompt, dst.block_size)
    fetched = 0
    for i, k in striped_walk(len(chain), lambda i: dst.resolvable(chain[i]),
                             lambda k, i: srcs[k].resolvable(chain[i]),
                             len(srcs)):
        arrays = srcs[k].read_block_bytes(chain[i])
        parent = chain[i - 1] if i else None
        if not dst.adopt_host_block(chain[i], parent, arrays):
            break
        fetched += 1
    dst.sibling_fetched_blocks += fetched
    return fetched


def striped_walk(length: int, dst_has, src_has, n_srcs: int):
    """The striped sibling fetch's walk over a chain of ``length`` blocks:
    yields ``(i, k)``, block *i* from source *k*, in chain order.  A block
    the destination holds (``dst_has(i)``) is skipped; missing block *i*
    comes from source ``n % n_srcs`` (``n`` the blocks yielded before
    it), falling back to the others in order (``src_has(k, i)``); the walk
    ends at the first block no source holds.  Lazy: the caller moves each
    block before it asks for the next (an adoption can change what the
    destination holds), and stops early when one is refused.  The one
    policy of :func:`sibling_fetch_striped` and of ``serve/tp.py``'s fetch
    between tensor-parallel groups."""
    n = 0
    for i in range(length):
        if dst_has(i):
            continue
        for j in range(n_srcs):
            k = (n + j) % n_srcs
            if src_has(k, i):
                break
        else:
            return
        yield i, k
        n += 1
