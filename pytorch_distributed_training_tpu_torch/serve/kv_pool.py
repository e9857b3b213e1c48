"""KV-cache pools: the contiguous slot pool and the paged block pool, the
counterparts of the JAX package's ``serve/kv_pool.py``.

``KVCachePool``: one decode cache per layer, (num_slots, H, max_len + 1,
Dh) on the device (``models/layers.py::new_kv_cache``; the extra position
is the scratch row for dropped writes), slot = batch row.  The
correctness contract with slot-mode attention:

- a slot's valid cache content is exactly positions ``0..lengths[s]-1``;
  everything past that is stale bytes from earlier tenants,
- every attention read is masked to the querying row's own prefix, so
  stale bytes are never read before they are overwritten,
- an idle slot's write position is the ``sentinel`` (= ``max_len``), whose
  writes land in the scratch row: idle rows change no live position.

The paged layout is two classes, as in the JAX package:

- :class:`BlockPool` owns the physical blocks: the per-layer device
  tensors (``models/layers.py::new_kv_blocks``: num_blocks + 1 blocks, the
  last one the scratch block that takes dropped writes), the free list and
  refcounts, the hash-chained prefix registry with parent/child links,
  LRU eviction of refcount-0 cached blocks, and the optional host-RAM
  spill tier (``serve/kv_store.py::HostKVStore``).  Without a host tier
  an evicted hash becomes unresolvable and every registered descendant is
  unregistered in cascade; with one, the block's bytes spill to host RAM
  and a later chain hit restores them bit for bit.
- :class:`PagedKVCachePool` is a slot view over it: per-slot block tables,
  lengths, admission reservations and prefix caching (full prompt blocks
  are content-addressed by a chained hash, registered once fully written,
  refcount-shared on later hits, and the last one copied on write when a
  whole prompt is covered).

Slot state lives in host mirrors (lengths, tables, free lists), so the
engine never reads the device to schedule; the block table goes to the
device once per tick.  Block edits outside a forward (copy on write, host
restore) write the pool tensors in place, on the current stream; a spill
copies one block to the host (a device sync, on eviction's slow path).
Release never zeroes a block: stale bytes are masked, as in the
contiguous pool.

**Sharing and handoff** (``serve/disagg.py``).  Several
``PagedKVCachePool`` views may sit over one ``BlockPool``
(``blocks=``): the device tensors, prefix registry, host tier and
reservation budget are the substrate's, and a view brings only its slot
bookkeeping.  A slot leaves one view as a :class:`SlotExport` (paged:
the block-table row, its refcounts and reservation parked on the pool
until another view adopts it; contiguous: a reference to the still
allocated source row, copied row-wise at adoption).  The sibling fetch
(``serve/kv_store.py``) reads a block's bytes from whichever tier holds
them (``read_block_bytes``) and stores them into another pool's host tier
(``adopt_host_block``).  Under tensor parallelism every rank holds its
own pools over its local heads (``serve/tp.py``): the host state is the
same on every rank, the bytes are each rank's head shard.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Any

import numpy as np
import torch


class KVCachePool:
    """Allocate/release slots of a shared contiguous decode cache.

    ``model`` is a ``models.gpt2.GPT2``; the cache takes its dtype and
    device."""

    def __init__(self, model, *, num_slots: int, max_len: int):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 1 or max_len > model.cfg.max_seq_len:
            raise ValueError(
                f"max_len {max_len} outside 1..{model.cfg.max_seq_len} "
                "(the model's position table bounds the cache)"
            )
        self.num_slots = num_slots
        self.max_len = max_len
        self.cache = model.new_cache(num_slots, max_len)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.active = np.zeros((num_slots,), bool)
        # LIFO free list, reversed so a fresh pool hands out 0, 1, 2, ...
        self._free = list(range(num_slots - 1, -1, -1))

    @property
    def sentinel(self) -> int:
        """The idle-slot write position: its writes go to the scratch row."""
        return self.max_len

    @property
    def mask_len(self) -> int:
        """Mask length of the attention read window."""
        return self.max_len

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    def allocate(self) -> int | None:
        """Claim a free slot (None when full).  The new tenant starts at
        length 0; the previous tenant's K/V stay but are masked out."""
        if not self._free:
            return None
        i = self._free.pop()
        self.active[i] = True
        self.lengths[i] = 0
        return i

    def release(self, slot: int) -> None:
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        self.active[slot] = False
        self.lengths[slot] = 0
        self._free.append(slot)

    def advance(self, slot: int, n: int) -> None:
        """Record ``n`` tokens written to ``slot`` (after a step)."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        old = int(self.lengths[slot])
        if old + n > self.max_len:
            raise ValueError(
                f"slot {slot} overflow: {old} + {n} > {self.max_len}"
            )
        self.lengths[slot] = old + n

    # ------------------------------------------------------------------ #
    # prefill->decode handoff (serve/disagg.py): the contiguous layout
    # has no shared substrate, so the handle is the slot row; adoption
    # copies the K/V rows from the prefill pool's cache into the decode
    # pool's, then releases the source slot.
    # ------------------------------------------------------------------ #

    def export_slot(self, slot: int) -> "SlotExport":
        """Package ``slot`` for adoption by another contiguous pool; the
        slot stays allocated here until ``adopt_slot`` copies it (or
        ``release_export`` drops it)."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        return SlotExport(kind="contig", length=int(self.lengths[slot]),
                          src_pool=self, src_slot=slot)

    def adopt_slot(self, export: "SlotExport") -> int:
        """Claim a local slot, copy the source row's K/V across every
        layer on the device, release the source."""
        if export.kind != "contig":
            raise ValueError(
                "contiguous pools adopt contiguous exports only (a paged "
                "handoff travels by block table, not by row copy)"
            )
        src = export.src_pool
        if src.max_len != self.max_len:
            raise ValueError(
                f"row-copy handoff needs matching max_len "
                f"({src.max_len} != {self.max_len})"
            )
        slot = self.allocate()
        if slot is None:
            raise RuntimeError("no free slot to adopt into")
        for dst_layer, src_layer in zip(self.cache, src.cache):
            for d, s_ in zip(dst_layer, src_layer):
                d[slot].copy_(s_[export.src_slot])
        self.lengths[slot] = export.length
        src.release(export.src_slot)
        return slot

    def release_export(self, export: "SlotExport") -> None:
        """Drop an un-adopted export (handoff cancelled)."""
        export.src_pool.release(export.src_slot)

    def reset(self) -> None:
        """Drop all slots (bookkeeping only; cache bytes stay stale)."""
        self.active[:] = False
        self.lengths[:] = 0
        self._free = list(range(self.num_slots - 1, -1, -1))


def hash_prompt_blocks(prompt: np.ndarray, block_size: int) -> list:
    """Chained content hashes for every full block of ``prompt``: entry i
    keys tokens ``0..(i+1)*block_size``, so identical block contents at
    different prefixes never alias.  The prefix-cache address function
    shared by lookup, registration and restore."""
    out, h = [], None
    for i in range(prompt.size // block_size):
        h = hash((h, bytes(prompt[i * block_size:(i + 1) * block_size])))
        out.append(h)
    return out


@dataclasses.dataclass
class SlotExport:
    """One slot's KV handle in flight between pools (the prefill->decode
    handoff payload).  Paged: the block-table row; its refcounts stay
    claimed by the export, so the bytes never move and the source slot
    frees at once.  Contiguous: a reference to the still allocated source
    slot, copied row-wise at adoption."""

    kind: str  # "paged" | "contig"
    length: int
    # paged
    table_row: np.ndarray | None = None
    outstanding: int = 0
    pending_reg: list = dataclasses.field(default_factory=list)
    blocks: "BlockPool | None" = None
    # contig
    src_pool: KVCachePool | None = None
    src_slot: int = -1


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` as host numpy (bf16 kept bit for bit as int16)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


class BlockPool:
    """The physical KV block substrate of the paged pool.

    ``model`` is a ``models.gpt2.GPT2``; the blocks take its dtype and
    device, or the quantized layout of ``kv_quant`` ("int8"/"int4").
    Conservation invariant, audited by :meth:`check_invariants`:
    ``free + referenced + evictable == num_blocks`` and refcounts equal
    table references.
    """

    def __init__(self, model, *, num_blocks: int, block_size: int,
                 kv_quant: str | None = None, host_store=None):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.host = host_store
        self.cache = model.new_block_cache(num_blocks, block_size, kv_quant)
        # Exact bytes of ONE real block across every layer's KV tensors
        # (payload plus any scales): the unit of the host-tier ledger.
        self.block_bytes = sum(
            math.prod(t.shape[1:]) * t.element_size()
            for layer in self.cache for t in layer
        )
        self._free_blocks = list(range(num_blocks - 1, -1, -1))
        self.refcount = np.zeros((num_blocks,), np.int32)
        # hash -> block id for registered (immutable, fully written) blocks
        self._hash_to_block: dict = {}
        self._block_hash: dict[int, Any] = {}
        # refcount-0 registered blocks in LRU order (oldest first)
        self._evictable: OrderedDict[int, None] = OrderedDict()
        # Chain topology for every hash resolvable in either tier: parent
        # (None = chain root) and the reverse child sets.
        self._hash_parent: dict = {}
        self._hash_children: dict = {}
        # Worst-case blocks still owed to live slots across every view,
        # and the part of it riding in-flight slot exports.
        self.outstanding_total = 0
        self.outstanding_handoff = 0
        self._exports: dict[int, SlotExport] = {}
        self._views: list = []
        self.blocks_evicted = 0
        self.cow_copies = 0
        self.blocks_spilled = 0
        self.blocks_restored = 0
        self.chain_unregistered = 0
        self.sibling_fetched_blocks = 0

    # ------------------------------------------------------------------ #
    # block bytes
    # ------------------------------------------------------------------ #

    def read_device_block(self, bid: int) -> list[np.ndarray]:
        """One block's K/V bytes as host numpy, layer by layer (the spill
        extraction: a device sync per call)."""
        return [_to_host(t[bid]) for layer in self.cache for t in layer]

    def write_device_block(self, bid: int, arrays: list[np.ndarray]) -> None:
        """Write host bytes back into block ``bid`` in place (the restore)."""
        it = iter(arrays)
        for layer in self.cache:
            for t in layer:
                t[bid].copy_(torch.from_numpy(next(it)).view(t.dtype))

    def copy_block(self, src: int, dst: int) -> None:
        """Device-side copy of one block across every layer, in place (the
        copy on write)."""
        for layer in self.cache:
            for t in layer:
                t[dst].copy_(t[src])

    # ------------------------------------------------------------------ #
    # hash-chain registry (both tiers)
    # ------------------------------------------------------------------ #

    def resolvable(self, h) -> bool:
        """Whether ``h``'s bytes can be produced without recompute: live
        in the device registry or restorable from the host tier."""
        return h in self._hash_to_block or (
            self.host is not None and self.host.has(h)
        )

    def device_block(self, h) -> int | None:
        return self._hash_to_block.get(h)

    def host_has(self, h) -> bool:
        return self.host is not None and self.host.has(h)

    def register(self, h, bid: int, parent=None) -> bool:
        """Register a fully written block under its chained hash.  A hash
        whose parent is no longer resolvable is refused; a device
        registration supersedes any host copy of the same hash."""
        if h in self._hash_to_block or bid in self._block_hash:
            return False
        if parent is not None and not self.resolvable(parent):
            return False
        self._hash_to_block[h] = bid
        self._block_hash[bid] = h
        if self.host is not None:
            self.host.drop(h)
        self._link(h, parent)
        return True

    def _link(self, h, parent) -> None:
        self._hash_parent[h] = parent
        if parent is not None:
            self._hash_children.setdefault(parent, set()).add(h)

    def _unlink(self, h) -> None:
        parent = self._hash_parent.pop(h, None)
        if parent is not None:
            kids = self._hash_children.get(parent)
            if kids is not None:
                kids.discard(h)
                if not kids:
                    del self._hash_children[parent]

    def _kill_hash(self, h) -> None:
        """Forget ``h`` everywhere and cascade to its descendants: a child
        whose parent block is gone can never be part of a chain hit."""
        bid = self._hash_to_block.pop(h, None)
        if bid is not None:
            del self._block_hash[bid]
            self.chain_unregistered += 1
            if self.refcount[bid] == 0 and bid in self._evictable:
                del self._evictable[bid]
                self._free_blocks.append(bid)
        if self.host is not None and self.host.drop(h):
            self.chain_unregistered += 1
        self._unlink(h)
        for child in list(self._hash_children.pop(h, ())):
            self._kill_hash(child)

    def _hash_unresolvable(self, h) -> None:
        """``h`` just left its last tier: cascade-kill its descendants."""
        if self.resolvable(h):
            return
        self._unlink(h)
        for child in list(self._hash_children.pop(h, ())):
            self._kill_hash(child)

    # ------------------------------------------------------------------ #
    # block lifecycle
    # ------------------------------------------------------------------ #

    def take_block(self) -> int:
        """One block off the free list, evicting the LRU cached block when
        the list is dry (the admission reservation guarantees one).  With
        a host tier the evicted block's bytes spill there first; without
        one, or when the store refuses, the evicted hash and its
        registered descendants are unregistered in cascade."""
        if self._free_blocks:
            return self._free_blocks.pop()
        if not self._evictable:
            raise RuntimeError(
                "block pool exhausted with nothing evictable — admission "
                "reservation violated"
            )
        bid, _ = self._evictable.popitem(last=False)
        h = self._block_hash.pop(bid)
        del self._hash_to_block[h]
        self.blocks_evicted += 1
        stored = False
        if self.host is not None:
            parent = self._hash_parent.get(h)
            if parent is None or self.resolvable(parent):
                stored, dropped = self.host.put(h, self.read_device_block(bid))
                if stored:
                    self.blocks_spilled += 1
                for d in dropped:
                    self._hash_unresolvable(d)
        if not stored:
            self._hash_unresolvable(h)
        return bid

    def release_block(self, bid: int) -> None:
        self.refcount[bid] -= 1
        if self.refcount[bid] < 0:
            raise AssertionError(f"block {bid} refcount underflow")
        if self.refcount[bid] == 0:
            if bid in self._block_hash:
                self._evictable[bid] = None  # newest recency
            else:
                self._free_blocks.append(bid)

    def claim_registered(self, bid: int) -> None:
        """Refcount++ on a registered block, pinning it out of the
        evictable set while referenced."""
        if self.refcount[bid] == 0:
            self._evictable.pop(bid, None)
        self.refcount[bid] += 1

    def restore_block(self, h, parent) -> int | None:
        """Restore ``h`` from the host tier into a fresh device block
        (claimed at refcount 1, re-registered), or None when the host copy
        is gone.  ``h`` stays in the store across ``take_block``, whose
        spill checks that an evicted block's parent is still resolvable;
        that spill may itself drop ``h``, so the pop is checked."""
        if self.host is None or not self.host.has(h):
            return None
        bid = self.take_block()
        arrays = self.host.pop(h)
        if arrays is None:
            self._free_blocks.append(bid)
            return None
        self.write_device_block(bid, arrays)
        self.refcount[bid] = 1
        self._hash_to_block[h] = bid
        self._block_hash[bid] = h
        self._link(h, parent)
        self.blocks_restored += 1
        return bid

    # ------------------------------------------------------------------ #
    # sibling fetch (serve/kv_store.py::sibling_fetch)
    # ------------------------------------------------------------------ #

    def read_block_bytes(self, h) -> list[np.ndarray] | None:
        """``h``'s bytes from whichever tier holds them (device registry
        first), None when unresolvable: the sibling fetch's source read.
        Changes no recency and no refcount."""
        bid = self._hash_to_block.get(h)
        if bid is not None:
            return self.read_device_block(bid)
        if self.host is not None and self.host.has(h):
            return self.host._entries[h].arrays
        return None

    def adopt_host_block(self, h, parent, arrays) -> bool:
        """Store a sibling pool's block bytes into this pool's host tier
        under the shared chained hash (the sibling fetch's target).
        Refused when the parent is unresolvable here.  ``h`` is linked
        before the store's LRU drops cascade, so a put that drops ``h``'s
        own parent takes ``h`` with it; the return value says whether
        ``h`` is resolvable after all."""
        if self.host is None:
            return False
        if self.resolvable(h):
            return True
        if parent is not None and not self.resolvable(parent):
            return False
        stored, dropped = self.host.put(h, arrays)
        if stored:
            self._link(h, parent)
        for d in dropped:
            self._hash_unresolvable(d)
        return stored and self.resolvable(h)

    # ------------------------------------------------------------------ #
    # views and handoff reservations
    # ------------------------------------------------------------------ #

    def attach_view(self, view) -> None:
        self._views.append(view)

    def begin_export(self, export: SlotExport) -> None:
        self.outstanding_handoff += export.outstanding
        self._exports[id(export)] = export

    def end_export(self, export: SlotExport, *, adopted: bool) -> None:
        self.outstanding_handoff -= export.outstanding
        del self._exports[id(export)]
        if not adopted:
            # Cancelled in flight: the blocks release and the worst-case
            # reservation dies with the request.
            self.outstanding_total -= export.outstanding
            for bid in export.table_row:
                if bid != self.num_blocks:
                    self.release_block(int(bid))

    # ------------------------------------------------------------------ #
    # accounting
    # ------------------------------------------------------------------ #

    @property
    def blocks_in_use(self) -> int:
        return int((self.refcount > 0).sum())

    @property
    def blocks_free(self) -> int:
        return len(self._free_blocks)

    @property
    def blocks_cached(self) -> int:
        """Registered refcount-0 blocks (evictable, serving future hits)."""
        return len(self._evictable)

    def stats(self) -> dict:
        out = {
            "blocks_in_use": self.blocks_in_use,
            "blocks_free": self.blocks_free,
            "blocks_cached": self.blocks_cached,
            "block_occupancy": (
                (self.blocks_in_use + self.blocks_cached) / self.num_blocks
            ),
            "blocks_evicted": self.blocks_evicted,
            "cow_copies": self.cow_copies,
        }
        if self.host is not None:
            out.update({
                "blocks_spilled": self.blocks_spilled,
                "blocks_restored": self.blocks_restored,
                "blocks_sibling_fetched": self.sibling_fetched_blocks,
                "chain_unregistered": self.chain_unregistered,
                "kv_block_bytes": self.block_bytes,
                **self.host.stats(),
            })
        elif self.chain_unregistered:
            out["chain_unregistered"] = self.chain_unregistered
        return out

    def check_invariants(self) -> None:
        """Conservation + refcount + chain audit (test hook) across every
        attached view and in-flight export: each block is exactly one of
        free / referenced / evictable, refcounts equal table references,
        and every resolvable hash's parent is resolvable."""
        refs = np.zeros((self.num_blocks,), np.int64)
        rows = [view.block_tables for view in self._views]
        rows += [e.table_row for e in self._exports.values()]
        for tables in rows:
            live = tables[tables != self.num_blocks]
            np.add.at(refs, live, 1)
        if not np.array_equal(refs, self.refcount):
            raise AssertionError(
                f"refcount drift: tables say {refs.tolist()}, "
                f"pool says {self.refcount.tolist()}"
            )
        free = set(self._free_blocks)
        evict = set(self._evictable)
        used = {b for b in range(self.num_blocks) if self.refcount[b] > 0}
        if free & evict or free & used or evict & used:
            raise AssertionError("block state overlap")
        if len(free) + len(evict) + len(used) != self.num_blocks:
            raise AssertionError(
                f"block conservation broken: {len(free)} free + "
                f"{len(evict)} evictable + {len(used)} used != "
                f"{self.num_blocks}"
            )
        for h, bid in self._hash_to_block.items():
            if self._block_hash.get(bid) != h:
                raise AssertionError("hash map / reverse map drift")
        view_out = sum(int(v._outstanding.sum()) for v in self._views)
        if view_out + self.outstanding_handoff != self.outstanding_total:
            raise AssertionError(
                f"outstanding drift: views {view_out} + handoff "
                f"{self.outstanding_handoff} != total "
                f"{self.outstanding_total}"
            )
        hashes = set(self._hash_to_block)
        if self.host is not None:
            self.host.check_accounting()
            host_hashes = set(self.host._entries)
            if hashes & host_hashes:
                raise AssertionError(
                    "hash resolvable in both tiers — device registration "
                    "must supersede the host copy"
                )
            hashes |= host_hashes
        for h in hashes:
            parent = self._hash_parent.get(h)
            if parent is not None and not self.resolvable(parent):
                raise AssertionError(
                    f"chain invariant broken: hash {h} resolvable but its "
                    "parent is not"
                )

    def reset(self) -> None:
        self.refcount[:] = 0
        self._hash_to_block.clear()
        self._block_hash.clear()
        self._evictable.clear()
        self._hash_parent.clear()
        self._hash_children.clear()
        self._free_blocks = list(range(self.num_blocks - 1, -1, -1))
        self.outstanding_total = 0
        self.outstanding_handoff = 0
        self._exports.clear()
        self.blocks_evicted = 0
        self.cow_copies = 0
        self.blocks_spilled = 0
        self.blocks_restored = 0
        self.chain_unregistered = 0
        self.sibling_fetched_blocks = 0
        if self.host is not None:
            self.host.reset()


class PagedKVCachePool:
    """Slot view over a :class:`BlockPool`: per-slot block tables and
    prefix caching.

    Constructed alone (``blocks=None``) the view owns a private
    BlockPool.  Over a shared one (the disaggregated tier) it brings only
    its slot bookkeeping; ``num_blocks``/``block_size`` given must match
    the pool's, the host tier belongs to the pool, and ``kv_quant`` must
    name the pool's storage.

    ``max_len`` bounds the logical length of one request (the model's
    position table is the hard ceiling); the memory bound is the global
    ``num_blocks * block_size``.  ``blocks_per_slot``, the table width, is
    ``ceil(max_len / block_size)``.  A table entry equal to
    ``num_blocks`` is the unallocated sentinel.

    Admission is deadlock-free by reservation: ``allocate`` records each
    slot's worst-case outstanding block need on the BlockPool, and
    ``admissible_for`` refuses requests whose fresh-block need exceeds
    ``free + evictable`` minus the total outstanding, so every live
    request can always finish.
    """

    def __init__(self, model, *, num_slots: int,
                 num_blocks: int | None = None,
                 block_size: int | None = None, max_len: int | None = None,
                 prefix_cache: bool = True, kv_quant: str | None = None,
                 host_store=None, blocks: BlockPool | None = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        cap = max_len if max_len is not None else model.cfg.max_seq_len
        if cap < 1 or cap > model.cfg.max_seq_len:
            raise ValueError(
                f"max_len {cap} outside 1..{model.cfg.max_seq_len} "
                "(the model's position table bounds logical length)"
            )
        if blocks is None:
            if num_blocks is None or block_size is None:
                raise ValueError(
                    "a view owning its BlockPool needs num_blocks and "
                    "block_size"
                )
            blocks = BlockPool(
                model, num_blocks=num_blocks, block_size=block_size,
                kv_quant=kv_quant, host_store=host_store,
            )
            self._owns_blocks = True
        else:
            if host_store is not None:
                raise ValueError(
                    "host_store belongs to the shared BlockPool — "
                    "construct it there"
                )
            for name, given in (
                ("num_blocks", num_blocks), ("block_size", block_size),
            ):
                if given is not None and given != getattr(blocks, name):
                    raise ValueError(
                        f"{name} {given} != shared BlockPool's "
                        f"{getattr(blocks, name)}"
                    )
            pool_quant = _storage_quant(blocks.cache)
            if pool_quant != kv_quant:
                raise ValueError(
                    f"kv_dtype {kv_quant or 'bf16'!r} disagrees with the "
                    f"shared BlockPool's storage layout "
                    f"({pool_quant or 'bf16'}) — construct the pool and "
                    "every view with one kv_dtype"
                )
            self._owns_blocks = False
        self.blocks = blocks
        blocks.attach_view(self)
        self.num_slots = num_slots
        self.max_len = cap
        self.blocks_per_slot = -(-cap // blocks.block_size)
        self.prefix_cache_enabled = prefix_cache
        self.lengths = np.zeros((num_slots,), np.int32)
        self.active = np.zeros((num_slots,), bool)
        self._free_slots = list(range(num_slots - 1, -1, -1))
        self.block_tables = np.full(
            (num_slots, self.blocks_per_slot), blocks.num_blocks, np.int32
        )
        # Per slot: worst-case blocks still to allocate, and the full
        # prompt blocks awaiting registration once fully written.
        self._outstanding = np.zeros((num_slots,), np.int64)
        self._pending_reg: list[list] = [[] for _ in range(num_slots)]
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0

    @property
    def cache(self):
        return self.blocks.cache

    @property
    def num_blocks(self) -> int:
        return self.blocks.num_blocks

    @property
    def block_size(self) -> int:
        return self.blocks.block_size

    @property
    def sentinel(self) -> int:
        """Idle-slot position sentinel (>= max_len; an idle slot's table
        row is all block sentinels, so any position writes to scratch)."""
        return self.max_len

    @property
    def mask_len(self) -> int:
        """Length of the gathered attention read window: the table span."""
        return self.blocks_per_slot * self.blocks.block_size

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    # ------------------------------------------------------------------ #
    # chain resolution
    # ------------------------------------------------------------------ #

    def _blocks_span(self, tokens: int) -> int:
        return -(-tokens // self.blocks.block_size)

    def _resolve_run(self, prompt: np.ndarray) -> tuple[list, list]:
        """(all full-block hashes, leading resolvable run) of a prompt;
        run entries are ``(k, h, bid | None)``, None for host-tier entries
        (restored at allocation)."""
        hashes = hash_prompt_blocks(prompt, self.blocks.block_size)
        run: list = []
        if self.prefix_cache_enabled:
            for k, h in enumerate(hashes):
                bid = self.blocks.device_block(h)
                if bid is not None:
                    run.append((k, h, bid))
                elif self.blocks.host_has(h):
                    run.append((k, h, None))
                else:
                    break
        return hashes, run

    def _admission_plan(self, prompt: np.ndarray,
                        max_new: int) -> tuple[bool, list, list]:
        """(admissible, hashes, run) from one hashing pass.  Device hits
        reduce the fresh-block need, host hits do not (a restore takes a
        device block too), and a device hit in the evictable set is not
        also counted as available."""
        hashes, run = self._resolve_run(prompt)
        cow = bool(run) and len(run) * self.blocks.block_size >= prompt.size
        span = self._blocks_span(int(prompt.size) + int(max_new) - 1)
        device_hits = [bid for _, _, bid in run if bid is not None]
        needed = span - len(device_hits) + (1 if cow else 0)
        evictable_hits = sum(
            1 for bid in device_hits if bid in self.blocks._evictable
        )
        avail = (
            len(self.blocks._free_blocks) + len(self.blocks._evictable)
            - evictable_hits - self.blocks.outstanding_total
        )
        return needed <= avail, hashes, run

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Whether a request could ever be admitted: within the position
        bound, and its zero-hit worst-case span within the whole pool."""
        if prompt_len + max_new > self.max_len:
            return False
        return (
            self._blocks_span(prompt_len + max_new - 1)
            <= self.blocks.num_blocks
        )

    def lookup(self, prompt: np.ndarray) -> int:
        """Cached tokens a prompt would hit across both tiers, without
        claiming; at least one prompt token is always recomputed (the
        logits source)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        _, run = self._resolve_run(prompt)
        return min(len(run) * self.blocks.block_size, int(prompt.size) - 1)

    def admissible_for(self, prompt: np.ndarray, max_new: int) -> bool:
        """Whether a request can be admitted now under the global block
        budget (a free slot, and its worst-case fresh-block need within
        the unreserved free + evictable blocks)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not self._free_slots or prompt.size + max_new > self.max_len:
            return False
        return self._admission_plan(prompt, max_new)[0]

    # ------------------------------------------------------------------ #
    # slot lifecycle
    # ------------------------------------------------------------------ #

    def allocate(self, prompt: np.ndarray, max_new: int) -> tuple[int, int]:
        """Claim a slot for ``prompt``: take prefix-cache hits (refcount++
        on device hits, host-tier entries restored into fresh blocks, the
        last block copied on write when the whole prompt is covered),
        reserve the worst-case fresh-block need, and return
        ``(slot, cached_tokens)``: the engine skips prefill for the first
        ``cached_tokens`` positions.  Raises RuntimeError when not
        ``admissible_for``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not self._free_slots or prompt.size + max_new > self.max_len:
            raise RuntimeError(
                "request not admissible (no free slot or over the "
                "position bound)"
            )
        ok, hashes, run = self._admission_plan(prompt, max_new)
        if not ok:
            raise RuntimeError(
                "request not admissible (insufficient blocks for the "
                "worst-case span)"
            )
        slot = self._free_slots.pop()
        self.active[slot] = True
        self.prefix_lookup_tokens += int(prompt.size)
        # Claim every device hit first: a claimed block cannot be evicted
        # by the restores below.
        for _, _, bid in run:
            if bid is not None:
                self.blocks.claim_registered(bid)
        # Restore host-tier entries in chain order; a restore's own spill
        # can drop a later entry of this chain, which truncates the run
        # there (device hits past the break are released again).
        hit_ids: list[int] = []
        broken = False
        for k, h, bid in run:
            if broken:
                if bid is not None:
                    self.blocks.release_block(bid)
                continue
            if bid is None:
                parent = hashes[k - 1] if k else None
                bid = self.blocks.restore_block(h, parent)
                if bid is None:
                    broken = True
                    continue
            hit_ids.append(bid)
        bs = self.blocks.block_size
        cow = bool(hit_ids) and len(hit_ids) * bs >= prompt.size
        cached = len(hit_ids) * bs
        self.block_tables[slot, :len(hit_ids)] = hit_ids
        if cow:
            # Whole prompt covered: copy the last shared block so the final
            # token (recomputed for its logits) writes a private copy.
            shared = hit_ids[-1]
            copy = self.blocks.take_block()
            self.blocks.copy_block(shared, copy)
            self.block_tables[slot, len(hit_ids) - 1] = copy
            self.blocks.refcount[copy] = 1
            self.blocks.release_block(shared)
            self.blocks.cow_copies += 1
            cached -= 1
        self.prefix_hit_tokens += cached
        self.lengths[slot] = cached
        span = self._blocks_span(prompt.size + max_new - 1)
        filled = int((self.block_tables[slot] != self.blocks.num_blocks).sum())
        self._outstanding[slot] = span - filled
        self.blocks.outstanding_total += span - filled
        # Full prompt blocks this slot computes itself: registered once
        # fully written (advance), each linked to its chain parent.
        self._pending_reg[slot] = [
            (k, h, hashes[k - 1] if k else None)
            for k, h in enumerate(hashes)
            if (k + 1) * bs > cached
        ]
        return slot, cached

    def ensure_length(self, slot: int, new_len: int) -> None:
        """Allocate table entries so positions ``0..new_len-1`` are
        writable: called by the engine before each forward for the
        positions it will write."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        if new_len > self.max_len:
            raise ValueError(
                f"slot {slot} overflow: {new_len} > {self.max_len}"
            )
        for k in range(self._blocks_span(new_len)):
            if self.block_tables[slot, k] == self.blocks.num_blocks:
                bid = self.blocks.take_block()
                self.block_tables[slot, k] = bid
                self.blocks.refcount[bid] = 1
                self._outstanding[slot] -= 1
                self.blocks.outstanding_total -= 1

    def advance(self, slot: int, n: int) -> None:
        """Record ``n`` tokens written; registers any prompt block whose
        K/V just became fully written (the prefix-cache publication)."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        old = int(self.lengths[slot])
        if old + n > self.max_len:
            raise ValueError(
                f"slot {slot} overflow: {old} + {n} > {self.max_len}"
            )
        self.lengths[slot] = old + n
        if not self.prefix_cache_enabled:
            return
        pend = self._pending_reg[slot]
        bs = self.blocks.block_size
        while pend and self.lengths[slot] >= (pend[0][0] + 1) * bs:
            k, h, parent = pend.pop(0)
            self.blocks.register(h, int(self.block_tables[slot, k]), parent)

    def rewind(self, slot: int, new_len: int | None = None) -> int:
        """Free the blocks past ``new_len`` (default: the slot's length)
        that only rejected speculative writes touched, restoring the
        slot's reservation; returns the number freed.  A shared or
        registered block there is a loud error: rollback must never touch
        a refcounted prefix."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        new_len = int(self.lengths[slot]) if new_len is None else int(new_len)
        if new_len < int(self.lengths[slot]):
            raise ValueError(
                f"slot {slot}: cannot rewind below the claimed length "
                f"({new_len} < {int(self.lengths[slot])})"
            )
        freed = 0
        for k in range(self._blocks_span(new_len), self.blocks_per_slot):
            bid = int(self.block_tables[slot, k])
            if bid == self.blocks.num_blocks:
                continue
            if self.blocks.refcount[bid] != 1 or bid in self.blocks._block_hash:
                raise AssertionError(
                    f"rewind would free shared/registered block {bid} "
                    f"(refcount {int(self.blocks.refcount[bid])})"
                )
            self.blocks.refcount[bid] = 0
            self.blocks._free_blocks.append(bid)
            self.block_tables[slot, k] = self.blocks.num_blocks
            self._outstanding[slot] += 1
            self.blocks.outstanding_total += 1
            freed += 1
        return freed

    def release(self, slot: int) -> None:
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        for bid in self.block_tables[slot]:
            if bid != self.blocks.num_blocks:
                self.blocks.release_block(int(bid))
        self.block_tables[slot] = self.blocks.num_blocks
        self.active[slot] = False
        self.lengths[slot] = 0
        self.blocks.outstanding_total -= int(self._outstanding[slot])
        self._outstanding[slot] = 0
        self._pending_reg[slot] = []
        self._free_slots.append(slot)

    # ------------------------------------------------------------------ #
    # prefill->decode handoff (serve/disagg.py): the block-table row is
    # the handle.  The export keeps every block claimed and parks the
    # reservation on the BlockPool while the slot frees; adoption puts
    # the row into another view over the same pool without moving a byte.
    # ------------------------------------------------------------------ #

    def export_slot(self, slot: int) -> SlotExport:
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        export = SlotExport(
            kind="paged", length=int(self.lengths[slot]),
            table_row=self.block_tables[slot].copy(),
            outstanding=int(self._outstanding[slot]),
            pending_reg=list(self._pending_reg[slot]),
            blocks=self.blocks,
        )
        self.blocks.begin_export(export)
        self.block_tables[slot] = self.blocks.num_blocks
        self.active[slot] = False
        self.lengths[slot] = 0
        self._outstanding[slot] = 0
        self._pending_reg[slot] = []
        self._free_slots.append(slot)
        return export

    def adopt_slot(self, export: SlotExport) -> int:
        if export.kind != "paged":
            raise ValueError(
                "paged pools adopt paged exports only (a contiguous "
                "handoff travels by row copy, not by block table)"
            )
        if export.blocks is not self.blocks:
            raise ValueError(
                "a paged handoff needs both views on one shared "
                "BlockPool — the block ids are meaningless elsewhere"
            )
        if export.table_row.shape != (self.blocks_per_slot,):
            raise ValueError(
                f"block-table width mismatch: export "
                f"{export.table_row.shape[0]} != view "
                f"{self.blocks_per_slot}"
            )
        if not self._free_slots:
            raise RuntimeError("no free slot to adopt into")
        slot = self._free_slots.pop()
        self.active[slot] = True
        self.block_tables[slot] = export.table_row
        self.lengths[slot] = export.length
        self._outstanding[slot] = export.outstanding
        self._pending_reg[slot] = list(export.pending_reg)
        self.blocks.end_export(export, adopted=True)
        return slot

    def release_export(self, export: SlotExport) -> None:
        """Drop an un-adopted export (handoff cancelled): its blocks
        release and its reservation dies."""
        self.blocks.end_export(export, adopted=False)

    def check_invariants(self) -> None:
        """Conservation + refcount + chain audit (test hook), across every
        view of the BlockPool."""
        self.blocks.check_invariants()

    def stats(self) -> dict:
        return {
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_lookup_tokens": self.prefix_lookup_tokens,
            **self.blocks.stats(),
        }

    def reset(self) -> None:
        """Drop all slots, the prefix cache and the counters (bookkeeping
        only; block bytes stay stale-but-masked, as on release).  A view
        over a shared BlockPool resets its own slots only: the tier
        resets the substrate once after every view."""
        for slot in range(self.num_slots):
            if self.active[slot]:
                self.release(slot)
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self._free_slots = list(range(self.num_slots - 1, -1, -1))
        if self._owns_blocks:
            self.blocks.reset()


def _storage_quant(cache) -> str | None:
    """The storage kind of a block pool's tensors: None (native) or
    "int8"/"int4", read from the payload dtype."""
    from ..models.layers import cache_quant

    return cache_quant(cache[0])
