"""Contiguous KV-cache slot pool: the counterpart of the JAX package's
``serve/kv_pool.py::KVCachePool``.

One decode cache per layer, (num_slots, H, max_len + 1, Dh) on the device
(``models/layers.py::new_kv_cache``; the extra position is the scratch
row for dropped writes), slot = batch row.  The correctness contract with
slot-mode attention:

- a slot's valid cache content is exactly positions ``0..lengths[s]-1``;
  everything past that is stale bytes from earlier tenants,
- every attention read is masked to the querying row's own prefix, so
  stale bytes are never read before they are overwritten,
- an idle slot's write position is the ``sentinel`` (= ``max_len``), whose
  writes land in the scratch row: idle rows change no live position.

Slot state lives in host mirrors (lengths, active flags, free list), so
the engine never reads the device to schedule.  The paged pool and the
row handoff of the disaggregated tier are not ported yet.
"""

from __future__ import annotations

import numpy as np


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

    def reset(self) -> None:
        """Drop all slots (bookkeeping only; cache bytes stay stale)."""
        self.active[:] = False
        self.lengths[:] = 0
        self._free = list(range(self.num_slots - 1, -1, -1))
