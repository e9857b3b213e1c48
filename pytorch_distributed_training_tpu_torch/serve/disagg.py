"""Disaggregated prefill/decode serving: role pools with KV handoff, the
counterpart of the JAX package's ``serve/disagg.py``.

The interleaved engine runs one (S, C) prefill forward plus one decode
forward a tick over one slot array, so a burst of long prompts makes
every decode tick pay a full-width prefill.  This tier splits it into a
**prefill-role** :class:`~.engine.ServingEngine` (few slots: it admits
raw prompts, samples each request's first token and parks the request
for handoff) and a **decode-role** engine (its slots hold decoding
requests only, so its tick pays a (P, C) prefill, not (S, C)).

**KV handoff.**  Paged: both engines are views over one shared
:class:`~.kv_pool.BlockPool` and the handoff moves the block-table row
(``SlotExport``) without touching a byte.  Contiguous: the engines have
separate caches and adoption copies the slot's K/V rows on the device.
Either way the decode side's greedy output equals the interleaved
engine's token for token.

:class:`DisaggServingEngine` has the engine's public surface (start,
step, cancel, stats, reset, ...) so the scheduler and the replica router
drive it as one engine.  The role deaths, re-splits and dropped handoffs
of the failover and autoscale controllers are ``ROADMAP.md`` Queue 1
item 12: their methods raise ``NotImplementedError`` here, and the state
they read (``handoffs_dropped``, the role split) is kept.
"""

from __future__ import annotations

import time
from collections import deque

from .engine import Event, Handoff, ServingEngine
from .kv_pool import BlockPool
from .kv_store import HostKVStore

_ITEM_12 = ("role deaths, re-splits and dropped handoffs belong to the "
            "failover and autoscale controllers, ROADMAP.md Queue 1 item 12 "
            "(not ported yet)")


class _TierPool:
    """The scheduler- and router-facing pool view of the tier: occupancy
    sums both role pools; prefix lookups answer from the prefill view
    (both views see the one hash chain)."""

    def __init__(self, tier: "DisaggServingEngine"):
        self._tier = tier

    @property
    def num_active(self) -> int:
        return (self._tier.prefill_engine.pool.num_active
                + self._tier.decode_engine.pool.num_active)

    @property
    def prefix_cache_enabled(self) -> bool:
        pool = self._tier.prefill_engine.pool
        return bool(getattr(pool, "prefix_cache_enabled", False))

    def lookup(self, prompt) -> int:
        return self._tier.prefill_engine.pool.lookup(prompt)

    @property
    def blocks(self):
        return self._tier.blocks


class DisaggServingEngine:
    """Prefill-role and decode-role engines behind one engine surface.

    ``prefill_slots`` sizes the prefill pool, ``decode_slots`` the decode
    pool.  ``model`` (a ``models.gpt2.GPT2``) serves both roles from one
    set of weights on ``device``.  Paged, the shared block pool defaults
    to one interleaved engine's budget over all the slots, and
    ``kv_host_mb`` puts the host-RAM tier under it."""

    def __init__(
        self,
        model,
        *,
        prefill_slots: int = 2,
        decode_slots: int = 4,
        max_len: int | None = None,
        prefill_chunk: int = 16,
        temperature: float = 0.0,
        top_k: int | None = None,
        eos_token_id: int | None = None,
        seed: int = 0,
        stream_cb=None,
        paged: bool = True,
        block_size: int = 16,
        num_blocks: int | None = None,
        prefix_cache: bool = True,
        kv_host_mb: float | None = None,
        spec_k: int = 0,
        spec_ngram: int = 4,
        kv_dtype: str = "bf16",
        device=None,
    ):
        if prefill_slots < 1 or decode_slots < 1:
            raise ValueError(
                "prefill_slots and decode_slots must both be >= 1"
            )
        if kv_host_mb is not None and not paged:
            raise ValueError(
                "the host KV tier spills paged blocks — pass paged=True"
            )
        if kv_dtype != "bf16" and not paged:
            raise ValueError(
                "quantized KV storage lives in the paged block pool — "
                "pass paged=True with kv_dtype int8/int4"
            )
        self.paged = paged
        self.blocks: BlockPool | None = None
        common = dict(
            max_len=max_len, temperature=temperature, top_k=top_k,
            eos_token_id=eos_token_id, seed=seed, stream_cb=stream_cb,
            kv_dtype=kv_dtype, device=device,
        )
        if paged:
            cap = max_len or model.cfg.max_seq_len
            from ..utils.device import resolve_device

            # The substrate's blocks live where the engines run.
            model = model.to(resolve_device(device))
            self.blocks = BlockPool(
                model,
                num_blocks=num_blocks or (
                    (prefill_slots + decode_slots) * (-(-cap // block_size))
                ),
                block_size=block_size,
                kv_quant=None if kv_dtype == "bf16" else kv_dtype,
                host_store=(HostKVStore(int(kv_host_mb * 2**20))
                            if kv_host_mb is not None else None),
            )
            common.update(paged=True, block_pool=self.blocks,
                          prefix_cache=prefix_cache)
        self.prefill_engine = ServingEngine(
            model, num_slots=prefill_slots, role="prefill",
            prefill_chunk=prefill_chunk, **common,
        )
        self.decode_engine = ServingEngine(
            model, num_slots=decode_slots, role="decode",
            prefill_chunk=prefill_chunk, spec_k=spec_k,
            spec_ngram=spec_ngram, **common,
        )
        self.prefill_slots = prefill_slots
        self.decode_slots = decode_slots
        self.max_len = self.decode_engine.max_len
        self.num_slots = prefill_slots + decode_slots
        self._handoffs: deque[Handoff] = deque()
        self.handoffs = 0  # completed adoptions
        self.handoffs_dropped = 0  # item 12's lost handoffs; stays 0 here
        self.handoff_s = 0.0  # host seconds moving handoffs (not in stats)
        self.pool = _TierPool(self)

    # ------------------------------------------------------------------ #
    # engine surface (ContinuousScheduler / ReplicaRouter)
    # ------------------------------------------------------------------ #

    @property
    def drafter(self):
        """The decode side owns speculation (the router's shared index
        reads this)."""
        return self.decode_engine.drafter

    @property
    def stream_cb(self):
        return self.prefill_engine.stream_cb

    @stream_cb.setter
    def stream_cb(self, cb) -> None:
        self.prefill_engine.stream_cb = cb
        self.decode_engine.stream_cb = cb

    @property
    def spans(self):
        return self.prefill_engine.spans

    @spans.setter
    def spans(self, value) -> None:
        self.prefill_engine.spans = value
        self.decode_engine.spans = value

    @property
    def spans_replica(self):
        return self.prefill_engine.spans_replica

    @spans_replica.setter
    def spans_replica(self, value) -> None:
        self.prefill_engine.spans_replica = value
        self.decode_engine.spans_replica = value

    @property
    def has_free_slot(self) -> bool:
        return self.prefill_engine.has_free_slot

    @property
    def busy(self) -> bool:
        return (self.prefill_engine.busy or self.decode_engine.busy
                or bool(self._handoffs))

    def validate_request(self, prompt_len: int, max_new: int) -> None:
        self.prefill_engine.validate_request(prompt_len, max_new)

    def can_admit(self, prompt, max_new: int) -> bool:
        """Admission is by the prefill pool: a free prefill slot and
        (paged) the shared block budget, which counts every decode-side
        and in-flight reservation, so an admitted request can always run
        to completion on the decode side."""
        return self.prefill_engine.can_admit(prompt, max_new)

    def start(self, request_id, prompt, max_new: int) -> int:
        return self.prefill_engine.start(request_id, prompt, max_new)

    def live_requests(self) -> list:
        return (self.prefill_engine.live_requests()
                + [h.request_id for h in self._handoffs]
                + self.decode_engine.live_requests())

    def cancel(self, request_id) -> Event:
        """Retire an in-flight request wherever it lives: prefilling,
        parked in the handoff queue (paged exports only park), or
        decoding."""
        for h in list(self._handoffs):
            if h.request_id == request_id:
                self._handoffs.remove(h)
                self.decode_engine.pool.release_export(h.export)
                return Event("finish", request_id, reason="cancelled")
        try:
            return self.prefill_engine.cancel(request_id)
        except KeyError:
            return self.decode_engine.cancel(request_id)

    def _move_handoffs(self) -> None:
        """Move finished prefills toward the decode pool.  Paged exports
        detach at once (the freed prefill slot takes the next prompt; the
        blocks ride the export's refcounts); contiguous ones detach only
        when a decode slot can take the row copy."""
        pre, dec = self.prefill_engine, self.decode_engine
        if self.paged:
            for slot in pre.handoff_ready():
                self._handoffs.append(pre.export_handoff(slot))
        while self._handoffs and dec.can_adopt():
            dec.adopt(self._handoffs.popleft())
            self.handoffs += 1
        if not self.paged:
            while dec.can_adopt() and pre.handoff_ready():
                dec.adopt(pre.export_handoff(pre.handoff_ready()[0]))
                self.handoffs += 1

    def step(self) -> list[Event]:
        """One tier tick: a prefill chunk on the prefill pool, the
        handoffs, then a decode/verify batch on the decode pool (a request
        handed off this tick decodes this tick)."""
        events = self.prefill_engine.step()
        t0 = time.perf_counter()
        self._move_handoffs()
        self.handoff_s += time.perf_counter() - t0
        return events + self.decode_engine.step()

    # ------------------------------------------------------------------ #
    # item 12 (failover, autoscale): not ported
    # ------------------------------------------------------------------ #

    def fail_role(self, role: str) -> list:
        raise NotImplementedError(_ITEM_12)

    def revive_role(self, role: str) -> None:
        raise NotImplementedError(_ITEM_12)

    def resplit(self, prefill_cap: int, decode_cap: int) -> None:
        raise NotImplementedError(_ITEM_12)

    @property
    def dead_roles(self) -> tuple:
        raise NotImplementedError(_ITEM_12)

    def drop_handoff(self):
        raise NotImplementedError(_ITEM_12)

    @property
    def role_split(self) -> tuple[int, int]:
        """The effective (prefill, decode) admission widths."""
        return (self.prefill_engine.effective_slots,
                self.decode_engine.effective_slots)

    # ------------------------------------------------------------------ #
    # accounting
    # ------------------------------------------------------------------ #

    def stats(self) -> dict:
        """Role-attributed occupancy, each role's half of the counters,
        the shared block and host-tier stats once, and the handoffs."""
        pre, dec = self.prefill_engine, self.decode_engine
        out = {
            "slots_active": self.pool.num_active,
            "prefill_slots_active": pre.pool.num_active,
            "decode_slots_active": dec.pool.num_active,
            "prefill_slot_cap": pre.effective_slots,
            "decode_slot_cap": dec.effective_slots,
            "handoffs_queued": len(self._handoffs),
            "handoffs": self.handoffs,
            "handoffs_dropped": self.handoffs_dropped,
            "prefill_tokens_computed": pre.prefill_tokens_computed,
            "prefill_tokens_offered": pre.prefill_tokens_offered,
            "decode_ticks": dec.decode_ticks,
            "decode_slot_ticks": dec.decode_slot_ticks,
            "decode_tokens": dec.decode_tokens,
        }
        if dec.spec_k > 0:
            out["spec_drafted_tokens"] = dec.spec_drafted_tokens
            out["spec_accepted_tokens"] = dec.spec_accepted_tokens
        if self.paged:
            out["prefix_hit_tokens"] = (pre.pool.prefix_hit_tokens
                                        + dec.pool.prefix_hit_tokens)
            out["prefix_lookup_tokens"] = (pre.pool.prefix_lookup_tokens
                                           + dec.pool.prefix_lookup_tokens)
            out.update(self.blocks.stats())
        return out

    def check_invariants(self) -> None:
        if self.blocks is not None:
            self.blocks.check_invariants()

    def reset(self) -> None:
        """Drop every in-flight request on both roles, the handoff queue
        and (paged) the shared substrate: ``ServingEngine.reset``'s
        contract for the tier."""
        for h in self._handoffs:
            self.decode_engine.pool.release_export(h.export)
        self._handoffs.clear()
        self.prefill_engine.reset()
        self.decode_engine.reset()
        if self.blocks is not None:
            self.blocks.reset()
        self.handoffs = 0
        self.handoffs_dropped = 0
        self.handoff_s = 0.0

    def memory_model(self, program: str) -> dict[str, int]:
        """Per-step byte model, from the role engine that runs it."""
        if program == "prefill":
            return self.prefill_engine.memory_model(program)
        return self.decode_engine.memory_model(program)
