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
drive it as one engine.  The failover and autoscale controllers
(``serve/failover.py``, ``serve/autoscale.py``) act on it through the
role methods: ``fail_role`` / ``revive_role`` (a role pool dies and
comes back; its slots, parked handoffs and their block reservations go
back to the shared pool at death), ``resplit`` (admission caps below the
built widths, nothing reallocated) and ``drop_handoff`` (the chaos
plane's lost message, its export released).
"""

from __future__ import annotations

import time
from collections import deque

from .engine import Event, Handoff, ServingEngine
from .kv_pool import BlockPool
from .kv_store import HostKVStore


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
    ``kv_host_mb`` puts the host-RAM tier under it.  ``cuda_graphs`` goes
    to both role engines (``ServingEngine``)."""

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
        cuda_graphs: bool = True,
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
            kv_dtype=kv_dtype, device=device, cuda_graphs=cuda_graphs,
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
        self.handoffs_dropped = 0  # the chaos plane's lost handoffs
        self.handoff_s = 0.0  # host seconds moving handoffs (not in stats)
        # Dead role pools (serve/failover.py): a dead role neither steps
        # nor admits nor adopts until revive_role.
        self._dead_roles: set[str] = set()
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
    def program_signatures(self) -> dict[str, str]:
        """Each program's abstract signature across both roles (the role
        program sets are disjoint: prefill | decode + verify)."""
        return {
            **self.prefill_engine.program_signatures,
            **self.decode_engine.program_signatures,
        }

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
        to completion on the decode side.  With either role dead the tier
        admits nothing."""
        if self._dead_roles:
            return False
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
        handed off this tick decodes this tick).  A dead role's half does
        not run; its sibling keeps going (a dead prefill pool's parked
        handoffs still adopt off the shared pool)."""
        events: list[Event] = []
        if "prefill" not in self._dead_roles:
            events += self.prefill_engine.step()
        if "decode" not in self._dead_roles:
            t0 = time.perf_counter()
            self._move_handoffs()
            self.handoff_s += time.perf_counter() - t0
            events += self.decode_engine.step()
        return events

    # ------------------------------------------------------------------ #
    # role death, re-split and lost handoffs (serve/failover.py,
    # serve/autoscale.py, the chaos plane)
    # ------------------------------------------------------------------ #

    def fail_role(self, role: str) -> list:
        """Kill one role pool: release its slots (and, with the decode
        role, the parked handoffs' exports: their refcounts and block
        reservations go back to the shared pool) and return the stranded
        request ids for the failover controller to requeue.  A prefill
        death strands the mid-prefill slots only; a decode death strands
        its live decodes, the parked handoffs and the prefilling requests
        that could only ever land on it."""
        if role not in ("prefill", "decode"):
            raise ValueError(
                f"role must be 'prefill' or 'decode', got {role!r}"
            )
        if role in self._dead_roles:
            return []
        self._dead_roles.add(role)
        stranded: list = []
        if role == "decode":
            for rid in list(self.decode_engine.live_requests()):
                stranded.append(rid)
                self.decode_engine.cancel(rid)
            for h in self._handoffs:
                stranded.append(h.request_id)
                self.decode_engine.pool.release_export(h.export)
            self._handoffs.clear()
        for rid in list(self.prefill_engine.live_requests()):
            stranded.append(rid)
            self.prefill_engine.cancel(rid)
        return stranded

    def revive_role(self, role: str) -> None:
        """Bring a dead role pool back: its slots were released at death
        and its memory never went away, so it just takes work again."""
        self._dead_roles.discard(role)

    def resplit(self, prefill_cap: int, decode_cap: int) -> None:
        """Re-bias the P:D split: cap each role's admission width below
        its built width (nothing is reallocated).  Slots over a new cap
        drain naturally and are not refilled, so in-flight work is
        untouched and greedy output stays token-exact."""
        if not 1 <= prefill_cap <= self.prefill_slots:
            raise ValueError(
                f"prefill_cap must be in [1, {self.prefill_slots}], "
                f"got {prefill_cap} (a 0-width role is fail_role's job)"
            )
        if not 1 <= decode_cap <= self.decode_slots:
            raise ValueError(
                f"decode_cap must be in [1, {self.decode_slots}], "
                f"got {decode_cap} (a 0-width role is fail_role's job)"
            )
        self.prefill_engine.slot_cap = (
            None if prefill_cap == self.prefill_slots else int(prefill_cap))
        self.decode_engine.slot_cap = (
            None if decode_cap == self.decode_slots else int(decode_cap))

    @property
    def dead_roles(self) -> tuple:
        return tuple(sorted(self._dead_roles))

    def drop_handoff(self):
        """Chaos hook (``handoff_drop@T``): lose one parked handoff.  Its
        export is released (the blocks' reservation dies with the
        message) and the scheduler is not told: the orphan the failover
        sweep must notice.  Returns the dropped request id, or None when
        nothing is parked."""
        if not self._handoffs:
            return None
        h = self._handoffs.popleft()
        self.decode_engine.pool.release_export(h.export)
        self.handoffs_dropped += 1
        return h.request_id

    def shrink_host_tier(self) -> int | None:
        """Empty the shared host KV tier and size it to zero (the
        autoscale ladder's first rung); returns the capacity it had, None
        without a tier."""
        return self.prefill_engine.shrink_host_tier()

    def restore_host_tier(self, capacity_bytes: int) -> None:
        self.prefill_engine.restore_host_tier(capacity_bytes)

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
        self._dead_roles.clear()

    def memory_model(self, program: str) -> dict[str, int]:
        """Per-step byte model, from the role engine that runs it."""
        if program == "prefill":
            return self.prefill_engine.memory_model(program)
        return self.decode_engine.memory_model(program)
