"""Continuous-batching decode engine: the counterpart of the JAX package's
``serve/engine.py``, over the contiguous slot pool or, with
``paged=True``, the paged block pool with prefix caching, an optional
host-RAM tier and int8/int4 KV.

``role`` splits the engine for the disaggregated tier
(``serve/disagg.py``): a "prefill" engine runs only the prefill step and
parks each finished prompt for handoff (``export_handoff``), building no
drafter; a "decode" engine runs only decode/verify and admits only by
``adopt``; "both" is the interleaved engine.  ``block_pool`` puts a
paged engine's view over a shared ``BlockPool``.  A model whose
attention holds a tensor shard of the heads (``parallel/sharded.py::
shard_for_serving``) serves tensor-parallel: the caches hold the rank's
local heads and the same kernels run on them; ``serve/tp.py`` keeps the
ranks' engines in lockstep.

Three steps cover the serving loop, each one forward over the whole slot
array so shapes never change:

- **prefill**: an (S, C) chunk of prompt tokens per tick (chunked prefill:
  long prompts take several ticks, interleaved with decode), sampling each
  finished prompt's first token at its last valid column;
- **decode**: one token per live slot at the slot's own position;
- **verify** (``spec_k > 0``): the pending token plus up to k tokens from
  the prompt-lookup drafter (serve/draft.py), scored in one forward with
  greedy chain matching (or rejection-style acceptance when sampling).
  Greedy output is token-exact vs plain decode; a tick where no slot
  drafted runs the plain decode step instead.

The JAX package compiles these as three AOT programs that donate the
cache; here they are eager methods that write the cache tensors in place,
which is the same contract: one cache, never copied per tick.  Idle rows
ride along at the sentinel position (their writes land in the cache's
scratch row or block, their outputs are discarded), so admission and
retirement are host bookkeeping only.  The paged pool's block table goes
to the device once per tick, after the host has allocated the blocks the
tick writes and before the forward.

Each step runs inside ``obs.trace.phase_span`` (``serve/prefill``,
``serve/decode``, ``serve/verify``): a profiler range and, when the
scheduler wired a ``SpanRecorder`` (``--trace``), a tick span carrying
its slots and request ids (``spans_replica`` too under a replica id).
The step's tokens are read back inside it, so it closes on finished
device work.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..comm.compress import KV_DTYPES
from ..models.generate import eos_cut_length, filter_logits, sample_logits
from ..obs.trace import phase_span
from ..utils.device import resolve_device
from .draft import NgramIndex, PromptLookupDrafter
from .kv_pool import KVCachePool, PagedKVCachePool, SlotExport
from .kv_store import HostKVStore

ROLES = ("both", "prefill", "decode")


@dataclasses.dataclass(frozen=True)
class Event:
    """One observable step outcome: a streamed token or a finished request."""

    kind: str  # "token" | "finish"
    request_id: Any
    token: int | None = None
    reason: str | None = None  # finish only: "eos" | "length" | "cancelled"


@dataclasses.dataclass
class _Slot:
    request_id: Any
    prompt: np.ndarray
    max_new: int
    consumed: int = 0  # prompt tokens whose K/V are cached
    phase: str = "prefill"  # "prefill" | "decode"
    pending: int | None = None  # sampled token not yet fed back
    generated: list = dataclasses.field(default_factory=list)
    # Zero-accept drafting backoff: consecutive fully-rejected drafts
    # double the ticks this slot sits out before drafting again.
    spec_fail: int = 0
    spec_skip: int = 0

    def history(self) -> np.ndarray:
        """Prompt + generated tokens (the last one is the pending token):
        the drafter's lookup corpus."""
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)]
        ) if self.generated else self.prompt


@dataclasses.dataclass
class Handoff:
    """One request in flight from a prefill-role engine to a decode-role
    engine (``serve/disagg.py``): the host request state plus the KV
    handle (``SlotExport``).  The decode engine adopts it without
    recomputing a prompt position."""

    request_id: Any
    prompt: np.ndarray
    max_new: int
    generated: list
    pending: int
    export: SlotExport


def tp_size(model) -> int:
    """The tensor-parallel size ``model``'s attention is sharded over (1
    when its weights are whole)."""
    attn = model.blocks[0].attn
    par = getattr(attn, "parallel", None)
    if par is None or attn.qkv.weight.shape[0] == 3 * model.cfg.hidden_dim:
        return 1
    return par.tp_size


class ServingEngine:
    """``model``: a ``models.gpt2.GPT2``, moved to ``device`` (CUDA unless
    ``device="cpu"``).  Sampling draws from a ``torch.Generator`` seeded
    with ``seed``.

    ``paged=True`` swaps the contiguous per-slot cache for the block pool
    (``PagedKVCachePool``): admission is bounded by the global pool, and
    shared prompt prefixes skip their prefill chunks through the pool's
    hash-addressed block cache.  ``num_blocks`` defaults to the contiguous
    pool's byte equivalent (``num_slots * ceil(max_len / block_size)``);
    ``kv_dtype`` "int8"/"int4" quantizes the blocks, and ``kv_host_mb``
    adds a host-RAM tier that evicted prefix blocks spill to."""

    # After F consecutive fully-rejected drafts a slot sits out 2**F ticks
    # (F capped here) before drafting again.
    SPEC_BACKOFF_CAP = 6

    def __init__(
        self,
        model,
        *,
        num_slots: int,
        max_len: int | None = None,
        prefill_chunk: int = 16,
        temperature: float = 0.0,
        top_k: int | None = None,
        eos_token_id: int | None = None,
        seed: int = 0,
        stream_cb: Callable[[Any, int], None] | None = None,
        spec_k: int = 0,
        spec_ngram: int = 4,
        device=None,
        paged: bool = False,
        block_size: int = 16,
        num_blocks: int | None = None,
        prefix_cache: bool = True,
        kv_dtype: str = "bf16",
        kv_host_mb: float | None = None,
        role: str = "both",
        block_pool=None,
    ):
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}"
            )
        if kv_dtype != "bf16" and not paged:
            raise ValueError(
                "quantized KV storage lives in the paged block pool — "
                "pass paged=True with kv_dtype int8/int4"
            )
        if role not in ROLES:
            raise ValueError(
                f"role must be 'both', 'prefill' or 'decode', got {role!r}"
            )
        if block_pool is not None and not paged:
            raise ValueError(
                "block_pool sharing is the paged layout's handoff "
                "substrate — pass paged=True"
            )
        if kv_host_mb is not None and not paged:
            raise ValueError(
                "the host KV tier spills paged blocks — pass paged=True"
            )
        if kv_host_mb is not None and block_pool is not None:
            raise ValueError(
                "on a shared BlockPool the host tier belongs to the pool "
                "— construct it there (BlockPool(host_store=...)), not on "
                "one of its views"
            )
        self.role = role
        self.kv_dtype = kv_dtype
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.eos_token_id = eos_token_id
        self.prefill_chunk = prefill_chunk
        self.stream_cb = stream_cb
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        # A prefill-role engine never decodes: no drafter (spec_k inert).
        self.drafter = PromptLookupDrafter(
            max_ngram=spec_ngram,
            min_ngram=min(max(2, spec_ngram - 1), spec_ngram),
            index=NgramIndex(spec_ngram),
        ) if spec_k > 0 and role != "prefill" else None
        cap = max_len or model.cfg.max_seq_len
        self.paged = paged
        if paged:
            shared = block_pool is not None
            self.pool = PagedKVCachePool(
                self.model, num_slots=num_slots,
                num_blocks=None if shared else (
                    num_blocks or num_slots * (-(-cap // block_size))),
                block_size=None if shared else block_size, max_len=cap,
                prefix_cache=prefix_cache,
                kv_quant=None if kv_dtype == "bf16" else kv_dtype,
                host_store=(
                    None if kv_host_mb is None
                    else HostKVStore(int(kv_host_mb * 2**20))
                ),
                blocks=block_pool,
            )
        else:
            self.pool = KVCachePool(
                self.model, num_slots=num_slots, max_len=cap,
            )
        self.max_len = self.pool.max_len
        self.num_slots = num_slots
        self.tp = tp_size(self.model)
        # Host-side admission cap (set by a re-split of the tier): below
        # num_slots, admission and adoption stop at it while the steps
        # keep their width.  None = uncapped.
        self.slot_cap: int | None = None
        self._slots: list[_Slot | None] = [None] * num_slots
        self._seed = seed
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._sample_kw = dict(temperature=temperature, top_k=top_k)
        self._mask_cols = torch.arange(self.pool.mask_len, device=self.device)
        self.prefill_tokens_computed = 0
        self.prefill_tokens_offered = 0
        self.prefill_ticks = 0  # forwards of prefill_step (not in stats)
        self.decode_ticks = 0
        self.decode_slot_ticks = 0  # one per live decoding slot per tick
        self.decode_tokens = 0
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        # Wired by the scheduler (module docstring); None records nothing.
        self.spans = None
        self.spans_replica = None

    # ------------------------------------------------------------------ #
    # device steps
    # ------------------------------------------------------------------ #

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _forward(self, tokens: np.ndarray, positions: np.ndarray):
        """Final hidden states (S, width, D) for one tick; the cache is
        written in place.  The slot-mode validity mask is built once here
        for every layer.  The paged block table is copied to the device
        here, synchronously: the host rewrites it on the next tick."""
        pos = self._dev(positions)
        cols = pos[:, None].long() + torch.arange(
            tokens.shape[1], device=self.device
        )
        mask = self._mask_cols[None, None, :] <= cols[:, :, None]
        table = (
            torch.tensor(self.pool.block_tables, device=self.device)
            if self.paged else None
        )
        return self.model(
            self._dev(tokens.astype(np.int64)), cache=self.pool.cache,
            positions=pos, attn_mask=mask, block_table=table,
            return_hidden=True,
        )

    @torch.no_grad()
    def _prefill(self, tokens, positions, last_idx) -> np.ndarray:
        hidden = self._forward(tokens, positions)
        rows = torch.arange(self.num_slots, device=self.device)
        last = self.model.head(hidden[rows, self._dev(last_idx)])
        return sample_logits(last, self._generator, **self._sample_kw).cpu().numpy()

    @torch.no_grad()
    def _decode(self, tokens, positions) -> np.ndarray:
        logits = self.model.head(self._forward(tokens[:, None], positions))
        return sample_logits(
            logits[:, 0], self._generator, **self._sample_kw
        ).cpu().numpy()

    @torch.no_grad()
    def _verify(self, tokens, positions, draft_len):
        """Score the pending token + drafts of every slot in one forward.
        Returns (emission (S, k+1), accepted (S,)) as numpy: row s emits
        ``emission[s, :accepted[s] + 1]``."""
        kw = self._sample_kw
        logits = self.model.head(self._forward(tokens, positions))
        s, k1 = tokens.shape
        tok = self._dev(tokens.astype(np.int64))
        dlen = self._dev(draft_len.astype(np.int64))
        draft = tok[:, 1:]
        in_draft = torch.arange(k1 - 1, device=self.device)[None] < dlen[:, None]
        if kw["temperature"] == 0.0 or kw["top_k"] == 1:
            # chain[s, j] = greedy next token after tokens[s, :j+1]; an
            # accepted draft token equals its chain entry, so the emission
            # is chain[:, :m+1] — token-exact vs plain decode.
            chain = torch.argmax(logits, dim=-1)
            ok = (chain[:, :-1] == draft) & in_draft
            accepted = torch.cumprod(ok.long(), dim=1).sum(dim=1)
            out = chain
        else:
            # Rejection-style acceptance for a deterministic drafter: accept
            # d_j with probability p_j(d_j) under the sampling distribution;
            # at the first rejection draw the bonus from p with d_j's mass
            # removed.  Emitted tokens are distributed as plain sampling.
            probs = torch.softmax(
                filter_logits(logits, temperature=kw["temperature"],
                              top_k=kw["top_k"]), dim=-1,
            )
            u = torch.rand(draft.shape, generator=self._generator,
                           device=self.device)
            p_draft = probs[:, :-1].gather(-1, draft[..., None])[..., 0]
            ok = (u < p_draft) & in_draft
            accepted = torch.cumprod(ok.long(), dim=1).sum(dim=1)
            vocab = probs.shape[-1]
            bonus_probs = probs.gather(
                1, accepted[:, None, None].expand(s, 1, vocab)
            )[:, 0]
            rejected_tok = draft.gather(
                1, accepted.clamp(0, k1 - 2)[:, None]
            )[:, 0]
            was_rejection = accepted < dlen
            residual = torch.where(
                was_rejection[:, None]
                & (torch.arange(vocab, device=self.device)[None]
                   == rejected_tok[:, None]),
                torch.zeros_like(bonus_probs), bonus_probs,
            )
            bonus = torch.multinomial(residual, 1, generator=self._generator)
            draft_pad = torch.cat([draft, torch.zeros_like(draft[:, :1])], 1)
            out = torch.where(
                torch.arange(k1, device=self.device)[None] < accepted[:, None],
                draft_pad, bonus,
            )
        return out.cpu().numpy(), accepted.cpu().numpy()

    # ------------------------------------------------------------------ #
    # slot admission / retirement
    # ------------------------------------------------------------------ #

    @property
    def effective_slots(self) -> int:
        """Admission width: ``num_slots`` unless a re-split capped it."""
        if self.slot_cap is None:
            return self.num_slots
        return min(self.slot_cap, self.num_slots)

    @property
    def has_free_slot(self) -> bool:
        return self.pool.num_active < self.effective_slots

    @property
    def busy(self) -> bool:
        return self.pool.num_active > 0

    def validate_request(self, prompt_len: int, max_new: int) -> None:
        """Raise for a request that could never be admitted: over the
        logical position bound, or (paged) a zero-hit worst-case span
        larger than the whole block pool.  Queueing it would block the
        scheduler's queue head forever."""
        if prompt_len + max_new > self.max_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new ({max_new}) exceeds the "
                f"cache length ({self.max_len})"
            )
        if self.paged and not self.pool.fits(prompt_len, max_new):
            raise ValueError(
                f"prompt ({prompt_len}) + max_new ({max_new}) spans more "
                f"blocks than the whole pool ({self.pool.num_blocks} x "
                f"{self.pool.block_size}) — the request can never be "
                "admitted"
            )

    def can_admit(self, prompt, max_new: int) -> bool:
        """Whether ``start`` would succeed now: a free slot, plus (paged)
        enough unreserved blocks for the request's worst-case span net of
        its prefix-cache hits.  The scheduler's admission predicate."""
        if not self.has_free_slot:
            return False
        if self.paged:
            return self.pool.admissible_for(
                np.asarray(prompt, np.int32).reshape(-1), int(max_new)
            )
        return True

    def start(self, request_id, prompt, max_new: int) -> int:
        """Admit a request into a free slot; returns the slot index."""
        if self.role == "decode":
            raise RuntimeError(
                "a decode-role engine admits by adopt() — it runs no "
                "prefill step to consume a raw prompt with"
            )
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        self.validate_request(prompt.size, int(max_new))
        if self.paged:
            slot, cached = self.pool.allocate(prompt, int(max_new))
        else:
            slot, cached = self.pool.allocate(), 0
        if slot is None:
            raise RuntimeError("no free slot (check has_free_slot first)")
        self.prefill_tokens_offered += int(prompt.size)
        if self.drafter is not None:
            self.drafter.observe_prompt(prompt)
        self._slots[slot] = _Slot(
            request_id=request_id, prompt=prompt, max_new=int(max_new),
            consumed=cached,
        )
        return slot

    def _live(self, phase: str) -> list[tuple[int, _Slot]]:
        return [
            (i, sl) for i, sl in enumerate(self._slots)
            if sl is not None and sl.phase == phase
        ]

    # ------------------------------------------------------------------ #
    # prefill->decode handoff (serve/disagg.py)
    # ------------------------------------------------------------------ #

    def handoff_ready(self) -> list[int]:
        """Slots whose prompt finished prefilling on this prefill-role
        engine and now await adoption by a decode-role engine."""
        return [i for i, _ in self._live("handoff")]

    def export_handoff(self, slot: int) -> Handoff:
        """Detach a finished-prefill request for decode-side adoption: the
        request state plus the pool's KV handle (paged: the block-table
        row, the slot frees at once; contiguous: the row, copied at
        adoption).  No forward runs."""
        sl = self._slots[slot]
        if sl is None or sl.phase != "handoff":
            raise ValueError(f"slot {slot} is not awaiting handoff")
        handoff = Handoff(
            request_id=sl.request_id, prompt=sl.prompt, max_new=sl.max_new,
            generated=list(sl.generated), pending=int(sl.pending),
            export=self.pool.export_slot(slot),
        )
        self._slots[slot] = None
        return handoff

    def can_adopt(self) -> bool:
        return self.has_free_slot

    def adopt(self, handoff: Handoff) -> int:
        """Adopt a handed-off request into this decode-role engine: the
        pool installs the KV handle (the prompt's K/V as the prefill side
        wrote them) and the slot resumes at the pending token."""
        slot = self.pool.adopt_slot(handoff.export)
        self._slots[slot] = _Slot(
            request_id=handoff.request_id, prompt=handoff.prompt,
            max_new=handoff.max_new, consumed=handoff.prompt.size,
            phase="decode", pending=handoff.pending,
            generated=list(handoff.generated),
        )
        if self.drafter is not None:
            # The decode side owns the drafter: the adopted prompt feeds
            # the shared n-gram index here.
            self.drafter.observe_prompt(handoff.prompt)
        return slot

    def live_requests(self) -> list:
        """Request ids of every admitted, unfinished request."""
        return [sl.request_id for sl in self._slots if sl is not None]

    def cancel(self, request_id) -> Event:
        """Retire an in-flight request now with finish reason
        ``"cancelled"``, freeing its slot."""
        for i, sl in enumerate(self._slots):
            if sl is not None and sl.request_id == request_id:
                return self._retire(i, sl, "cancelled")
        raise KeyError(f"request {request_id!r} is not in flight")

    def _retire(self, slot: int, sl: _Slot, reason: str) -> Event:
        self._slots[slot] = None
        self.pool.release(slot)
        return Event("finish", sl.request_id, reason=reason)

    def _emit(self, slot: int, sl: _Slot, token: int) -> list[Event]:
        """Record one sampled token for ``slot``: stream it, then retire
        (EOS / budget) or queue it as the next decode input."""
        sl.generated.append(token)
        if self.stream_cb is not None:
            self.stream_cb(sl.request_id, token)
        events = [Event("token", sl.request_id, token=token)]
        if self.eos_token_id is not None and token == self.eos_token_id:
            events.append(self._retire(slot, sl, "eos"))
        elif len(sl.generated) >= sl.max_new:
            events.append(self._retire(slot, sl, "length"))
        else:
            sl.pending = token
        return events

    # ------------------------------------------------------------------ #
    # iteration-level steps
    # ------------------------------------------------------------------ #

    def prefill_step(self) -> list[Event]:
        """Advance every prefilling slot by one chunk.  A slot whose prompt
        completes samples its first output token here (the TTFT moment)."""
        batch = self._live("prefill")
        if not batch:
            return []
        s, c = self.num_slots, self.prefill_chunk
        tokens = np.zeros((s, c), np.int32)
        positions = np.full((s,), self.pool.sentinel, np.int32)
        last_idx = np.zeros((s,), np.int64)
        took = {}
        for i, sl in batch:
            n = min(c, sl.prompt.size - sl.consumed)
            tokens[i, :n] = sl.prompt[sl.consumed:sl.consumed + n]
            positions[i] = self.pool.lengths[i]
            last_idx[i] = n - 1
            took[i] = n
            if self.paged:
                self.pool.ensure_length(i, int(self.pool.lengths[i]) + n)
        span_kw = {}
        if self.spans is not None:
            span_kw["slots"] = [[i, sl.request_id, took[i]] for i, sl in batch]
            if self.spans_replica is not None:
                span_kw["replica"] = self.spans_replica
        with phase_span(self.spans, "serve/prefill", **span_kw):
            tok = self._prefill(tokens, positions, last_idx)
        self.prefill_ticks += 1
        events: list[Event] = []
        for i, sl in batch:
            sl.consumed += took[i]
            self.prefill_tokens_computed += took[i]
            self.pool.advance(i, took[i])
            if sl.consumed == sl.prompt.size:
                # A prefill-role engine parks the finished prompt for
                # handoff; its first token (the TTFT moment) is still
                # sampled and emitted here, and an EOS or a one-token
                # budget retires it on this side.
                sl.phase = "handoff" if self.role == "prefill" else "decode"
                events.extend(self._emit(i, sl, int(tok[i])))
        return events

    def decode_step(self) -> list[Event]:
        """One token for every decoding slot."""
        batch = self._live("decode")
        if not batch:
            return []
        tokens = np.zeros((self.num_slots,), np.int32)
        positions = np.full((self.num_slots,), self.pool.sentinel, np.int32)
        for i, sl in batch:
            tokens[i] = sl.pending
            positions[i] = self.pool.lengths[i]
            if self.paged:
                self.pool.ensure_length(i, int(self.pool.lengths[i]) + 1)
        span_kw = {}
        if self.spans is not None:
            span_kw["slots"] = [[i, sl.request_id] for i, sl in batch]
            if self.spans_replica is not None:
                span_kw["replica"] = self.spans_replica
        with phase_span(self.spans, "serve/decode", **span_kw):
            tok = self._decode(tokens, positions)
        events: list[Event] = []
        self.decode_ticks += 1
        self.decode_slot_ticks += len(batch)
        for i, sl in batch:
            self.pool.advance(i, 1)
            self.decode_tokens += 1
            events.extend(self._emit(i, sl, int(tok[i])))
        return events

    def verify_step(self) -> list[Event]:
        """Speculative decode tick: draft up to ``spec_k`` tokens per
        decoding slot, score all k+1 positions in one forward, and emit
        every accepted token plus the bonus.  A tick where no slot drafted
        runs the plain decode step (same emission, (k+1)x less score
        compute), as the JAX engine does.

        Rejected writes need no rollback: lengths advance only by the
        emitted count, so they sit past every slot's valid length where
        the ragged mask never reads.  The paged pool also frees the blocks
        that only rejected writes touched (``rewind``)."""
        batch = self._live("decode")
        if not batch:
            return []
        s, k1 = self.num_slots, self.spec_k + 1
        tokens = np.zeros((s, k1), np.int32)
        positions = np.full((s,), self.pool.sentinel, np.int32)
        dlen = np.zeros((s,), np.int32)
        for i, sl in batch:
            tokens[i, 0] = sl.pending
            positions[i] = self.pool.lengths[i]
            # The budget bounds emission and the cache bounds writes.
            room = min(
                sl.max_new - len(sl.generated) - 1,
                self.max_len - int(self.pool.lengths[i]) - 1,
                self.spec_k,
            )
            if sl.spec_skip > 0:
                sl.spec_skip -= 1
                continue
            draft = self.drafter.draft(sl.history(), room)
            n = int(draft.size)
            if n:
                tokens[i, 1:1 + n] = draft
                dlen[i] = n
                self.spec_drafted_tokens += n
        if not dlen.any():
            return self.decode_step()
        if self.paged:
            for i, _ in batch:
                self.pool.ensure_length(
                    i, int(self.pool.lengths[i]) + int(dlen[i]) + 1
                )
        span_kw = {}
        if self.spans is not None:
            span_kw["slots"] = [[i, sl.request_id] for i, sl in batch]
            span_kw["drafted"] = int(dlen.sum())
            if self.spans_replica is not None:
                span_kw["replica"] = self.spans_replica
        with phase_span(self.spans, "serve/verify", **span_kw) as vspan:
            out, accepted = self._verify(tokens, positions, dlen)
            if vspan is not None:
                vspan.attrs["accepted"] = int(accepted[
                    [i for i, _ in batch]].sum())
        events: list[Event] = []
        self.decode_ticks += 1
        self.decode_slot_ticks += len(batch)
        for i, sl in batch:
            m = int(accepted[i])
            self.spec_accepted_tokens += m
            if dlen[i]:
                if m == 0:
                    sl.spec_fail = min(sl.spec_fail + 1, self.SPEC_BACKOFF_CAP)
                    sl.spec_skip = 2 ** sl.spec_fail
                else:
                    sl.spec_fail = 0
            emit = out[i, :m + 1]
            # An EOS inside the accepted span retires the slot at the EOS.
            emit = emit[:eos_cut_length(emit, self.eos_token_id)]
            # Claim the pending token plus the emitted-minus-one accepted
            # drafts; the last emitted token is the next input.
            self.pool.advance(i, int(emit.size))
            self.decode_tokens += int(emit.size)
            if self.paged:
                self.pool.rewind(i)
            for t in emit:
                events.extend(self._emit(i, sl, int(t)))
                if self._slots[i] is None:  # retired (EOS / budget)
                    break
        return events

    def step(self) -> list[Event]:
        """One engine tick.  ``role="both"``: a prefill chunk for
        prompt-loading slots, then a decode (or speculative verify) batch
        for generating slots.  A role engine runs its own half only; the
        disaggregated tier sequences the two."""
        if self.role == "prefill":
            return self.prefill_step()
        decode = self.verify_step if self.spec_k > 0 else self.decode_step
        if self.role == "decode":
            return decode()
        return self.prefill_step() + decode()

    def stats(self) -> dict:
        """Host-side accounting: prefill work computed vs offered (the
        prefix-cache saving), decode/spec counters, and the paged pool's
        block/hit/eviction counters when paged."""
        out = {
            "slots_active": self.pool.num_active,
            "slot_cap": self.effective_slots,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefill_tokens_offered": self.prefill_tokens_offered,
            "decode_ticks": self.decode_ticks,
            "decode_slot_ticks": self.decode_slot_ticks,
            "decode_tokens": self.decode_tokens,
        }
        if self.spec_k > 0:
            out["spec_drafted_tokens"] = self.spec_drafted_tokens
            out["spec_accepted_tokens"] = self.spec_accepted_tokens
        if self.paged:
            out.update(self.pool.stats())
        return out

    def memory_model(self, program: str) -> dict[str, int]:
        """The analytic per-rank byte model of one step (``program``:
        "prefill", "decode" or "verify"), computed from the engine's
        config as the JAX package's ``memory_model`` computes it, in the
        reference's layout: the parameters under ``serve_tp_rules`` over
        the tensor axis, the KV pool split on the heads (with the
        reference cache's index scalars, an int32 a layer and one for
        the positions), the host operands and the activation estimate.
        ``kv_cache_resident`` is the port's own pool tensors on this rank
        (their scratch row or block included, local heads only)."""
        from types import SimpleNamespace

        from ..comm.mesh import MESH_AXES
        from ..models.gpt2 import GPT2
        from ..obs.cost import (
            kv_pool_model_bytes, serve_activation_estimate,
            tree_bytes_per_device,
        )
        from ..parallel.sharding import serve_tp_rules

        if program not in ("prefill", "decode", "verify"):
            raise ValueError(f"unknown program {program!r}")
        cfg = self.model.cfg
        whole = dict(GPT2(cfg, device="meta",
                          dtype=self.model.wte.dtype).named_parameters())
        if self.tp > 1:
            mesh = SimpleNamespace(shape={
                **{a: 1 for a in MESH_AXES}, "tensor": self.tp})
            params = tree_bytes_per_device(whole, mesh=mesh,
                                           rules=serve_tp_rules())
        else:
            params = tree_bytes_per_device(whole)
        quant = None if self.kv_dtype == "bf16" else self.kv_dtype
        head_dim = cfg.hidden_dim // cfg.num_heads
        cache = kv_pool_model_bytes(
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            head_dim=head_dim, max_len=self.pool.max_len,
            num_slots=self.num_slots, paged=self.paged,
            num_blocks=getattr(self.pool, "num_blocks", 0),
            block_size=getattr(self.pool, "block_size", 0),
            itemsize=self.model.wte.element_size(), tp=self.tp,
            index_bytes=4 * (cfg.num_layers + 1), dtype=quant,
        )
        s = self.num_slots
        width = {"prefill": self.prefill_chunk, "decode": 1,
                 "verify": self.spec_k + 1}[program]
        table = 4 * s * self.pool.blocks_per_slot if self.paged else 0
        operands = {
            # tokens + positions (+ last_idx / draft_len) + the rng key.
            "prefill": 4 * s * self.prefill_chunk + 4 * s + 4 * s,
            "decode": 4 * s + 4 * s,
            "verify": 4 * s * (self.spec_k + 1) + 4 * s + 4 * s,
        }[program] + table + 8
        activations = serve_activation_estimate(
            num_slots=s, width=width, hidden=cfg.hidden_dim,
            num_heads=cfg.num_heads, vocab=cfg.vocab_size,
            mask_len=self.pool.mask_len, paged=self.paged,
            cache_bytes=cache, head_dim=head_dim,
            kv_quant=quant is not None,
        )
        arguments = params + cache + operands
        return {
            "params": params,
            "kv_cache": cache,
            "kv_cache_model": cache,
            "operands": operands,
            "activation_estimate": activations,
            "arguments": arguments,
            "aliased": cache,
            "total": arguments + activations,
            "kv_cache_resident": sum(
                t.numel() * t.element_size()
                for layer in self.pool.cache for t in layer),
        }

    def _host_store(self):
        return getattr(getattr(self.pool, "blocks", None), "host", None)

    def shrink_host_tier(self) -> int | None:
        """Empty the host KV tier and size it to zero (the autoscale
        ladder's first rung: spill and restore work leaves the hot path;
        the tier was a cache, nothing is owed).  Returns the capacity it
        had, None without a tier."""
        host = self._host_store()
        if host is None:
            return None
        capacity = host.capacity_bytes
        host.reset()
        host.capacity_bytes = 0
        return capacity

    def restore_host_tier(self, capacity_bytes: int) -> None:
        """Give the host KV tier back the capacity ``shrink_host_tier``
        returned."""
        host = self._host_store()
        if host is not None:
            host.capacity_bytes = int(capacity_bytes)

    def reset(self) -> None:
        """Drop every in-flight request, the prefix cache, the drafter
        index and the counters, and rewind the sampling generator to the
        seed: a leg run on a reused engine sees the state a fresh engine
        would.  The shared ``NgramIndex`` is cleared in place, never
        replaced (the router shares one index across replicas)."""
        self._slots = [None] * self.num_slots
        self.slot_cap = None
        self.pool.reset()
        self.prefill_tokens_computed = 0
        self.prefill_tokens_offered = 0
        self.prefill_ticks = 0
        self.decode_ticks = 0
        self.decode_slot_ticks = 0
        self.decode_tokens = 0
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self._generator.manual_seed(self._seed)
        if self.drafter is not None and self.drafter.index is not None:
            self.drafter.index.clear()
