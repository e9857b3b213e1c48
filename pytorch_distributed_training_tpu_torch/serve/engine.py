"""Continuous-batching decode engine: the counterpart of the JAX package's
``serve/engine.py`` (one engine with both roles, no tensor parallelism),
over the contiguous slot pool or, with ``paged=True``, the paged block
pool with prefix caching, an optional host-RAM tier and int8/int4 KV.

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
from .kv_pool import KVCachePool, PagedKVCachePool
from .kv_store import HostKVStore


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
        if kv_host_mb is not None and not paged:
            raise ValueError(
                "the host KV tier spills paged blocks — pass paged=True"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.eos_token_id = eos_token_id
        self.prefill_chunk = prefill_chunk
        self.stream_cb = stream_cb
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.drafter = PromptLookupDrafter(
            max_ngram=spec_ngram,
            min_ngram=min(max(2, spec_ngram - 1), spec_ngram),
            index=NgramIndex(spec_ngram),
        ) if spec_k > 0 else None
        cap = max_len or model.cfg.max_seq_len
        self.paged = paged
        if paged:
            self.pool = PagedKVCachePool(
                self.model, num_slots=num_slots,
                num_blocks=num_blocks or num_slots * (-(-cap // block_size)),
                block_size=block_size, max_len=cap,
                prefix_cache=prefix_cache,
                kv_quant=None if kv_dtype == "bf16" else kv_dtype,
                host_store=(
                    None if kv_host_mb is None
                    else HostKVStore(int(kv_host_mb * 2**20))
                ),
            )
        else:
            self.pool = KVCachePool(
                self.model, num_slots=num_slots, max_len=cap,
            )
        self.max_len = self.pool.max_len
        self.num_slots = num_slots
        self._slots: list[_Slot | None] = [None] * num_slots
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._sample_kw = dict(temperature=temperature, top_k=top_k)
        self._mask_cols = torch.arange(self.pool.mask_len, device=self.device)
        self.prefill_tokens_computed = 0
        self.prefill_tokens_offered = 0
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
    def has_free_slot(self) -> bool:
        return self.pool.num_active < self.num_slots

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
        events: list[Event] = []
        for i, sl in batch:
            sl.consumed += took[i]
            self.prefill_tokens_computed += took[i]
            self.pool.advance(i, took[i])
            if sl.consumed == sl.prompt.size:
                sl.phase = "decode"
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
        """One engine tick: a prefill chunk for prompt-loading slots, then
        a decode (or speculative verify) batch for generating slots."""
        decode = self.verify_step if self.spec_k > 0 else self.decode_step
        return self.prefill_step() + decode()

    def stats(self) -> dict:
        """Host-side accounting: prefill work computed vs offered (the
        prefix-cache saving), decode/spec counters, and the paged pool's
        block/hit/eviction counters when paged."""
        out = {
            "slots_active": self.pool.num_active,
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
