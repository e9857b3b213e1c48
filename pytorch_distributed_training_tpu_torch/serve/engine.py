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
cache, once, at construction.  Here each is a program object
(``_Program``) over static input buffers on the device: on the card the
engine warms each up once and captures it as a CUDA graph into one memory
pool per engine, and every tick replays it; a tensor-parallel engine
(whose forward all-reduces over its group) and an engine built with
``cuda_graphs=False`` run the same bodies eagerly, as every engine does on
the CPU.  Each program records its abstract signature in
``analysis/signature.py::PROGRAM_REGISTRY`` once, at construction
(``program_signatures``).  Role gating is JAX's: a prefill-role engine
builds prefill only, a decode-role engine decode and, with ``spec_k >
0``, verify.

The programs write the cache tensors in place, which is JAX's contract:
one cache, never copied per tick, whose addresses the graphs hold, so a
tick raises if the cache or a parameter has moved since the capture.
Idle rows ride along at the sentinel position (their writes land in the
cache's scratch row or block, their outputs are discarded), so admission
and retirement are host bookkeeping only, and the warm-up before a
capture, with every row idle, touches no live K/V.  A tick fills pinned
host staging buffers (tokens, positions, ``last_idx`` or ``draft_len``,
the paged block table the host has just allocated for the tick), copies
them into the static inputs, runs the program and reads its output back.

Each step runs inside ``obs.trace.phase_span`` (``serve/prefill``,
``serve/decode``, ``serve/verify``): a profiler range and, when the
scheduler wired a ``SpanRecorder`` (``--trace``), a tick span carrying
its slots and request ids (``spans_replica`` too under a replica id).
The step's tokens are read back inside it, so it closes on finished
device work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ..analysis.signature import PROGRAM_REGISTRY, abstract_signature
from ..comm.compress import KV_DTYPES
from ..models.generate import (
    draw_categorical, eos_cut_length, filter_logits, sample_logits,
)
from ..obs.trace import phase_span
from ..ops.decode_attention import decode_attention, decode_attention_multi
from ..ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_multi,
    paged_prefill_attention,
)
from ..utils.device import resolve_device
from .draft import NgramIndex, PromptLookupDrafter
from .kv_pool import KVCachePool, PagedKVCachePool, SlotExport
from .kv_store import HostKVStore

ROLES = ("both", "prefill", "decode")
# The kernel wrappers a serving forward calls.  A graph replay launches
# the kernels its capture recorded without calling them, so the replay
# adds to their counts (``.launches``) what the capture recorded.
KERNEL_WRAPPERS = (decode_attention, decode_attention_multi,
                   paged_decode_attention, paged_decode_attention_multi,
                   paged_prefill_attention)


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


def captured(fn):
    """Marks a program body: the code a CUDA graph records once, at
    capture, and replays without its host code.  It changes nothing at
    run time; the lint (``analysis/lint.py``) holds such a body to
    ``host-read`` and ``host-clock-in-capture``."""
    return fn


def _pool_bytes(pool) -> int | None:
    """Bytes the caching allocator holds for the private memory pool
    ``pool`` (the graphs'), summed over its segments; None where the
    allocator's snapshot does not name pools."""
    total, named = 0, False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is None:
            continue
        named = True
        if tuple(pid) == tuple(pool):
            total += int(seg["total_size"])
    return total if named else None


class _Program:
    """One of the engine's fixed-shape programs: prefill, decode or verify,
    the twin of one of the JAX engine's AOT programs.

    ``inputs``: its static input buffers on the engine's device, in
    calling order; ``body(**inputs)`` returns its one int64 output of
    ``out_shape``; ``donated``: the cache tensors it writes in place.
    ``capture`` warms it up and captures it as a CUDA graph; uncaptured,
    ``run`` calls ``body`` eagerly on the same buffers."""

    def __init__(self, body, inputs: dict, out_shape: tuple, donated: list):
        self.body = body
        self.inputs = inputs
        self.donated = donated
        self.out_shape = out_shape
        first = next(iter(inputs.values()))
        # The host side of each input: pinned staging on the card, copied
        # to the static input ahead of the program; the input itself on
        # the CPU.
        self._staging = {
            k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            for k, v in inputs.items()
        } if first.is_cuda else inputs
        self._host = {k: v.numpy() for k, v in self._staging.items()}
        self._out = None
        self.graph = None
        self.launches: dict = {}      # wrapper -> launches a replay makes
        self.warmup_launches: dict = {}
        self.capture_s: float | None = None
        self.replays = 0

    @property
    def outputs(self) -> tuple:
        """The output tensors (abstract until a capture made them)."""
        if self._out is not None:
            return (self._out,)
        return (torch.empty(self.out_shape, dtype=torch.int64,
                            device="meta"),)

    def capture(self, pool, generator) -> None:
        """Warm up once on a side stream (plans, workspaces, allocator),
        then capture the body into ``pool`` with ``generator``'s state
        registered.  Every input must hold idle rows (sentinel positions),
        so both write only the cache's scratch row or block.  The
        capture's wrapper calls launch nothing: their counts are restored
        and kept as the launches of one replay.  A failure raises."""
        dev = next(iter(self.inputs.values())).device
        t0 = time.perf_counter()
        before = [fn.launches for fn in KERNEL_WRAPPERS]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.body(**self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = [fn.launches for fn in KERNEL_WRAPPERS]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with torch.cuda.graph(graph, pool=pool):
            out = self.body(**self.inputs)
        for fn, b, w in zip(KERNEL_WRAPPERS, before, warm):
            if w > b:
                self.warmup_launches[fn] = w - b
            if fn.launches > w:
                self.launches[fn] = fn.launches - w
            fn.launches = w
        torch.cuda.synchronize(dev)
        self.graph, self._out = graph, out
        self.capture_s = time.perf_counter() - t0

    def run(self, **host) -> np.ndarray:
        """One tick: load the host arrays, run, read the output back."""
        for k, arr in host.items():
            self._host[k][...] = arr
            if self._staging is not self.inputs:
                self.inputs[k].copy_(self._staging[k], non_blocking=True)
        if self.graph is None:
            out = self.body(**self.inputs)
        else:
            self.graph.replay()
            self.replays += 1
            for fn, n in self.launches.items():
                fn.launches += n
            out = self._out
        return out.cpu().numpy()


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
    adds a host-RAM tier that evicted prefix blocks spill to.

    ``cuda_graphs`` (default True): on the card, capture the programs as
    CUDA graphs at construction; False runs them eagerly (the comparison
    path).  A tensor-parallel engine runs them eagerly either way, and so
    does every engine on the CPU."""

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
        cuda_graphs: bool = True,
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
        # Graphs hold device addresses; a tensor shard's forward
        # all-reduces over gloo, which a capture cannot hold.
        self.cuda_graphs = (bool(cuda_graphs) and self.device.type == "cuda"
                            and self.tp == 1)
        self.graph_pool_bytes: int | None = None
        self.program_signatures: dict[str, str] = {}
        self._programs = self._compile()

    # ------------------------------------------------------------------ #
    # device steps
    # ------------------------------------------------------------------ #

    def _compile(self) -> dict:
        """Build the role's programs over idle static inputs, capture them
        on the card (one memory pool for the engine), and record each
        signature once.  A failed capture raises."""
        s, dev = self.num_slots, self.device
        pos = self.pool.sentinel

        def inputs(tokens_shape, **extra):
            out = {"tokens": torch.zeros(tokens_shape, dtype=torch.int64,
                                         device=dev),
                   "positions": torch.full((s,), pos, dtype=torch.int32,
                                           device=dev), **extra}
            if self.paged:
                out["table"] = torch.tensor(self.pool.block_tables,
                                            dtype=torch.int32, device=dev)
            return out

        def rows():
            return torch.zeros((s,), dtype=torch.int64, device=dev)

        donated = [t for layer in self.pool.cache for t in layer]
        programs = {}
        if self.role in ("both", "prefill"):
            programs["prefill"] = _Program(
                self._prefill,
                inputs((s, self.prefill_chunk), last_idx=rows()), (s,),
                donated)
        if self.role in ("both", "decode"):
            programs["decode"] = _Program(
                self._decode, inputs((s,)), (s,), donated)
            if self.spec_k > 0:
                k1 = self.spec_k + 1
                programs["verify"] = _Program(
                    self._verify, inputs((s, k1), draft_len=rows()),
                    (s, k1 + 1), donated)
        if self.cuda_graphs:
            pool = torch.cuda.graph_pool_handle()
            for prog in programs.values():
                prog.capture(pool, self._generator)
            # The warm-ups drew from the generator: start from the seed.
            self._generator.manual_seed(self._seed)
            self._params = list(self.model.parameters())
            self._bound = self._addresses(self._params)
            self.graph_pool_bytes = _pool_bytes(pool)
        for name, prog in programs.items():
            sig = abstract_signature(prog)
            self.program_signatures[name] = sig
            PROGRAM_REGISTRY.record(f"serve/{name}", sig)
        return programs

    def _addresses(self, params) -> tuple:
        """Where the cache and ``params`` live: what the graphs hold."""
        return (tuple(t.data_ptr() for layer in self.pool.cache
                      for t in layer),
                tuple(p.data_ptr() for p in params))

    def _check_bound(self, params) -> None:
        if self._addresses(params) != self._bound:
            raise RuntimeError(
                "the KV cache or the model's parameters moved after the "
                "engine captured its programs, which hold the old "
                "addresses: build a new engine over them"
            )

    def _run(self, name: str, **host) -> np.ndarray:
        # Each tick: the cache as the pool holds it now and the storage of
        # the parameters captured (a reset also checks that the model
        # still holds those parameters).
        if self.cuda_graphs:
            self._check_bound(self._params)
        return self._programs[name].run(**host)

    def program_stats(self) -> dict:
        """Per program: capture seconds, replays, the kernel launches of
        one replay and of the warm-up (by wrapper name); and the graphs'
        pool bytes.  Empty figures when the programs run eagerly."""
        def named(d):
            return {fn.__name__: n for fn, n in d.items()}
        return {
            "cuda_graphs": self.cuda_graphs,
            "graph_pool_bytes": self.graph_pool_bytes,
            "programs": {
                name: {"capture_s": p.capture_s, "replays": p.replays,
                       "launches_per_replay": named(p.launches),
                       "warmup_launches": named(p.warmup_launches)}
                for name, p in self._programs.items()
            },
        }

    @captured
    def _forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                 table: torch.Tensor | None):
        """Final hidden states (S, width, D) for one tick; the cache is
        written in place.  The slot-mode validity mask is built once here
        for every layer."""
        cols = positions[:, None].long() + torch.arange(
            tokens.shape[1], device=self.device
        )
        mask = self._mask_cols[None, None, :] <= cols[:, :, None]
        return self.model(
            tokens, cache=self.pool.cache, positions=positions,
            attn_mask=mask, block_table=table, return_hidden=True,
        )

    @torch.no_grad()
    @captured
    def _prefill(self, tokens: torch.Tensor, positions: torch.Tensor,
                 last_idx: torch.Tensor, table: torch.Tensor | None = None):
        hidden = self._forward(tokens, positions, table)
        rows = torch.arange(self.num_slots, device=self.device)
        last = self.model.head(hidden[rows, last_idx])
        return sample_logits(last, self._generator, **self._sample_kw)

    @torch.no_grad()
    @captured
    def _decode(self, tokens: torch.Tensor, positions: torch.Tensor,
                table: torch.Tensor | None = None):
        logits = self.model.head(self._forward(tokens[:, None], positions,
                                               table))
        return sample_logits(logits[:, 0], self._generator, **self._sample_kw)

    @torch.no_grad()
    @captured
    def _verify(self, tokens: torch.Tensor, positions: torch.Tensor,
                draft_len: torch.Tensor, table: torch.Tensor | None = None):
        """Score the pending token + drafts of every slot in one forward.
        Returns (S, k+2): the emission (S, k+1) and the accepted count in
        the last column; row s emits ``emission[s, :accepted[s] + 1]``."""
        kw = self._sample_kw
        logits = self.model.head(self._forward(tokens, positions, table))
        s, k1 = tokens.shape
        draft = tokens[:, 1:]
        in_draft = (torch.arange(k1 - 1, device=self.device)[None]
                    < draft_len[:, None])
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
            was_rejection = accepted < draft_len
            residual = torch.where(
                was_rejection[:, None]
                & (torch.arange(vocab, device=self.device)[None]
                   == rejected_tok[:, None]),
                torch.zeros_like(bonus_probs), bonus_probs,
            )
            bonus = draw_categorical(residual, self._generator)[:, None]
            draft_pad = torch.cat([draft, torch.zeros_like(draft[:, :1])], 1)
            out = torch.where(
                torch.arange(k1, device=self.device)[None] < accepted[:, None],
                draft_pad, bonus,
            )
        return torch.cat([out, accepted[:, None]], dim=1)

    def _tick_inputs(self, **host) -> dict:
        """A tick's host arrays, with the paged block table as the host
        allocated it for this tick."""
        if self.paged:
            host["table"] = self.pool.block_tables
        return host

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
            tok = self._run("prefill", **self._tick_inputs(
                tokens=tokens, positions=positions, last_idx=last_idx))
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
            tok = self._run("decode", **self._tick_inputs(
                tokens=tokens, positions=positions))
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
            res = self._run("verify", **self._tick_inputs(
                tokens=tokens, positions=positions, draft_len=dlen))
            out, accepted = res[:, :-1], res[:, -1]
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
        replaced (the router shares one index across replicas).  The
        cache stays where it is, so the captured programs replay on; with
        graphs, it raises if the cache or the model's parameters moved."""
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
        if self.cuda_graphs:
            self._check_bound(list(self.model.parameters()))
