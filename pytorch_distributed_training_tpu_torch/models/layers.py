"""Transformer self-attention with the KV-cache decode modes.

Counterpart of the JAX package's ``models/layers.py::SelfAttention``,
limited to what the serving and training slices run:

- the full-sequence forward (``cache=None``), causal (GPT-2) or not
  (ViT), through ``ops.attention.dot_product_attention``'s auto
  dispatch: the flash kernels on the card at ``q_len >= 256``, the plain
  path below and on the host;
- the non-causal head-major layouts of the ViT (``attn_layout``):
  ``"bhld"`` transposes q/k/v, taken as column spans of the packed qkv
  activation, to (B, H, L, Dh) once; ``"bhld2"`` (the ViT's default)
  makes each of q/k/v head-major straight from its own column span of
  the one ``qkv`` weight (``_qkv_to_heads``).  Both then run
  ``_bhld_core``: (b, h)-leading score and combine products and an
  output projection that contracts (h, d) against the ``proj`` weight
  viewed as (D, H, Dh) (``_proj_from_heads``).  Neither calls
  ``dot_product_attention``, so neither reaches a kernel.  The parameters
  are the ``nn.Linear`` ``qkv``/``proj`` under every layout;
- slot mode: per-row start ``positions`` (B,), a chunk of C tokens per row
  written at ``positions[b]..positions[b]+C-1``, each query attending its
  own row's prefix.  ``serve/engine.py`` drives it with ragged positions;
  lockstep decode (``models/generate.py``) is the same mode with one token
  and every row at the same position, which is what the JAX package's
  scalar ``cache_index`` path computes.

The cache is a (k, v) pair of (B, H, L + 1, Dh) tensors written in place
(``new_kv_cache``).  Positions 0..L-1 hold tokens; position L is a scratch
row that takes every write at or past L — the idle-slot sentinel's, and a
verify chunk's tail near the end of the cache — and that no read covers.
That is the counterpart of the JAX scatter's ``mode="drop"`` without a
data-dependent shape (and so without a device sync).

With a ``block_table`` (B, nb) int32 the cache is the PAGED block pool
(``new_block_cache``, driven by ``serve/kv_pool.py``): (k, v) of shape
(num_blocks + 1, H, block_size, Dh), or (k, v, k_scale, v_scale) for a
quantized pool (int8 payload, or int4 nibbles as uint8 at Dh / 2, plus a
bf16 scale per (block, head, position)).  Logical position p of row b
lives in block ``block_table[b, p // block_size]`` at offset
``p % block_size``; a table entry equal to num_blocks is the unallocated
sentinel.  Block num_blocks is the scratch block: every write through a
sentinel entry or past the table span lands there, and no read reaches
it, because reads go through the table clamped to the real blocks.

**Tensor and sequence parallelism** (the full-sequence forward, with a
``parallel`` context from ``parallel/sharded.py::configure_model``).
Under tensor parallelism the ``qkv`` weight and bias this module holds
are its rank's column shard, laid out by head (q, k and v of heads
``t*H/tp .. (t+1)*H/tp - 1``), and ``proj``'s weight its row shard: the
input goes through Megatron's ``f`` (identity, all-reduce backward), the
rank attends over its local heads, projects them without the bias, and
``g`` (the all-reduce) sums the partial projections before the bias is
added once.  The head-major ViT layouts take the same path as "auto"
there (both compute the same function).  Under sequence parallelism the
input holds this rank's L/n positions and the attention core is ring
attention or Ulysses over the sequence group (``parallel/
ring_attention.py``, ``parallel/ulysses.py``); both compose with tensor
parallelism, each rank of a sequence group carrying its tensor shard of
the heads.  A module whose weights are whole (no tensor shard) runs the
plain path whatever the context says.

**Tensor-parallel serving** (the cached forward, ``parallel/sharded.py::
shard_for_serving``).  The same shards: the local head count comes from
the ``qkv`` shard, the cache holds those heads only (``GPT2.new_cache``),
the decode and paged kernels run on them as on whole weights, and the
partial projections are summed over the tensor group (``g``) before the
bias.  These are the JAX package's ``*_tp`` ``shard_map`` wrappers
(``pallas_attention.py``) without a wrapper.
"""

from __future__ import annotations

import torch
from torch import nn

from ..comm.collectives import copy_to_group, reduce_from_group
from ..comm.compress import quantize_kv
from ..ops.attention import SoftmaxLowp, dot_product_attention
from ..ops.decode_attention import decode_attention, decode_attention_multi
from ..ops.paged_attention import (
    MAX_FUSED_PREFILL_CHUNK, paged_decode_attention,
    paged_decode_attention_multi, paged_prefill_attention, paged_window,
)

# Widest chunk the fused multi-query decode kernels take (the speculative
# verify step's k+1 tokens per slot).  On the contiguous cache wider
# chunks (prefill) take the plain ragged path; on the paged pool chunks up
# to MAX_FUSED_PREFILL_CHUNK take the paged kernel, as in the JAX package.
# Which side of these lines is faster on the H100 has not been measured.
MAX_FUSED_DECODE_CHUNK = 8
# Stored payload dtype of each quantized KV storage kind.
KV_QUANT_DTYPES = {"int8": torch.int8, "int4": torch.uint8}
ATTN_LAYOUTS = ("auto", "bhld", "bhld2")


def new_kv_cache(batch: int, num_heads: int, length: int, head_dim: int, *,
                 dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer's zeroed (k, v) cache for ``length`` positions plus the
    scratch row that takes dropped writes."""
    shape = (batch, num_heads, length + 1, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def new_kv_blocks(num_blocks: int, num_heads: int, block_size: int,
                  head_dim: int, *, dtype, device, kv_quant=None) -> tuple:
    """One layer's zeroed paged pool: ``num_blocks`` blocks plus the
    scratch block that takes dropped writes.  (k, v) in ``dtype``, or
    with ``kv_quant`` "int8"/"int4" the stored payload plus bf16 scales
    (k, v, k_scale, v_scale)."""
    shape = (num_blocks + 1, num_heads, block_size, head_dim)
    if kv_quant is None:
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))
    if kv_quant not in KV_QUANT_DTYPES:
        raise ValueError(f"kv_quant {kv_quant!r} not in (None, 'int8', 'int4')")
    if kv_quant == "int4":
        if head_dim % 2:
            raise ValueError(
                f"int4 KV packing needs an even head_dim, got {head_dim}"
            )
        shape = shape[:-1] + (head_dim // 2,)
    stored = KV_QUANT_DTYPES[kv_quant]
    return (torch.zeros(shape, dtype=stored, device=device),
            torch.zeros(shape, dtype=stored, device=device),
            torch.zeros(shape[:3], dtype=torch.bfloat16, device=device),
            torch.zeros(shape[:3], dtype=torch.bfloat16, device=device))


def cache_quant(cache) -> str | None:
    """The storage kind of one layer's cache: None (native) or the
    quantized kind its payload dtype stands for."""
    for name, dtype in KV_QUANT_DTYPES.items():
        if cache[0].dtype == dtype:
            return name
    return None


class SelfAttention(nn.Module):
    """Fused-QKV multi-head self-attention over (B, L, D).

    ``attn_layout`` ("auto", "bhld", "bhld2") picks the activation layout
    of the non-causal full-sequence forward; the causal and cached paths
    always take "auto"'s, as in the JAX package.  ``parallel`` (set by
    ``parallel/sharded.py::configure_model``) turns on the tensor- and
    sequence-parallel forward (module docstring)."""

    parallel = None

    def __init__(self, hidden_dim: int, num_heads: int, *, causal: bool = True,
                 attn_layout: str = "auto", device=None, dtype=None):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(
                f"hidden_dim {hidden_dim} is not divisible by "
                f"num_heads {num_heads}"
            )
        if attn_layout not in ATTN_LAYOUTS:
            raise ValueError(
                f"attn_layout {attn_layout!r} not in {ATTN_LAYOUTS}"
            )
        self.num_heads = num_heads
        self.causal = causal
        self.attn_layout = attn_layout
        kw = dict(device=device, dtype=dtype)
        self.qkv = nn.Linear(hidden_dim, 3 * hidden_dim, **kw)
        self.proj = nn.Linear(hidden_dim, hidden_dim, **kw)

    def forward(self, x, *, cache=None, positions=None, attn_mask=None,
                block_table=None):
        """``cache``: (k, v) from ``new_kv_cache``, updated in place, with
        ``positions`` (B,) int32 the chunk start of each row; with
        ``block_table`` (B, nb) int32, the paged pool from
        ``new_kv_blocks`` instead.  ``attn_mask`` (B, C, L) bool is the
        validity the caller computes once per tick; only the ragged path
        (chunks wider than the fused kernels) reads it."""
        b, l, d = x.shape
        h = self.num_heads
        if cache is None and self.parallel is not None:
            if positions is not None:
                raise ValueError("positions need a KV cache")
            return self._parallel_forward(x)
        if cache is None and not self.causal and self.attn_layout != "auto":
            if positions is not None:
                raise ValueError("positions need a KV cache")
            if self.attn_layout == "bhld2":
                q, k, v = _qkv_to_heads(x, self.qkv.weight, self.qkv.bias, h)
            else:
                q, k, v = (t.transpose(1, 2) for t in
                           self.qkv(x).view(b, l, 3, h, d // h).unbind(2))
            return _bhld_core(q, k, v, self.proj.weight, self.proj.bias)
        # Columns split as (3, H, Dh): q is columns 0..d-1.  The JAX
        # package picks between this split and last-axis column spans
        # (``qkv[..., :d]``) by the attention it dispatches to, a layout
        # choice for XLA; in PyTorch both are the same strided view.
        # A cached forward under a tensor shard (serving) attends over
        # the rank's local heads (module docstring).
        local = self.qkv.weight.shape[0] // (3 * (d // h))
        group = None
        if local != h:
            if cache is None or self.parallel is None:
                raise ValueError(
                    "a tensor shard of qkv needs the parallel context "
                    "(parallel/sharded.py::configure_model)")
            group = self.parallel.tp_group
            x = copy_to_group(x, group)
        q, k, v = self.qkv(x).view(b, l, 3, local, d // h).unbind(2)
        if cache is None:
            if positions is not None:
                raise ValueError("positions need a KV cache")
            out = dot_product_attention(q, k, v, causal=self.causal)
        else:
            if positions is None:
                raise ValueError("a KV cache needs positions")
            if block_table is not None:
                out = _paged_attend(q, k, v, positions, block_table, cache,
                                    attn_mask)
            elif cache_quant(cache) is not None:
                raise ValueError(
                    "quantized KV lives in the paged block pool: the "
                    "contiguous slot cache has no per-block scales (pass "
                    "block_table)"
                )
            else:
                out = _slot_attend(q, k, v, positions, cache, attn_mask)
        out = out.reshape(b, l, local * (d // h))
        if group is None:
            return self.proj(out)
        y = reduce_from_group(torch.nn.functional.linear(
            out, self.proj.weight), group)
        return y + self.proj.bias


    def _parallel_forward(self, x):
        """The full-sequence forward under ``self.parallel``: local heads
        under a tensor shard of ``qkv``/``proj``, the ring or Ulysses core
        under a sequence group (module docstring)."""
        b, l, d = x.shape
        par = self.parallel
        tp = self.qkv.weight.shape[0] < 3 * d
        if tp:
            x = copy_to_group(x, par.tp_group)
        qkv = self.qkv(x)
        h = qkv.shape[-1] // (3 * (d // self.num_heads))
        q, k, v = qkv.view(b, l, 3, h, d // self.num_heads).unbind(2)
        if par.sp_size > 1:
            if par.sp_mode == "ring":
                from ..parallel.ring_attention import ring_self_attention

                out = ring_self_attention(q, k, v, par, causal=self.causal)
            elif par.sp_mode == "ulysses":
                from ..parallel.ulysses import ulysses_attention

                out = ulysses_attention(q, k, v, par, causal=self.causal)
            else:
                raise ValueError(
                    f"unknown sp_mode {par.sp_mode!r} (ring|ulysses)")
        else:
            out = dot_product_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=self.causal)
        out = out.reshape(b, l, -1)
        if not tp:
            return self.proj(out)
        y = reduce_from_group(torch.nn.functional.linear(
            out, self.proj.weight), par.tp_group)
        return y + self.proj.bias


def _qkv_to_heads(x, weight, bias, num_heads: int):
    """q, k, v as (B, H, L, Dh), each from its own column span of the
    (3D, D) ``qkv`` weight viewed (H, Dh, D), the bias added after the
    product in the activations' dtype (JAX ``_QkvToHeads``)."""
    d = x.shape[-1]
    dh = d // num_heads
    out = []
    for i in range(3):
        w = weight[i * d:(i + 1) * d].view(num_heads, dh, d)
        bb = bias[i * d:(i + 1) * d].view(num_heads, 1, dh)
        out.append(torch.einsum("bld,hed->bhle", x, w) + bb)
    return tuple(out)


def _proj_from_heads(o, weight, bias):
    """The output projection of a (B, H, L, Dh) attention output: the
    (D, D) ``proj`` weight viewed (D, H, Dh), contracted over (h, d)
    (JAX ``_ProjFromHeads``)."""
    _, h, _, dh = o.shape
    w = weight.view(weight.shape[0], h, dh)
    return torch.einsum("bhld,fhd->blf", o, w) + bias


def _bhld_core(q, k, v, proj_weight, proj_bias):
    """Non-causal attention over (B, H, L, Dh) q/k/v and the head-major
    output projection (JAX ``_bhld_core``).  bf16: the score product and
    its scale in bf16, then ``SoftmaxLowp`` (f32 softmax, bf16
    probabilities saved); f32 keeps an f32 chain."""
    scale = q.shape[-1] ** -0.5
    if q.dtype == torch.bfloat16:
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * torch.tensor(
            scale, dtype=q.dtype)
        weights = SoftmaxLowp.apply(logits)
    else:
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
        weights = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)
    return _proj_from_heads(o, proj_weight, proj_bias)


def _slot_attend(q, k, v, positions, cache, attn_mask):
    """Per-row cache write at ``positions[b] + j``, then attention over
    each row's prefix.  A write at or past the cache length goes to the
    scratch row: an idle slot (sentinel position) changes no live
    position, and clamping instead would corrupt a live slot's last
    position."""
    ck_all, cv_all = cache
    b, c, h, dh = q.shape
    max_len = ck_all.shape[2] - 1
    cols = positions[:, None].long() + torch.arange(c, device=q.device)
    dest = cols.clamp(max=max_len)
    rows = torch.arange(b, device=q.device)[:, None].expand(b, c)
    # Indexing (rows, :, dest) selects (B, C, H, Dh) — k/v's own layout.
    ck_all[rows, :, dest] = k
    cv_all[rows, :, dest] = v
    ck, cv = ck_all[:, :, :max_len], cv_all[:, :, :max_len]
    if c == 1:
        return decode_attention(q[:, 0], ck, cv, positions)[:, None]
    if c <= MAX_FUSED_DECODE_CHUNK:
        return decode_attention_multi(q, ck, cv, positions)
    return _ragged_attend(q, ck, cv, cols, attn_mask)


def _paged_attend(q, k, v, positions, block_table, cache, attn_mask):
    """Block-table cache write at ``positions[b] + j``, then attention
    over each row's prefix through the table.

    A column whose table entry is the sentinel, or past the table span,
    writes to the scratch block; it is never clamped onto the row's last
    real block, where it would overwrite live K/V.  A quantized pool
    encodes the chunk here (``quantize_kv``) and stores the scales beside
    the payload.  Dispatch: C = 1 → ``paged_decode_attention``; C <= 8 →
    ``paged_decode_attention_multi``; C <= MAX_FUSED_PREFILL_CHUNK →
    ``paged_prefill_attention``; wider chunks gather the window through
    the table (dequantized when quantized) for the ragged path."""
    quant = cache_quant(cache)
    ck, cv = cache[0], cache[1]
    b, c, h, dh = q.shape
    num_blocks, bs = ck.shape[0] - 1, ck.shape[2]
    nb = block_table.shape[1]
    cols = positions[:, None].long() + torch.arange(c, device=q.device)
    tbl_idx = cols // bs
    rows = torch.arange(b, device=q.device)[:, None]
    blk = torch.where(
        tbl_idx < nb, block_table[rows, tbl_idx.clamp(max=nb - 1)].long(),
        num_blocks,
    )
    off = cols % bs
    qkw = {}
    if quant is not None:
        k, k_sc = quantize_kv(k, quant)          # (B, C, H, Dh'), (B, C, H)
        v, v_sc = quantize_kv(v, quant)
        cache[2][blk, :, off] = k_sc
        cache[3][blk, :, off] = v_sc
        qkw = dict(k_scale=cache[2], v_scale=cache[3], quant=quant)
    # Indexing (blk, :, off) selects (B, C, H, Dh') — the chunk's layout.
    ck[blk, :, off] = k
    cv[blk, :, off] = v
    safe_table = block_table.clamp(max=num_blocks - 1)
    if c == 1:
        return paged_decode_attention(
            q[:, 0], ck, cv, safe_table, positions, **qkw
        )[:, None]
    if c <= MAX_FUSED_DECODE_CHUNK:
        return paged_decode_attention_multi(
            q, ck, cv, safe_table, positions, **qkw
        )
    if c <= MAX_FUSED_PREFILL_CHUNK:
        return paged_prefill_attention(
            q, ck, cv, safe_table, positions, **qkw
        )
    kk, vv = paged_window(ck, cv, safe_table, **qkw)
    return _ragged_attend(q, kk, vv, cols, attn_mask)


def _ragged_attend(q, ck, cv, cols, attn_mask):
    """(B, H, C, L) scores over the cache; query j of row b (global
    position cols[b, j]) sees keys 0..cols[b, j].  f32 scores and softmax,
    probabilities cast to the cache dtype, f32 accumulation."""
    dh = q.shape[-1]
    max_len = ck.shape[2]
    scores = torch.einsum("bqhd,bhkd->bhqk", q.float(), ck.float()) * dh ** -0.5
    if attn_mask is None:
        attn_mask = (
            torch.arange(max_len, device=q.device)[None, None, :]
            <= cols[:, :, None]
        )
    scores = scores.masked_fill(
        ~attn_mask[:, None], torch.finfo(torch.float32).min
    )
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bhqk,bhkd->bqhd", probs.float(), cv.float())
    return out.to(q.dtype)
