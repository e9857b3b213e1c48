"""Transformer self-attention with the contiguous KV-cache decode mode.

Counterpart of the JAX package's ``models/layers.py::SelfAttention``,
limited to what the serving slice runs:

- the causal full-sequence forward (``cache=None``);
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

The paged cache, quantized KV, and the tensor- and sequence-parallel
paths are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.decode_attention import decode_attention, decode_attention_multi

# Widest chunk the fused multi-query decode kernel takes (the speculative
# verify step's k+1 tokens per slot); wider chunks (prefill) take the
# plain ragged path, as in the JAX package.  Which side of this line is
# faster on the H100 has not been measured yet.
MAX_FUSED_DECODE_CHUNK = 8


def new_kv_cache(batch: int, num_heads: int, length: int, head_dim: int, *,
                 dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer's zeroed (k, v) cache for ``length`` positions plus the
    scratch row that takes dropped writes."""
    shape = (batch, num_heads, length + 1, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


class SelfAttention(nn.Module):
    """Fused-QKV multi-head self-attention over (B, L, D)."""

    def __init__(self, hidden_dim: int, num_heads: int, *, causal: bool = True,
                 device=None, dtype=None):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(
                f"hidden_dim {hidden_dim} is not divisible by "
                f"num_heads {num_heads}"
            )
        self.num_heads = num_heads
        self.causal = causal
        kw = dict(device=device, dtype=dtype)
        self.qkv = nn.Linear(hidden_dim, 3 * hidden_dim, **kw)
        self.proj = nn.Linear(hidden_dim, hidden_dim, **kw)

    def forward(self, x, *, cache=None, positions=None, attn_mask=None):
        """``cache``: (k, v) from ``new_kv_cache``, updated in place, with
        ``positions`` (B,) int32 the chunk start of each row.
        ``attn_mask`` (B, C, L) bool is the validity the caller computes
        once per tick; only the ragged path (chunks wider than the fused
        kernel) reads it."""
        b, l, d = x.shape
        h = self.num_heads
        # Columns split as (3, H, Dh): q is columns 0..d-1, as in the JAX
        # package's decode split.
        q, k, v = self.qkv(x).view(b, l, 3, h, d // h).unbind(2)
        if cache is None:
            if positions is not None:
                raise ValueError("positions need a KV cache")
            out = dot_product_attention(q, k, v, causal=self.causal)
        else:
            if positions is None:
                raise ValueError("a KV cache needs positions")
            out = _slot_attend(q, k, v, positions, cache, attn_mask)
        return self.proj(out.reshape(b, l, d))


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
