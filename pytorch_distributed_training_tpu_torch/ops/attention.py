"""Full-sequence attention: the counterpart of the JAX package's
``ops/attention.py``.  Layout (B, L, H, D) throughout.

``dot_product_attention`` is the public entry: it takes the hand-written
flash kernels (``ops/flash_attention.py``) on the card when the shapes
call for them, else the plain ``_xla_attention`` counterpart, with the
JAX package's ``PDT_FORCE_ATTN`` override (``flash`` / ``xla`` /
``xla_remat``) for A/B runs.
"""

from __future__ import annotations

import functools
import os

import torch
from torch.utils.checkpoint import checkpoint

from . import flash_attention as _flash


class SoftmaxLowp(torch.autograd.Function):
    """Softmax over the last axis computed in f32 that saves only the
    low-precision output for the backward (JAX ``_softmax_lowp``): the
    gradient ``dl = w * (dw - sum(dw * w))`` is evaluated in f32 from the
    saved bf16 w, and returned in w's dtype."""

    @staticmethod
    def forward(ctx, logits):
        w = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        ctx.save_for_backward(w)
        return w

    @staticmethod
    def backward(ctx, dw):
        (w,) = ctx.saved_tensors
        w32, dw32 = w.float(), dw.float()
        dl = w32 * (dw32 - (dw32 * w32).sum(dim=-1, keepdim=True))
        return dl.to(w.dtype)


def _xla_attention(q, k, v, *, causal: bool = False, scale=None):
    """Plain attention, q/k/v: (B, L, H, D) → (B, L, H, D).

    f32 inputs keep an f32 chain.  bf16 inputs follow the reference's
    low-precision path: the score matmul and scale are bf16, the softmax
    runs in f32 and saves its probabilities in bf16 (``SoftmaxLowp``).
    """
    q_len, head_dim = q.shape[1], q.shape[3]
    k_len = k.shape[1]
    scale = head_dim ** -0.5 if scale is None else scale
    lowp = q.dtype == torch.bfloat16
    if lowp:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * torch.tensor(
            scale, dtype=q.dtype
        )
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        mask = torch.ones(q_len, k_len, dtype=torch.bool, device=q.device)
        mask = torch.tril(mask, diagonal=k_len - q_len)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    if lowp:
        weights = SoftmaxLowp.apply(logits)
    else:
        weights = torch.softmax(logits, dim=-1)
    if causal and k_len < q_len:
        # Query rows with no visible key are zero (softmax alone would
        # spread them uniformly over masked keys).
        weights = weights * mask.any(dim=-1)[None, None, :, None]
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


def _xla_attention_remat(q, k, v, *, causal: bool = False, scale=None):
    """``_xla_attention`` with its internals recomputed in the backward:
    only q, k and v are saved, never the (B, H, L, L) chain."""
    fn = functools.partial(_xla_attention, causal=causal, scale=scale)
    return checkpoint(fn, q, k, v, use_reentrant=False)


def flash_attention(q, k, v, *, causal: bool = False, scale=None):
    """Flash attention through the hand-written kernels (their plain
    versions for CPU tensors).  The JAX entry's ``block_q``/``block_k``
    and ``PDT_FLASH_BLOCK_Q/K`` pick TPU tile sizes; the card's kernels
    tile by 64 at every length, so they have no counterpart here."""
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale)


def _forced() -> str:
    forced = os.environ.get("PDT_FORCE_ATTN", "").lower()
    if forced not in ("", "flash", "xla", "xla_remat"):
        raise ValueError(
            f"PDT_FORCE_ATTN={forced!r}: expected 'flash', 'xla' or "
            "'xla_remat' (a typo here would silently A/B the default path "
            "twice)"
        )
    return forced


def flash_preferred(q_len: int, k_len: int, head_dim: int, *,
                    device) -> bool:
    """Whether ``dot_product_attention``'s auto dispatch takes the flash
    kernels for these shapes: the JAX package's size rule (q_len >= 256,
    k_len >= 64, head_dim >= 64), with "the tensors lie on CUDA" in the
    place of "the backend is a TPU", and the ``PDT_FORCE_ATTN`` override.
    ``meta`` tensors (the flop probe of ``obs/cost.py``) route as CUDA
    ones do, so the probe counts the kernels the card runs.

    The JAX version also consults the VMEM-fit rules
    (``native_layout_selected``) when told ``num_heads``; they only pick
    a TPU tiling and a qkv column split that selects the same elements,
    so nothing on the card corresponds to them.  The thresholds are the
    TPU's; the H100's own have not been measured."""
    forced = _forced()
    if forced in ("xla", "xla_remat"):
        return False
    if forced == "flash":
        return True
    return (torch.device(device).type in ("cuda", "meta") and q_len >= 256
            and k_len >= 64 and head_dim >= 64)


def dot_product_attention(q, k, v, *, causal: bool = False, scale=None,
                          use_flash: bool | None = None):
    """Public attention entry.  q/k/v: (B, L, H, D) → (B, L, H, D).
    ``use_flash=None`` auto-selects (``flash_preferred``)."""
    if use_flash is None:
        forced = _forced()
        if forced == "flash":
            return flash_attention(q, k, v, causal=causal, scale=scale)
        if forced == "xla":
            return _xla_attention(q, k, v, causal=causal, scale=scale)
        if forced == "xla_remat":
            return _xla_attention_remat(q, k, v, causal=causal, scale=scale)
        use_flash = flash_preferred(q.shape[1], k.shape[1], q.shape[3],
                                    device=q.device)
    if use_flash:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return _xla_attention(q, k, v, causal=causal, scale=scale)
