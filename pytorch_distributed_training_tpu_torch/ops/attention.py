"""Full-sequence attention: the counterpart of the JAX package's
``ops/attention.py::_xla_attention``.  Layout (B, L, H, D) throughout.

The flash-attention kernels that the JAX package dispatches to on the TPU
are not ported yet; this plain version is the only path here.
"""

from __future__ import annotations

import torch


def dot_product_attention(q, k, v, *, causal: bool = False, scale=None):
    """q/k/v: (B, L, H, D) → (B, L, H, D).

    f32 inputs keep an f32 chain.  bf16 inputs follow the reference's
    low-precision path: the score matmul and scale are bf16, the softmax
    runs in f32 and its probabilities are stored in bf16.
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
    weights = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    if causal and k_len < q_len:
        # Query rows with no visible key are zero (softmax alone would
        # spread them uniformly over masked keys).
        weights = weights * mask.any(dim=-1)[None, None, :, None]
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
