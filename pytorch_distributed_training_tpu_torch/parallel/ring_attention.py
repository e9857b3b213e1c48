"""Ring attention: sequence-parallel exact attention over a process
group, the counterpart of the JAX package's
``parallel/ring_attention.py``.

Each rank of the ``sequence`` group holds one contiguous shard of the
sequence; its K/V shard is handed around the ring with the
differentiable ``ppermute`` (``comm.collectives.ppermute_grad``: the
backward sends the cotangents back along the inverse permutation), and
each hop's block is folded into a running (max, sum, unnormalized
output) triple in f32 — the online softmax — so the result matches full
attention to accumulation order whatever the ring's length.

As in JAX every step runs the same body: the last hop's permute is
issued too.  JAX wraps the hop in ``jax.checkpoint``; here each hop's
block and fold run under ``torch.utils.checkpoint``, so the backward
recomputes the hop's (B, H, Lq, Lk) probabilities instead of keeping
them, while the K/V shards handed around the ring stay saved (JAX's
scan carry keeps them too).  No Pallas kernel lies on this path in JAX
and no CUDA kernel here: it is plain PyTorch.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..comm.collectives import ppermute_grad

_NEG_INF = -1e30  # finite mask value: no (-inf) - (-inf) = nan in the max


def _block(q, k, v, q_off: int, k_off: int, *, causal: bool, scale: float):
    """One q-shard x k-shard block -> (unnormalized out, max, sum).
    q: (B, Lq, H, D), k/v: (B, Lk, H, D); the offsets are the shards'
    global positions, which orient the causal mask across the ring."""
    lq, lk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        q_pos = q_off + torch.arange(lq, device=q.device)
        k_pos = k_off + torch.arange(lk, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, _NEG_INF))
    m = logits.amax(dim=-1)                              # (B, H, Lq)
    p = torch.exp(logits - m[..., None])
    if causal:
        # Rows with every key masked (hops after this q shard) add nothing.
        p = torch.where(mask[None, None], p, torch.zeros_like(p))
    l = p.sum(dim=-1)                                    # (B, H, Lq)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o, m, l


def _hop(q, k, v, o, m, l, q_off, k_off, causal, scale):
    """Fold one hop's block into the running (o, m, l)."""
    o_b, m_b, l_b = _block(q, k, v, q_off, k_off, causal=causal, scale=scale)
    m_new = torch.maximum(m, m_b)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_b - m_new)
    l = l * alpha + l_b * beta
    o = (o * alpha.transpose(1, 2)[..., None]
         + o_b * beta.transpose(1, 2)[..., None])
    return o, m_new, l


def ring_attention(q, k, v, *, group, axis_size: int, axis_index: int,
                   causal: bool = False, scale: float | None = None):
    """Exact attention over sequence shards: q/k/v are this rank's
    (B, L/n, H, D) shard of a (B, L, H, D) sequence split over ``group``
    (``axis_size`` ranks, this one ``axis_index``, in sequence order).
    Returns this rank's (B, L/n, H, D) output in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, l_loc, h, d = q.shape
    q_off = axis_index * l_loc
    # Pass the shard to the previous neighbour: after i hops this rank
    # holds shard (axis_index + i) mod n.
    perm = [(j, (j - 1) % axis_size) for j in range(axis_size)]
    o = torch.zeros((b, l_loc, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, l_loc), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    lsum = torch.zeros((b, h, l_loc), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for i in range(axis_size):
        k_off = ((axis_index + i) % axis_size) * l_loc
        o, m, lsum = checkpoint(_hop, q, k_cur, v_cur, o, m, lsum, q_off,
                                k_off, causal, scale, use_reentrant=False)
        k_cur = ppermute_grad(k_cur, group, perm)
        v_cur = ppermute_grad(v_cur, group, perm)
    out = o / lsum.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_self_attention(q, k, v, parallel, *, causal: bool = False,
                        scale: float | None = None):
    """``ring_attention`` over a model's sequence group
    (``parallel/sharded.py::ModelParallel``); heads are whatever this
    rank holds (its tensor shard of them under tensor parallelism: ring
    attention is per-head math, so each rank rotates only its own
    heads' K/V)."""
    return ring_attention(q, k, v, group=parallel.sp_group,
                          axis_size=parallel.sp_size,
                          axis_index=parallel.sp_index, causal=causal,
                          scale=scale)
