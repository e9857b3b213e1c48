"""Loss functions: the counterpart of the JAX package's ``ops/losses.py``.

Softmax cross-entropy over integer labels with mean reduction, computed in
f32 from possibly-bf16 logits, and the chunked LM cross-entropy that never
holds the (B, T, vocab) logits.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def softmax_cross_entropy_with_logits(logits, labels):
    """Per-example softmax CE.  logits: (..., C) any float dtype; labels:
    (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - label_logits


def _smoothed(per_example, logits, label_smoothing: float):
    smooth = -torch.log_softmax(logits.float(), dim=-1).mean(dim=-1)
    return (1.0 - label_smoothing) * per_example + label_smoothing * smooth


def cross_entropy_loss(logits, labels, *, label_smoothing: float = 0.0):
    """Mean-reduced CE with optional label smoothing."""
    per_example = softmax_cross_entropy_with_logits(logits, labels)
    if label_smoothing > 0.0:
        per_example = _smoothed(per_example, logits, label_smoothing)
    return per_example.mean()


def chunked_lm_cross_entropy(hidden, embedding, targets, *,
                             chunk_size: int = 128,
                             label_smoothing: float = 0.0):
    """Mean LM cross-entropy without the (B, T, V) logits.

    ``hidden``: (B, T, D) final hidden states; ``embedding``: (V, D) LM-head
    matrix; ``targets``: (B, T) int labels.  T is cut into chunks of
    ``chunk_size``; each chunk's head matmul and CE run under
    ``torch.utils.checkpoint``, so the backward recomputes the chunk's
    logits instead of keeping them.  A padded tail is weighted 0; the sum
    is divided by B·T.
    """
    b, t, _ = hidden.shape
    n_chunks = -(-t // chunk_size)
    pad = n_chunks * chunk_size - t
    weights = torch.ones((b, t), dtype=torch.float32, device=hidden.device)
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        weights = torch.nn.functional.pad(weights, (0, pad))

    def chunk_sum(h, tgt, w, emb):
        # f32 logits from the compute-dtype operands, unrounded, as JAX's
        # preferred_element_type=f32 gives them: the products of bf16
        # values are exact in f32.
        logits = torch.einsum("bcd,vd->bcv", h.float(), emb.float())
        per = softmax_cross_entropy_with_logits(logits, tgt)
        if label_smoothing > 0.0:
            per = _smoothed(per, logits, label_smoothing)
        return (per * w).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * chunk_size, (c + 1) * chunk_size)
        total = total + checkpoint(
            chunk_sum, hidden[:, sl], targets[:, sl], weights[:, sl],
            embedding, use_reentrant=False,
        )
    return total / (b * t)
