"""Sampling and lockstep generation for the GPT-2 family: the counterpart
of the JAX package's ``models/generate.py``.

``generate`` feeds one token per tick for every row (prompts teacher-
forced, so prefill and decode share one path), through the slot-mode KV
cache with every row at the same position.  Top-k is always exact here:
the approximate top-k of the JAX package is a TPU-only operation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


def filter_logits(logits, *, temperature, top_k=None):
    """Temperature scaling + top-k filtering over the last axis.  Shared by
    ``sample_logits`` and the serving engine's speculative verify, whose
    acceptance probabilities must use the same distribution.  Greedy
    callers argmax the raw logits instead."""
    if temperature <= 0.0:
        raise ValueError("filter_logits needs temperature > 0 (greedy is argmax)")
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, torch.finfo(logits.dtype).min)
    return logits


def draw_categorical(probs, generator=None):
    """One draw a row from (B, V) non-negative weights, as int64 (B,):
    ``torch.multinomial(probs, 1, generator=generator)[:, 0]``'s own
    one-sample route, the exponential race argmax(p / E) with E ~ Exp(1)
    from ``generator``, so the draws are its draws.  Without its validity
    check, which reads the weights back to the host and so cannot run
    inside a captured CUDA graph."""
    race = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / race, dim=-1)


def sample_logits(logits, generator=None, *, temperature=1.0, top_k=None):
    """Token ids (int64) from (B, V) logits.  ``temperature=0`` or
    ``top_k=1`` is greedy argmax; otherwise a draw from ``generator``."""
    if temperature == 0.0 or top_k == 1:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits, temperature=temperature, top_k=top_k)
    probs = torch.softmax(logits.float(), dim=-1)
    return draw_categorical(probs, generator)


def eos_cut_length(tokens, eos_token_id) -> int:
    """How many tokens of a proposed emission to keep: everything up to
    and including the first EOS, all of them when EOS is absent or None."""
    tokens = np.asarray(tokens)
    if eos_token_id is None:
        return int(tokens.size)
    hits = np.nonzero(tokens == eos_token_id)[0]
    return int(hits[0]) + 1 if hits.size else int(tokens.size)


@torch.no_grad()
def generate(model, prompt, *, max_new_tokens: int, generator=None,
             prompt_lengths=None, temperature: float = 1.0, top_k=None,
             eos_token_id=None, device=None):
    """Generate up to position ``P + max_new_tokens`` for every row.

    ``prompt``: (B, P) int tokens (right-padded if ragged, with
    ``prompt_lengths`` (B,) giving each row's length).  A row starts
    sampling right after its own prompt.  With ``eos_token_id`` set, a row
    writes its EOS and then stops (later positions keep the buffer's
    contents) and the return is ``(tokens, gen_lengths)``; otherwise
    ``tokens`` (B, P + max_new_tokens) int64.  ``device`` defaults to CUDA;
    the model is moved there.
    """
    device = resolve_device(device)
    model = model.to(device).eval()
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long)
    b, p = prompt.shape
    total = p + max_new_tokens
    if total > model.cfg.max_seq_len:
        raise ValueError(
            f"prompt ({p}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"model's max_seq_len ({model.cfg.max_seq_len})"
        )
    if prompt_lengths is None:
        lengths = torch.full((b,), p, dtype=torch.long, device=device)
    else:
        lengths = torch.as_tensor(
            np.asarray(prompt_lengths), dtype=torch.long
        ).to(device)
    cache = model.new_cache(b, total)
    tokens = torch.zeros((b, total), dtype=torch.long, device=device)
    tokens[:, :p] = prompt.to(device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    gen_len = torch.zeros((b,), dtype=torch.long, device=device)
    for i in range(total - 1):
        positions = torch.full((b,), i, dtype=torch.int32, device=device)
        logits = model(tokens[:, i:i + 1], cache=cache, positions=positions)
        sampled = sample_logits(
            logits[:, 0], generator, temperature=temperature, top_k=top_k
        )
        # Prompt positions stay teacher-forced; finished rows stop writing.
        generating = (i + 1 >= lengths) & ~done
        tokens[:, i + 1] = torch.where(generating, sampled, tokens[:, i + 1])
        gen_len += generating.long()
        if eos_token_id is not None:
            done |= generating & (sampled == eos_token_id)
    if eos_token_id is None:
        return tokens
    return tokens, gen_len
