"""Gradient accumulation over microbatches: the counterpart of the JAX
package's ``parallel/grad_accum.py`` (there a ``lax.scan`` inside the
jitted step, here a Python loop of forward/backward passes).

The explicit cross-device sync (``sync_fn``) waits for the communication
slice.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _split_microbatches(batch: dict, num_microbatches: int) -> list[dict]:
    """(N*m, ...) leaves → N dicts of (m, ...) views, in order."""
    for x in batch.values():
        if x.shape[0] % num_microbatches != 0:
            raise ValueError(
                f"batch dim {x.shape[0]} not divisible by "
                f"num_microbatches={num_microbatches}"
            )
    m = next(iter(batch.values())).shape[0] // num_microbatches
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(num_microbatches)]


def accumulate_gradients(
    loss_fn: Callable[..., Any],
    params: dict,
    batch: dict,
    num_microbatches: int,
    *,
    pass_microbatch_index: bool = False,
):
    """Mean loss and grads of ``loss_fn`` over ``num_microbatches`` splits.

    ``loss_fn(params, microbatch)`` → scalar loss tensor; with
    ``pass_microbatch_index`` it is called as ``loss_fn(params,
    microbatch, i)`` so per-microbatch randomness differs.  Returns
    ``(loss, grads)``, grads a dict keyed like ``params``, as
    ``jax.value_and_grad`` does (the JAX version's ``has_aux`` carries
    batch statistics and MoE losses, which no ported model sows).

    Gradients accumulate in f32 whatever the parameter dtype (N bf16 adds
    would lose bits), are scaled by 1/N after the sum and cast like the
    params.  With one microbatch they are returned as computed.
    """
    names = list(params)
    leaves = [params[n] for n in names]

    def call(mb, i):
        loss = loss_fn(params, mb, i) if pass_microbatch_index \
            else loss_fn(params, mb)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    if num_microbatches <= 1:
        loss, grads = call(batch, 0)
        return loss, dict(zip(names, grads))

    acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    total = None
    for i, mb in enumerate(_split_microbatches(batch, num_microbatches)):
        loss, grads = call(mb, i)
        for a, g in zip(acc, grads):
            a.add_(g)
        total = loss.float() if total is None else total + loss.float()
    inv = 1.0 / num_microbatches
    return total * inv, {n: (a * inv).to(p.dtype)
                         for n, a, p in zip(names, acc, leaves)}
