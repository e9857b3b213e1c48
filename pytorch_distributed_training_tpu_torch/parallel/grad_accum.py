"""Gradient accumulation over microbatches: the counterpart of the JAX
package's ``parallel/grad_accum.py`` (there a ``lax.scan`` inside the
jitted step, here a Python loop of forward/backward passes).

``sync_fn`` is the explicit cross-rank sync (data parallelism): applied
once, after the microbatch loop, to the f32 accumulated gradients (and
the loss and aux values) before the cast to the parameter dtype.  The
JAX version can also overlap it with the next microbatch
(``sync_overlap``) and carries error-feedback state (``sync_carry``);
both wait for the communication slice.
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


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of nested dicts and tuples (aux values)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def _leaves(tree) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _synced(sync_fn, grads: list, value):
    """One ``sync_fn`` call over the f32 grads and the value's leaves."""
    values = [v.float() for v in _leaves(value)]
    out = sync_fn([g.float() for g in grads] + values)
    return out[:len(grads)], _unflatten(value, out[len(grads):])


def accumulate_gradients(
    loss_fn: Callable[..., Any],
    params: dict,
    batch: dict,
    num_microbatches: int,
    *,
    has_aux: bool = False,
    pass_microbatch_index: bool = False,
    sync_fn: Callable[[list], list] | None = None,
):
    """Mean loss and grads of ``loss_fn`` over ``num_microbatches`` splits.

    ``loss_fn(params, microbatch)`` → scalar loss tensor, or with
    ``has_aux`` ``(loss, aux)``, aux a nested dict of tensors; with
    ``pass_microbatch_index`` it is called as ``loss_fn(params,
    microbatch, i)`` so per-microbatch randomness differs.  Returns
    ``(loss, grads)`` or ``((loss, aux), grads)``, grads a dict keyed like
    ``params``, as ``jax.value_and_grad`` does.

    Over several microbatches the loss and every aux value are averaged in
    f32 (the ResNet step's new BatchNorm statistics: each microbatch's
    from the same old ones, so their mean is what the step stores).
    Gradients accumulate in f32 whatever the parameter dtype (N bf16 adds
    would lose bits), are scaled by 1/N after the sum and cast like the
    params.  With one microbatch everything is returned as computed.

    ``sync_fn(tensors) -> tensors`` (``comm.collectives.pmean`` over a
    process group) is called once per step on a list of f32 tensors: the
    gradient sums (at one microbatch the gradients as computed, in f32),
    then the loss and aux leaves; its results replace them before the
    1/N scale and the cast.  One call, so a data-parallel step makes one
    all-reduce.
    """
    names = list(params)
    leaves = [params[n] for n in names]

    def call(mb, i):
        out = loss_fn(params, mb, i) if pass_microbatch_index \
            else loss_fn(params, mb)
        loss, aux = out if has_aux else (out, None)
        value = (loss.detach(), _tree_map(torch.Tensor.detach, aux)) \
            if has_aux else loss.detach()
        return value, torch.autograd.grad(loss, leaves)

    if num_microbatches <= 1:
        value, grads = call(batch, 0)
        if sync_fn is not None:
            grads, value = _synced(sync_fn, list(grads), value)
            grads = [g.to(p.dtype) for g, p in zip(grads, leaves)]
        return value, dict(zip(names, grads))

    acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    total = None
    for i, mb in enumerate(_split_microbatches(batch, num_microbatches)):
        value, grads = call(mb, i)
        for a, g in zip(acc, grads):
            a.add_(g)
        value = _tree_map(lambda v: v.float(), value)
        total = value if total is None else _tree_map(torch.add, total,
                                                      value)
    if sync_fn is not None:
        acc, total = _synced(sync_fn, acc, total)
    inv = 1.0 / num_microbatches
    return (_tree_map(lambda v: v * inv, total),
            {n: (a * inv).to(p.dtype) for n, a, p in zip(names, acc, leaves)})
