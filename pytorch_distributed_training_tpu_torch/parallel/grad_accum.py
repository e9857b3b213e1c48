"""Gradient accumulation over microbatches: the counterpart of the JAX
package's ``parallel/grad_accum.py`` (there a ``lax.scan`` inside the
jitted step, here a Python loop of forward/backward passes).

``sync_fn`` is the explicit cross-rank sync.  Two contracts:

- the one all-reduce of data parallelism (``sync_carry=None``): one call
  after the microbatch loop on the f32 gradient sums and the loss and
  aux values, before the cast to the parameter dtype;
- JAX's (``sync_carry`` given, the two-tier sync of
  ``comm/hierarchical.py``): the gradients alone, threading the carry
  (its error-feedback residuals), once after the loop or, with
  ``sync_overlap``, once per microbatch, microbatch ``i-1``'s in flight
  while microbatch ``i`` computes.
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


def tree_leaves(tree) -> list:
    """The tensors of nested dicts and tuples, in order."""
    out: list = []
    _tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves: list):
    """``tree`` with its tensors replaced by ``leaves``, in order."""
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _synced(sync_fn, grads: list, value):
    """One ``sync_fn`` call over the f32 grads and the value's leaves."""
    values = [v.float() for v in tree_leaves(value)]
    out, _ = sync_fn([g.float() for g in grads] + values, None)
    return out[:len(grads)], tree_unflatten(value, out[len(grads):])


def accumulate_gradients(
    loss_fn: Callable[..., Any],
    params: dict,
    batch: dict,
    num_microbatches: int,
    *,
    has_aux: bool = False,
    pass_microbatch_index: bool = False,
    sync_fn: Callable[[list, Any], tuple[list, Any]] | None = None,
    sync_carry: Any = None,
    sync_overlap: bool = True,
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

    ``sync_fn(tensors, carry) -> (tensors, carry)`` syncs f32 tensors
    across ranks.  With ``sync_carry=None`` (``comm.collectives.pmean``
    over a process group, which keeps no state) it is called once per
    step on the gradient sums (at one microbatch the gradients as
    computed, in f32), then the loss and aux leaves; its results replace
    them before the 1/N scale and the cast.  One call, so a
    data-parallel step makes one all-reduce.

    With a ``sync_carry`` (JAX's contract; ``()`` for a sync without
    state) it gets the f32 gradients alone, the loss and aux values are
    left to the caller, and the return gains a third element, the final
    carry.  Without ``sync_overlap`` one sync runs on the accumulated
    sums after the loop (DDP's ``no_sync`` accumulation).  With it,
    microbatch ``i-1``'s gradients are synced while microbatch ``i``
    computes: ``sync_fn(tensors, carry, async_op=True)`` issues the sync
    and returns a handle whose ``wait()`` gives ``(tensors, carry)``,
    waited on after the compute; each synced tree is added to the
    accumulator and the last one is synced after the loop.  One
    microbatch syncs once either way.
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

    def cast(grads):
        return {n: g.to(p.dtype) for n, g, p in zip(names, grads, leaves)}

    if sync_fn is not None and sync_carry is not None:
        return _accumulate_carrying(call, cast, batch, num_microbatches,
                                    leaves, sync_fn, sync_carry,
                                    sync_overlap)
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


def _accumulate_carrying(call, cast, batch, num_microbatches, leaves,
                         sync_fn, carry, overlap):
    """JAX's carrying sync (``accumulate_gradients``'s docstring)."""
    def f32(tensors):
        return [t.float() for t in tensors]

    if num_microbatches <= 1:
        value, grads = call(batch, 0)
        synced, carry = sync_fn(f32(grads), carry)
        return value, cast(synced), carry
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    total = pending = None
    for i, mb in enumerate(_split_microbatches(batch, num_microbatches)):
        # Microbatch i-1's sync is issued, microbatch i computes while it
        # is in flight, then the sync completes.
        handle = (sync_fn(pending, carry, async_op=True)
                  if pending is not None else None)
        value, grads = call(mb, i)
        if handle is not None:
            synced, carry = handle.wait()
            for a, g in zip(acc, synced):
                a.add_(g)
        value = _tree_map(lambda v: v.float(), value)
        total = value if total is None else _tree_map(torch.add, total,
                                                      value)
        if overlap:
            pending = f32(grads)
        else:
            for a, g in zip(acc, grads):
                a.add_(g)
    if overlap:
        synced, carry = sync_fn(pending, carry)
        for a, g in zip(acc, synced):
            a.add_(g)
    else:
        acc, carry = sync_fn(acc, carry)
    inv = 1.0 / num_microbatches
    return (_tree_map(lambda v: v * inv, total),
            cast([a * inv for a in acc]), carry)
