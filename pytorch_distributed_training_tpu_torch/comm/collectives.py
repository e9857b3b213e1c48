"""Collective operations over a process group: the JAX package's
``comm/collectives.py`` (``psum``, ``pmean``, ``all_gather``,
``reduce_scatter``, ``ppermute``, ``all_to_all``, ``broadcast``,
``barrier``) over a ``torch.distributed`` ``ProcessGroup`` where JAX
names a mesh axis; ``new_group`` refuses what JAX's axis check refuses.

The reference's two collectives hide inside DDP: the construction-time
parameter broadcast (``src/main.py:53``) and the gradient all-reduce in
``backward()`` (``src/main.py:78``).  Here both are explicit calls, on
NCCL for CUDA tensors or gloo.  The gather, scatter and all-to-all are
tiled as JAX's are (``tiled=True``).  ``all_gather``, ``reduce_scatter``,
``ppermute`` and ``psum`` take ``async_op=True`` and then return a
:class:`Pending` whose ``wait()`` gives the result (the pipelined bucket
walk of ``comm/striping.py`` issues a wave's collectives that way).

**Differentiable forms.**  The train step takes its gradients with
``torch.autograd.grad`` on a functional call, so the sharded paths put
their collectives into the graph as ``torch.autograd.Function``s, each
with its transpose as the backward (JAX's ``shard_map`` transposes them
the same way): ``gather_sum`` (all-gather; backward reduce-scatter, for
a leaf gathered over ranks that compute different rows),
``gather_slice`` (all-gather; backward this rank's slice, for ranks that
compute the same values, the tensor group), ``all_to_all_grad`` (its
inverse all-to-all), ``ppermute_grad`` (the inverse permutation), and
Megatron's ``copy_to_group`` (``f``: identity, all-reduce backward) and
``reduce_from_group`` (``g``: all-reduce, identity backward).

Transport rules of the two backends:

- neither gloo nor NCCL has a 16-bit integer type, so an ``int16``
  tensor (the bit pattern of a bf16 payload, which the sync sends as
  integers as JAX bitcasts it to u16) moves as its ``uint8`` bytes in
  the data-movement collectives; a reduction of it is refused;
- gloo (torch 2.11, probed with CUDA tensors on an H100) runs the
  all-reduce, gather, reduce-scatter, all-to-all and broadcast on CUDA
  tensors, but its point-to-point send/recv does not: the process dies
  writing from a device pointer.  ``ppermute`` over a gloo group
  therefore stages a CUDA tensor through the host (copy out, send/recv,
  copy back).  Only a gloo group takes that branch; NCCL runs every call
  directly.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

F32 = torch.float32
# Dtypes the backends cannot carry, sent as their bytes.
_BYTE_WIRE = (torch.int16,)
# The tensor reduce-scatter under its newer name where torch has it.
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


class Pending:
    """An issued collective: ``wait()`` waits for its work handles and
    returns ``finish()``'s result (once)."""

    def __init__(self, works: Sequence, finish: Callable):
        self._works, self._finish = list(works), finish
        self._done, self._result = False, None

    def wait(self):
        if not self._done:
            for w in self._works:
                w.wait()
            self._result = self._finish()
            self._done = True
        return self._result


def _issued(works, finish, async_op: bool):
    pending = Pending([w for w in works if w is not None], finish)
    return pending if async_op else pending.wait()


def new_group(ranks: Sequence[int]):
    """``dist.new_group(ranks)``, refusing what JAX's axis check refuses:
    no members (a reduce over nobody would be the identity) or a member
    named twice (it would be counted twice).  Collective: every rank of
    the world calls it, in the same order."""
    ranks = list(ranks)
    if not ranks:
        raise ValueError("collective over an empty group: the reduce "
                         "would silently be the identity")
    if len(set(ranks)) != len(ranks):
        raise ValueError(f"duplicate ranks in {ranks}")
    return dist.new_group(ranks)


def _size(group) -> int:
    return dist.get_world_size(group)


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype in _BYTE_WIRE else x


def _from_wire(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.view(dtype) if dtype in _BYTE_WIRE else x


def _reducible(x: torch.Tensor) -> None:
    if x.dtype in _BYTE_WIRE:
        raise TypeError(f"no backend reduces {x.dtype}: it moves as bytes")


def psum(x: torch.Tensor, group, *, async_op: bool = False):
    """Sum ``x`` over ``group`` in place; returns ``x``."""
    _reducible(x)
    work = dist.all_reduce(x, group=group, async_op=async_op)
    return _issued([work], lambda: x, async_op)


def all_gather(x: torch.Tensor, group, *, gather_axis: int = 0,
               tiled: bool = True, async_op: bool = False):
    """Every member's ``x``, in group-rank order: concatenated along
    ``gather_axis`` (``tiled``) or stacked on a new axis there."""
    n = _size(group)
    moved = _to_wire(x.movedim(gather_axis, 0))
    out = moved.new_empty((n * moved.shape[0], *moved.shape[1:]))
    work = dist.all_gather_into_tensor(out, moved, group=group,
                                       async_op=async_op)

    def finish():
        y = _from_wire(out, x.dtype)
        if not tiled:
            return y.view(n, *x.movedim(gather_axis, 0).shape).movedim(
                1, gather_axis + 1).movedim(0, gather_axis)
        return y.movedim(0, gather_axis)

    return _issued([work], finish, async_op)


def reduce_scatter(x: torch.Tensor, group, *, scatter_axis: int = 0,
                   async_op: bool = False):
    """The sum over ``group``, of which group rank i keeps the i-th of
    ``size`` equal blocks along ``scatter_axis`` (ZeRO's
    reduce-scatter)."""
    _reducible(x)
    n = _size(group)
    if x.shape[scatter_axis] % n:
        raise ValueError(f"axis {scatter_axis} of {tuple(x.shape)} does not "
                         f"split into {n} blocks")
    moved = x.movedim(scatter_axis, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n, *moved.shape[1:]))
    work = _REDUCE_SCATTER(out, moved, group=group, async_op=async_op)
    return _issued([work], lambda: out.movedim(0, scatter_axis), async_op)


def _global(group, r: int) -> int:
    return dist.get_global_rank(group, r) if group is not None else r


def ppermute(x: torch.Tensor, group, perm: Sequence[tuple[int, int]], *,
             async_op: bool = False):
    """Point-to-point permutation: group rank ``src`` sends ``x`` to
    ``dst`` for each ``(src, dst)`` of ``perm``; a rank that receives
    nothing returns zeros, as ``lax.ppermute`` does.  One
    ``batch_isend_irecv``.  Over a gloo group a CUDA tensor is staged
    through the host (module docstring)."""
    perm = [(int(a), int(b)) for a, b in perm]
    srcs, dsts = [a for a, _ in perm], [b for _, b in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute perm {perm} repeats a source or a "
                         "destination")
    n = _size(group)
    if any(not 0 <= r < n for r in srcs + dsts):
        raise ValueError(f"ppermute perm {perm} names a rank outside a "
                         f"group of {n}")
    me = dist.get_rank(group)
    staged = (x.is_cuda
              and dist.get_backend(group) == dist.Backend.GLOO)
    device = x.device
    send = _to_wire(x.cpu() if staged else x)
    recv = torch.zeros_like(send)
    ops, local = [], False
    for a, b in perm:
        if a == me and b == me:
            local = True
        elif a == me:
            ops.append(dist.P2POp(dist.isend, send, _global(group, b),
                                  group))
        elif b == me:
            ops.append(dist.P2POp(dist.irecv, recv, _global(group, a),
                                  group))
    works = dist.batch_isend_irecv(ops) if ops else []
    if local:
        recv.copy_(send)

    def finish():
        y = _from_wire(recv, x.dtype)
        return y.to(device) if staged else y

    return _issued(works, finish, async_op)


def all_to_all(x: torch.Tensor, group, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Split ``x`` into ``size`` blocks along ``split_axis``, send block j
    to group rank j, and concatenate the blocks received along
    ``concat_axis`` in group-rank order (Ulysses' sequence <-> head
    reshard)."""
    n = _size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not "
                         f"split into {n} blocks")
    moved = _to_wire(x.movedim(split_axis, 0))
    out = torch.empty_like(moved)
    dist.all_to_all_single(out, moved, group=group)
    blocks = _from_wire(out, x.dtype).view(
        n, moved.shape[0] // n, *x.movedim(split_axis, 0).shape[1:])
    blocks = blocks.movedim(1, split_axis + 1)
    return torch.cat(blocks.unbind(0), dim=concat_axis)


def pmean(x, group):
    """The mean over ``group``: the gradient averaging DDP applies.

    A tensor is averaged in place and returned.  A list of tensors is
    copied into one f32 buffer, reduced by one ``all_reduce`` and divided
    by the world size; the result is a list of f32 views of that buffer,
    shaped like the inputs and in their memory format (a ``channels_last``
    gradient is flattened in its own memory order, with no transpose).
    The buffer is a fresh tensor each call: the caching
    allocator hands the same block back step after step, and no returned
    view aliases a later call's.
    """
    world = dist.get_world_size(group)
    if isinstance(x, torch.Tensor):
        return psum(x, group).div_(world)
    x = [t.to(F32) for t in x]
    flat = torch.cat([_memory_order(t) for t in x])
    psum(flat, group).div_(world)
    return [_like(v, t) for v, t in zip(flat.split([t.numel() for t in x]),
                                        x)]


def _channels_last(t: torch.Tensor) -> bool:
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


def _memory_order(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as a 1-D view in memory order (contiguous or
    ``channels_last``), else a contiguous copy."""
    if _channels_last(t):
        return t.permute(0, 2, 3, 1).reshape(-1)
    return t.reshape(-1)


def _like(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The 1-D ``v`` shaped like ``t``, in ``t``'s memory format."""
    if _channels_last(t):
        n, c, h, w = t.shape
        return v.view(n, h, w, c).permute(0, 3, 1, 2)
    return v.view(t.shape)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``psum`` as a differentiable function: a new tensor, whose
    backward sums the cotangents over ``group`` as well (each rank's
    cotangent is its own loss's; the sum is the total loss's)."""
    return _AllReduceSum.apply(x, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return psum(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return psum(dy.clone(), ctx.group), None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, gather_axis=dim)

    @staticmethod
    def backward(ctx, dy):
        # Summed in f32 and rounded once to the operand's dtype.
        out = reduce_scatter(dy.float(), ctx.group, scatter_axis=ctx.dim)
        return out.to(dy.dtype), None, None


class _GatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return all_gather(x, group, gather_axis=dim)

    @staticmethod
    def backward(ctx, dy):
        return (dy.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
                .contiguous(), None, None)


def gather_sum(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``group`` (tiled); the
    backward reduce-scatters the cotangent: each member's rows add into
    the gathered leaf's gradient (FSDP's gather at use)."""
    return _GatherSum.apply(x, group, dim)


def gather_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``group``; the backward keeps
    this rank's slice of the cotangent.  For a group whose members
    compute the same values from the gathered tensor (a tensor group
    using a leaf it does not consume sharded): summing their identical
    cotangents would count the gradient once a member."""
    return _GatherSlice.apply(x, group, dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return psum(dy.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: the identity, whose backward sums the cotangent
    over ``group`` (in front of a column-parallel layer)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: the sum over ``group``, whose backward is the
    identity (after a row-parallel layer)."""
    return _ReduceFromGroup.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return all_to_all(x, group, split_axis=split_axis,
                          concat_axis=concat_axis)

    @staticmethod
    def backward(ctx, dy):
        split_axis, concat_axis = ctx.axes
        return all_to_all(dy.contiguous(), ctx.group,
                          split_axis=concat_axis,
                          concat_axis=split_axis), None, None, None


def all_to_all_grad(x: torch.Tensor, group, *, split_axis: int,
                    concat_axis: int) -> torch.Tensor:
    """``all_to_all`` whose backward is the inverse all-to-all (split
    along ``concat_axis``, concatenate along ``split_axis``)."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, dy):
        inverse = [(b, a) for a, b in ctx.perm]
        return ppermute(dy.contiguous(), ctx.group, inverse), None, None


def ppermute_grad(x: torch.Tensor, group,
                  perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """``ppermute`` whose backward sends each cotangent back along the
    inverse permutation."""
    return _PPermute.apply(x, group, [(int(a), int(b)) for a, b in perm])


def broadcast(tensors: list[torch.Tensor], group, *, src: int = 0) -> None:
    """Overwrite ``tensors`` in place with the group's rank ``src``'s
    values: DDP's construction-time broadcast.  One collective per
    (device, dtype) over a flat copy."""
    root = dist.get_global_rank(group, src) if group is not None else src
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    with torch.no_grad():
        for bucket in buckets.values():
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.broadcast(flat, src=root, group=group)
            for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(v.view(t.shape))


def barrier(group=None) -> None:
    """Host-level barrier across the group's processes."""
    dist.barrier(group=group)
