"""Collective operations over a process group: the part of the JAX
package's ``comm/collectives.py`` that data parallelism needs (``psum``,
``pmean``, ``broadcast``, ``barrier``), over a ``torch.distributed``
``ProcessGroup`` where JAX names a mesh axis.

The reference's two collectives hide inside DDP: the construction-time
parameter broadcast (``src/main.py:53``) and the gradient all-reduce in
``backward()`` (``src/main.py:78``).  Here both are explicit calls, on
NCCL for CUDA tensors or gloo (which also takes CUDA tensors, staged
through the host).  ``all_gather``, ``reduce_scatter``, ``ppermute`` and
``all_to_all`` wait for the communication slice.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

F32 = torch.float32


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place; returns ``x``."""
    dist.all_reduce(x, group=group)
    return x


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
