"""Parameter placement: the data-parallel part of the JAX package's
``parallel/sharding.py``, whose ``DDP_RULES`` replicate every array.

Here replication is ``replicate_state``: rank 0's parameters, batch
statistics and optimizer slots are broadcast to every rank once, at the
start, which is ``DistributedDataParallel``'s constructor broadcast.
From there every rank applies the same all-reduced gradients and stays
bit-identical.

The model is not wrapped in ``torch.nn.parallel.DistributedDataParallel``:
the train step takes its gradients with ``torch.autograd.grad`` on a
functional call (``parallel/grad_accum.py``), and DDP's reducer hooks,
which fire on ``.grad`` accumulation in ``backward()``, never would.  The
step all-reduces the gradients itself (``comm.collectives.pmean``).  The
FSDP and tensor-parallel rules wait for the model-parallel slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..comm import collectives


def _tensors(tree: Any) -> list[torch.Tensor]:
    """The tensors of an optimizer state: nested tuples, lists, dicts and
    dataclasses, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _tensors(item)]
    return []


def replicate_state(state, group):
    """Broadcast rank 0's ``state`` (a ``TrainState``) over ``group`` in
    place; returns it."""
    collectives.broadcast(
        [*state.params.values(), *state.batch_stats.values(),
         *_tensors(state.opt_state)], group)
    return state
