"""TrainState: the training state of the JAX package's ``train/state.py``
— step, parameters, optimizer state, BatchNorm running statistics — with
``apply_gradients``.

Data parallelism replicates the state: ``create_train_state`` with a
process group broadcasts rank 0's (``parallel/sharding.py``), and every
rank then applies the same all-reduced gradients.  The parameters are
the model's own master tensors and ``batch_stats`` its buffers (the
ResNets' running ``mean``/``var``, f32 under every policy; empty for
GPT-2 and the ViTs); ``apply_gradients`` updates them and the optimizer
state in place (one copy of each, where JAX returns new arrays) and
returns the state with the step advanced.  The step is a host integer:
nothing reads it back from the device.  ``apply_gradients(..., ok=...)``
is the anomaly gate's form (``resilience/anomaly.py``): every tensor it
would update changes only where the 0-dim device bool ``ok`` holds, and
the step advances either way.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..ops.fused_norm import master_affine_params
from ..parallel.sharding import replicate_state
from .optim import Transform, select_
from .policy import Policy


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict            # name -> master parameter (a leaf tensor)
    opt_state: Any
    model: nn.Module        # the module the parameters belong to
    tx: Transform
    batch_stats: dict = dataclasses.field(default_factory=dict)
    # Parameters the step hands the model uncast: the fused BatchNorms'
    # f32 master scale/bias, which round themselves (ops/fused_norm.py).
    keep: frozenset = frozenset()
    # The anomaly gate's device counters (resilience/anomaly.py:
    # ResilienceState) when the policy is on; empty otherwise.
    resilience: Any = ()

    def apply_gradients(self, grads: dict, batch_stats: dict | None = None,
                        ok: torch.Tensor | None = None) -> "TrainState":
        """One optimizer update; ``batch_stats`` (name -> tensor), when
        given, becomes the new running statistics.  With ``ok`` (a 0-dim
        bool device tensor) the parameters, the optimizer state and the
        statistics change only where it holds."""
        names = list(self.params)
        params = [self.params[n] for n in names]
        # Outside autograd: the decayed-weight term reads the parameters,
        # and an in-place moment update would otherwise join the graph.
        with torch.no_grad():
            updates, opt_state = self.tx.update(
                [grads[n] for n in names], self.opt_state, params, ok=ok
            )
            if ok is None:
                torch._foreach_add_(params, updates)
            else:
                select_(ok, torch._foreach_add(params, updates), params)
            for name, value in (batch_stats or {}).items():
                if ok is None:
                    self.batch_stats[name].copy_(value)
                else:
                    select_(ok, [value], [self.batch_stats[name]])
        return dataclasses.replace(self, step=self.step + 1,
                                   opt_state=opt_state)


def create_train_state(model: nn.Module, tx: Transform, *,
                       policy: Policy | None = None,
                       process_group: Any = None) -> TrainState:
    """Cast ``model``'s parameters to the policy's parameter dtype (its
    buffers, the running statistics, stay f32) and wrap them with a fresh
    optimizer state; with a ``process_group``, rank 0's state replaces
    every rank's."""
    policy = policy or Policy()
    for p in model.parameters():
        p.data = p.data.to(policy.param_dtype)
    params = dict(model.named_parameters())
    state = TrainState(step=0, params=params,
                       opt_state=tx.init(list(params.values())),
                       model=model, tx=tx,
                       batch_stats=dict(model.named_buffers()),
                       keep=frozenset(master_affine_params(model)))
    if process_group is not None:
        replicate_state(state, process_group)
    return state
