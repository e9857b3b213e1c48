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
the step advances either way.  ``grad_sync_residual`` is the two-tier
sync's error-feedback residual (``comm/hierarchical.py``): a new tensor
each step, gated like the rest; it is not checkpointed (as in JAX).

Sharded state (``create_train_state(mesh=, rules=, opt_rules=)``, JAX's
``create_train_state(mesh=, rules=, opt_rules=)``): each rank keeps its
shard of each sharded parameter and slot (``parallel/sharded.py``), the
model's own parameters become those shards, and ``state.shardings``
holds the layout (``infer_state_shardings`` builds it), which
``apply_gradients`` follows: the update runs on the shards (or on the
slice of a replicated parameter its slots cover, then all-gathered),
and the clip's global norm sums over the shard groups.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..ops.fused_norm import master_affine_params
from ..parallel.sharding import DDP_RULES, replicate_state
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
    # Error-feedback residuals of the compressed two-tier gradient sync
    # (comm/hierarchical.py, --grad-sync hier-int8|int4|topk): this
    # rank's quantization error that the last sync did not transmit,
    # re-fed into the next.  Empty for every other sync mode.
    grad_sync_residual: Any = ()
    # The sharded layout (parallel/sharded.py::ShardedLayout), None when
    # the state is replicated.
    shardings: Any = None

    def apply_gradients(self, grads: dict, batch_stats: dict | None = None,
                        ok: torch.Tensor | None = None,
                        grad_sync_residual: Any = None) -> "TrainState":
        """One optimizer update; ``batch_stats`` (name -> tensor), when
        given, becomes the new running statistics, and
        ``grad_sync_residual`` the new residual.  With ``ok`` (a 0-dim
        bool device tensor) the parameters, the optimizer state, the
        statistics and the residual change only where it holds."""
        names = list(self.params)
        params = [self.params[n] for n in names]
        groups = finish = None
        if self.shardings is not None:
            groups = self.shardings.norm_groups(names)
            params, finish = self.shardings.update_views(names, params)
        # Outside autograd: the decayed-weight term reads the parameters,
        # and an in-place moment update would otherwise join the graph.
        with torch.no_grad():
            updates, opt_state = self.tx.update(
                [grads[n] for n in names], self.opt_state, params, ok=ok,
                groups=groups,
            )
            if ok is None:
                torch._foreach_add_(params, updates)
            else:
                select_(ok, torch._foreach_add(params, updates), params)
            if finish is not None:
                finish()
            for name, value in (batch_stats or {}).items():
                if ok is None:
                    self.batch_stats[name].copy_(value)
                else:
                    select_(ok, [value], [self.batch_stats[name]])
        residual = self.grad_sync_residual
        if isinstance(grad_sync_residual, torch.Tensor):
            residual = grad_sync_residual if ok is None else torch.where(
                ok, grad_sync_residual, residual)
        return dataclasses.replace(self, step=self.step + 1,
                                   opt_state=opt_state,
                                   grad_sync_residual=residual)


def infer_state_shardings(model: nn.Module, mesh, *, rules=DDP_RULES,
                          opt_rules=None, sp_mode: str = "ring"):
    """The sharded layout of ``model``'s training state on ``mesh`` (a
    ``comm.mesh.Mesh``): ``rules`` place the parameters, ``opt_rules``
    (default the same) the optimizer slots, as JAX's
    ``infer_state_shardings``; counts, the gate's counters and the
    running statistics stay replicated.  The step keeps the state in it
    (``make_train_step(state_shardings=...)``)."""
    from ..parallel.sharded import build_layout

    return build_layout(model, mesh, rules=rules, opt_rules=opt_rules,
                        sp_mode=sp_mode)


def create_train_state(model: nn.Module, tx: Transform, *,
                       policy: Policy | None = None,
                       process_group: Any = None, mesh: Any = None,
                       rules=DDP_RULES, opt_rules=None,
                       sp_mode: str = "ring") -> TrainState:
    """Cast ``model``'s parameters to the policy's parameter dtype (its
    buffers, the running statistics, stay f32) and wrap them with a fresh
    optimizer state; with a ``process_group``, rank 0's state replaces
    every rank's.

    With a ``mesh`` the state is sharded (module docstring): rank 0's
    parameters and statistics are broadcast over the world, each rank
    keeps its shards of them (the model's parameters become the shards),
    the optimizer slots are created at their own layout's shapes, and
    ``state.shardings`` is the layout.  ``sp_mode`` ("ring"/"ulysses")
    is the attention core a ``sequence`` axis runs."""
    policy = policy or Policy()
    for p in model.parameters():
        p.data = p.data.to(policy.param_dtype)
    layout = None
    if mesh is not None:
        from ..comm import collectives
        from ..parallel.sharded import shard_model, slot_templates

        layout = infer_state_shardings(model, mesh, rules=rules,
                                       opt_rules=opt_rules, sp_mode=sp_mode)
        if mesh.size > 1:
            collectives.broadcast([*model.parameters(), *model.buffers()],
                                  None)
        shard_model(model, layout)
    params = dict(model.named_parameters())
    slots = (list(params.values()) if layout is None
             else slot_templates(layout, params))
    state = TrainState(step=0, params=params, opt_state=tx.init(slots),
                       model=model, tx=tx,
                       batch_stats=dict(model.named_buffers()),
                       keep=frozenset(master_affine_params(model)),
                       shardings=layout)
    if process_group is not None and layout is None:
        replicate_state(state, process_group)
    return state
