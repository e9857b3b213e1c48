"""Mixture-of-Experts layers: the counterpart of the JAX package's
``models/moe.py``.

Switch-Transformer top-1 routing (Fedus et al. 2021): each token goes to
the expert of its largest router probability, into that expert's buffer
of ``capacity = max(int(cf * T / E), 1)`` slots; a token past its
expert's capacity is dropped (its output is zero, so the block's
residual carries it through unchanged).  The load-balancing loss is
``E * sum_e fraction_e * prob_mean_e`` (Switch eq. 4).  Both dispatch
formulations derive from one routing (:func:`top1_route`), so their token
selection is identical by construction:

- ``"einsum"``: GShard's (T, E, C) dispatch and combine one-hots and
  dense einsums (JAX's default, the formulation GSPMD lowers to
  all-to-alls under an expert axis);
- ``"scatter"``: ``flat = expert * C + slot`` rows into the flat (E*C, D)
  buffers by ``index_add_``, back by ``index_select``, dropped tokens
  pointed at a sentinel row; no (T, E, C) tensors.

The expert einsums and the scatter/gather are plain products and index
ops, as in JAX (there is no Pallas kernel in the JAX module).  The expert
weights keep JAX's layout, ``w_up`` (E, D, F) and ``w_down`` (E, F, D),
with no bias; the GELU is the tanh form (flax's ``nn.gelu``).  Where JAX
sows the aux loss and the drop rate, :class:`MoeMlp` returns them.

**Routing over the global batch.**  JAX routes the global (micro)batch:
``T`` and so the capacity count every token, a token's slot is its rank
among all tokens routed to its expert in global row order, and the aux
loss is the product of global means.  A data-parallel rank holds only its
rows, which are the ``index``-th of the batch group's equal slices of
each microbatch (``data/loader.py::rank_rows``).  With ``route_group``
set (:func:`set_moe_routing`; the train step does it) the layer
exchanges its per-expert counts over that group and offsets its slots by
the exclusive prefix of the lower ranks' counts, counts ``T`` over the
group, and all-reduces ``fraction`` and ``prob_mean``, the latter through
autograd (``comm.collectives.all_reduce_sum``: its backward sums the
cotangents too, so the averaged gradients are the global loss's).

**Expert parallelism** (``parallel``, set by
``parallel/sharded.py::configure_model``).  The ``expert`` axis is not a
batch axis: every rank of an expert group holds the same tokens and
routes them identically.  Each rank holds ``E / ep`` experts (its
contiguous block of ``w_up``/``w_down``) and runs only their rows; under
a ``tensor`` axis as well, each expert's ``w_up`` is column-split and its
``w_down`` row-split (Megatron).  The layer's output is summed over the
expert x tensor group (``reduce_from_group``: top-1 gives each token one
non-zero term, so the sum is exact), and the token rows and gates that
enter the experts pass ``copy_to_group``, whose backward sums their
partial cotangents over the same group.  That is one all-reduce of the
(T, D) output a layer forward and one of the token and gate cotangents
a layer backward; JAX instead splits the token dim around the dispatch
and the combine so that GSPMD lowers them to all-to-alls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..comm import collectives
from .gpt2 import LN_EPS, _site_generator, dropout
from .layers import SelfAttention

DISPATCH_MODES = ("einsum", "scatter")


@dataclasses.dataclass(frozen=True)
class MoeParallel:
    """The expert x tensor group of an MoE layer: ``group`` (None when
    both axes are 1), the ranks whose partial outputs sum to the layer's,
    and this rank's ``ep_index`` among the expert shards (its experts are
    the ``ep_index``-th block of ``E / ep``)."""

    group: Any = None
    ep_index: int = 0


def top1_route(logits: torch.Tensor, capacity_factor: float,
               route_group=None, capacity: int | None = None):
    """The routing both formulations share.  ``logits`` (T, E) →
    ``(expert_idx, slot, gate, aux, keep_sum, capacity, total)``:
    ``slot`` is the token's place in its expert's buffer or -1 past
    capacity, ``gate`` its router probability, ``aux`` the balancing
    loss, ``keep_sum`` the kept tokens, ``capacity`` the slots an expert
    and ``total`` the tokens routed, over ``route_group`` when given
    (module docstring).  ``capacity`` fixes the slots an expert instead
    of ``capacity_factor``."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    expert_idx = probs.argmax(dim=-1)
    onehot = F.one_hot(expert_idx, e).float()
    gate = (probs * onehot).sum(-1)
    counts, prob_sum = onehot.sum(0), probs.sum(0)
    total, prefix = t, 0.0
    if route_group is not None:
        n = torch.distributed.get_world_size(route_group)
        rank = torch.distributed.get_rank(route_group)
        every = collectives.all_gather(counts[None], route_group)
        prefix = every[:rank].sum(0)
        counts = every.sum(0)
        prob_sum = collectives.all_reduce_sum(prob_sum, route_group)
        total = t * n
    aux = e * torch.sum((counts / total) * (prob_sum / total))
    if capacity is None:
        capacity = max(int(capacity_factor * total / e), 1)
    position = (torch.cumsum(onehot, 0) + prefix) * onehot - 1.0
    in_capacity = (position >= 0) & (position < capacity)
    slot = torch.where(in_capacity, position,
                       torch.full_like(position, -1.0)).amax(-1).long()
    keep_sum = (slot >= 0).float().sum()
    if route_group is not None:
        keep_sum = collectives.psum(keep_sum, route_group)
    return expert_idx, slot, gate, aux, keep_sum, capacity, total


def top1_dispatch(logits: torch.Tensor, capacity: int):
    """GShard's one-hots of one routing (``route_group`` None):
    ``(dispatch (T, E, C), combine (T, E, C), aux)`` for a fixed
    ``capacity``, as JAX's ``_top1_dispatch`` takes it."""
    idx, slot, gate, aux, *_ = top1_route(logits, 0.0, capacity=capacity)
    dispatch = _dispatch(idx, slot, logits.shape[1], capacity)
    return dispatch, dispatch * gate[:, None, None], aux


def _dispatch(expert_idx, slot, e: int, capacity: int) -> torch.Tensor:
    """The (T, E, C) dispatch one-hot: token t at (expert, slot)."""
    onehot = F.one_hot(expert_idx, e).float()
    pos = F.one_hot(slot.clamp(min=0), capacity).float()
    keep = (slot >= 0).float()
    return onehot[:, :, None] * pos[:, None, :] * keep[:, None, None]


def top1_scatter_indices(logits: torch.Tensor, capacity: int):
    """``(flat (T,), gate (T,), keep (T,))`` of one routing: the row of
    the flat (E*C, D) buffers each token goes to, ``E*C`` (the sentinel)
    for a dropped token (JAX's ``_top1_scatter_indices``)."""
    idx, slot, gate, *_ = top1_route(logits, 0.0, capacity=capacity)
    return (_flat_rows(idx, slot, logits.shape[1], capacity), gate,
            (slot >= 0).float())


def _flat_rows(expert_idx, slot, e: int, capacity: int) -> torch.Tensor:
    """``expert * C + slot`` of each token, ``E*C`` for a dropped one."""
    return torch.where(slot >= 0, expert_idx * capacity + slot,
                       torch.full_like(slot, e * capacity))


def _variance_scaling_(w: torch.Tensor, generator) -> None:
    """flax's ``variance_scaling(2.0, "fan_in", "truncated_normal")`` for
    an (E, in, out) leaf: fan_in = E * in (flax counts the leading dim
    as receptive field), a normal truncated at 2 sigma."""
    fan_in = w.shape[0] * w.shape[1]
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class MoeMlp(nn.Module):
    """Drop-in MLP: (B, L, D) → ``(out (B, L, D), aux, drop_rate)``
    through ``num_experts`` experts of width ``mlp_dim`` (module
    docstring).  Built whole; ``parallel/sharded.py`` replaces
    ``w_up``/``w_down`` by this rank's experts and tensor shard."""

    parallel = None        # MoeParallel (parallel/sharded.py)
    route_group = None     # set_moe_routing

    def __init__(self, hidden_dim: int, num_experts: int, mlp_dim: int, *,
                 capacity_factor: float = 1.25, dispatch_mode: str = "einsum",
                 device=None, dtype=None):
        super().__init__()
        if dispatch_mode not in DISPATCH_MODES:
            raise ValueError(f"dispatch_mode must be 'einsum' or 'scatter', "
                             f"got {dispatch_mode!r}")
        kw = dict(device=device, dtype=dtype)
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dispatch_mode = dispatch_mode
        self.router = nn.Linear(hidden_dim, num_experts, **kw)
        self.w_up = nn.Parameter(torch.empty(num_experts, hidden_dim,
                                             mlp_dim, **kw))
        self.w_down = nn.Parameter(torch.empty(num_experts, mlp_dim,
                                               hidden_dim, **kw))

    @torch.no_grad()
    def init_experts(self, generator) -> None:
        _variance_scaling_(self.w_up, generator)
        _variance_scaling_(self.w_down, generator)

    def forward(self, x):
        b, l, d = x.shape
        t, e = b * l, self.num_experts
        tokens = x.reshape(t, d)
        idx, slot, gate, aux, keep_sum, capacity, total = top1_route(
            F.linear(tokens.float(), self.router.weight.float(),
                     self.router.bias.float()),
            self.capacity_factor, self.route_group)
        drop_rate = 1.0 - keep_sum / total
        par = self.parallel or MoeParallel()
        e_local = self.w_up.shape[0]
        lo = par.ep_index * e_local
        if par.group is not None:
            tokens = collectives.copy_to_group(tokens, par.group)
            gate = collectives.copy_to_group(gate, par.group)
        w_up, w_down = self.w_up.to(x.dtype), self.w_down.to(x.dtype)
        if self.dispatch_mode == "scatter":
            flat = _flat_rows(idx, slot, e, capacity)
            mine = (flat >= lo * capacity) & (flat < (lo + e_local)
                                              * capacity)
            sentinel = e_local * capacity
            local = torch.where(mine, flat - lo * capacity,
                                torch.full_like(flat, sentinel))
            buf = tokens.new_zeros(sentinel + 1, d).index_add_(0, local,
                                                               tokens)
            expert_in = buf[:sentinel].view(e_local, capacity, d)
            h = F.gelu(torch.bmm(expert_in, w_up), approximate="tanh")
            expert_out = torch.bmm(h, w_down).reshape(sentinel, d)
            rows = torch.cat([expert_out, expert_out.new_zeros(1, d)])
            out = rows.index_select(0, local) * (
                gate * (slot >= 0)).to(x.dtype)[:, None]
        else:
            dispatch = _dispatch(idx, slot, e, capacity)[:, lo:lo + e_local]
            combine = dispatch * gate[:, None, None]
            expert_in = torch.einsum("td,tec->ecd", tokens,
                                     dispatch.to(x.dtype))
            h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, w_up),
                       approximate="tanh")
            expert_out = torch.einsum("ecf,efd->ecd", h, w_down)
            out = torch.einsum("ecd,tec->td", expert_out,
                               combine.to(x.dtype))
        if par.group is not None:
            out = collectives.reduce_from_group(out, par.group)
        return out.reshape(b, l, d).to(x.dtype), aux, drop_rate


class MoeBlock(nn.Module):
    """Pre-LN GPT-2 block with an MoE MLP (JAX's ``MoeBlock``): ln1 →
    attention (``models/layers.py``, the flash kernels at q_len >= 256 on
    the card) → dropout → residual; ln2 → :class:`MoeMlp` → dropout →
    residual.  Returns ``(x, aux, drop_rate)``."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_dim
        self.ln1 = nn.LayerNorm(d, eps=LN_EPS, **kw)
        self.attn = SelfAttention(d, cfg.num_heads, causal=True, **kw)
        self.ln2 = nn.LayerNorm(d, eps=LN_EPS, **kw)
        self.moe = MoeMlp(d, cfg.num_experts, d * cfg.mlp_ratio,
                          capacity_factor=cfg.moe_capacity_factor,
                          dispatch_mode=cfg.moe_dispatch, **kw)
        self.dropout_rate = cfg.dropout_rate

    def forward(self, x, *, dropout_seed=None):
        """``dropout_seed``: as ``gpt2.Block``'s (one generator for both
        masks, so a rematerialized forward draws them again)."""
        gen = _site_generator(dropout_seed, x.device)
        x = x + dropout(self.attn(self.ln1(x)), self.dropout_rate, gen)
        y, aux, drop_rate = self.moe(self.ln2(x))
        return x + dropout(y, self.dropout_rate, gen), aux, drop_rate


def set_moe_routing(model: nn.Module, group) -> None:
    """Route every :class:`MoeMlp` of ``model`` over ``group``'s rows
    (None: this rank's rows alone) (module docstring)."""
    for m in model.modules():
        if isinstance(m, MoeMlp):
            m.route_group = group
