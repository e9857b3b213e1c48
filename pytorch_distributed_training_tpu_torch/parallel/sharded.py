"""Sharded training state: FSDP (``--fsdp``), tensor parallelism
(``--tensor-parallel``), ZeRO-1 (``--zero1``), sequence parallelism
(``--sequence-parallel``) and the pipelined GPT-2's stages
(``--pipeline-parallel``) over a port :class:`~..comm.mesh.Mesh`.

JAX places every leaf with a ``PartitionSpec`` and GSPMD derives the
collectives.  Here the placement is ``parallel/sharding.py``'s (the same
rules, the same decisions) and :class:`ShardedLayout` carries it out:

- **Storage.**  Each rank keeps only its shard of each sharded parameter
  and optimizer slot, in the policy's parameter dtype: the contiguous
  block of its index over the spec's axes along the spec's dim.  The one
  exception is a leaf the tensor-parallel layer consumes as its own
  column shard (``attn.qkv``): it is split by head, rank ``t`` holding
  q, k and v of heads ``t*H/tp ..`` (``Placement.blocks``), which is the
  same decision (that dim, that axis) with the rows in another order;
  checkpoints store the logical tensor either way.  ``opt_rules`` place
  the slots independently of the parameters (ZeRO-1: replicated
  parameters, slots over ``data``).  Counts, the anomaly gate's state and
  ``batch_stats`` stay replicated.
- **Pipeline stages** (``parallel/gpt2_pipeline.py``).  A stage leaf's
  stage axis (dim 0) is split over ``pipeline``: each rank keeps its
  stage, and nothing gathers it at use (the leaf is consumed where it
  lies).  Under PP x FSDP or PP x TP a stage leaf is split on a second
  dim as well (``Placement.outer``: the stage split first, then the
  fsdp or tensor split); its shards' group, for the norm, spans both
  axes, and a checkpoint gathers both.  The pipeline engines combine
  their own gradients, so the step's ``sync_fn`` is not used.
- **Experts** (``models/moe.py``).  ``moe.w_up`` (E, D, F) and
  ``moe.w_down`` (E, F, D) lie over ``expert`` on dim 0 and, under a
  ``tensor`` axis, over ``tensor`` on F (``P(expert, None, tensor)``,
  ``P(expert, tensor, None)``: the expert split is ``Placement.outer``,
  as a stage leaf's).  The MoE layer consumes its rank's experts and
  tensor shard where they lie, so nothing gathers them; their gradients
  are summed over the batch axes only, as every other leaf's (the
  expert ranks hold the same rows).
- **Gather at use** (FSDP, and a tensor-sharded leaf the layer does not
  consume sharded, such as ``wte`` at a vocab the tensor axis divides).
  ``install_gather_hooks`` puts a forward pre-hook on each *unit* of the
  model — each element of a ``ModuleList`` (a transformer or ResNet
  block) and the root for the rest — that all-gathers the unit's
  sharded leaves when the unit runs, through the differentiable
  ``comm.collectives.gather_sum`` (backward: reduce-scatter to the
  shard) or, over the tensor axis, ``gather_slice`` (backward: this
  rank's slice: the tensor group computes the same values).  A post-hook
  puts the shards back.  The hooks do nothing to a leaf that is already
  whole, so an unsharded call passes through.  Autograd keeps the
  gathered weights alive until the backward (a block under ``--remat``
  gathers them again when it is recomputed); re-gathering every block in
  the backward to drop them after the forward is a later change.
- **Gradients.**  Every rank differentiates its own loss: its rows
  (``BATCH_AXES``) and, under sequence parallelism, its positions, the
  sequence ranks' losses summing to their rows' mean.  A leaf's gradient
  is then summed over the data, fsdp and sequence axes that its gather
  did not already sum (``gather_sum``'s reduce-scatter covers its own
  axis), reduce-scattered instead over a slot axis the parameter lacks
  (ZeRO-1's ``data``), and scaled by ``1 / (data x fsdp)``.  Tensor
  ranks hold the same gradient of a replicated leaf (Megatron's ``f``
  sums over them in the backward), so nothing is reduced over
  ``tensor``.  Leaves that share a collective share one flat buffer.
- **Update.**  A leaf whose slots lie as its parameter updates its
  shard in place.  A replicated parameter with sharded slots (ZeRO-1)
  updates the slice its slots cover, then the slices are all-gathered
  back into the whole parameter.  The global norm of the clip and of the
  anomaly gate sums each sharded leaf's squares over its slot group
  (``norm_groups``), so every rank clips by the norm of the whole
  gradient.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from ..comm import collectives
from ..comm.mesh import (
    AXIS_DATA, AXIS_EXPERT, AXIS_FSDP, AXIS_PIPELINE, AXIS_SEQUENCE,
    AXIS_TENSOR, BATCH_AXES,
)
from .sharding import P, infer_params_sharding, spec_axes, spec_dims

# Leaves the tensor-parallel layers consume as their rank's shard
# (models/layers.py, models/gpt2.py): column-parallel QKV and MLP up,
# row-parallel proj and MLP down.
TP_CONSUMED = re.compile(r"(^|\.)(attn\.qkv\.(weight|bias)|attn\.proj\.weight"
                         r"|mlp_up\.(weight|bias)|mlp_down\.weight)$")
# The MoE layer's expert leaves: consumed where they lie, on any axis.
_EXPERTS = re.compile(r"(^|\.)moe\.w_(up|down)$")
_BY_HEAD = re.compile(r"(^|\.)attn\.qkv\.(weight|bias)$")
# Axes a gradient is summed over: the ranks that see different data.
_DATA_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_SEQUENCE)


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """What a model's tensor- and sequence-parallel layers read
    (``models/layers.py``, ``models/gpt2.py``)."""

    tp_group: Any = None
    tp_size: int = 1
    sp_group: Any = None
    sp_size: int = 1
    sp_index: int = 0
    sp_mode: str = "ring"


def configure_model(model, mesh, sp_mode: str = "ring"):
    """Hand ``model``'s parallel-aware modules their :class:`ModelParallel`
    (None when the mesh has no tensor or sequence axis), and its MoE
    layers their expert x tensor group (``models/moe.py``); returns the
    former."""
    from ..models.moe import MoeMlp, MoeParallel

    tp, sp = mesh.shape[AXIS_TENSOR], mesh.shape[AXIS_SEQUENCE]
    if sp_mode not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp_mode {sp_mode!r} (ring|ulysses)")
    ctx = None
    if tp > 1 or sp > 1:
        ctx = ModelParallel(
            tp_group=mesh.group(AXIS_TENSOR), tp_size=tp,
            sp_group=mesh.group(AXIS_SEQUENCE), sp_size=sp,
            sp_index=mesh.coords[AXIS_SEQUENCE], sp_mode=sp_mode)
    moe = MoeParallel(group=mesh.group((AXIS_EXPERT, AXIS_TENSOR)),
                      ep_index=mesh.coords[AXIS_EXPERT])
    for m in model.modules():
        if isinstance(m, MoeMlp):
            m.parallel = moe if moe.group is not None else None
        elif hasattr(type(m), "parallel"):
            m.parallel = ctx
    return ctx


def shard_for_serving(model, mesh):
    """A tensor-parallel serving replica of ``model`` (a whole GPT-2) on
    ``mesh``'s tensor group, in place: each leaf the tensor-parallel
    layers consume (``TP_CONSUMED``) and ``serve_tp_rules`` splits over
    ``tensor`` becomes this rank's shard (``qkv`` by head, as training
    lays it out), every other leaf stays whole, and the model's
    ``parallel`` context is set (``configure_model``).  JAX's
    ``shard_map`` wrappers around the attention kernels
    (``pallas_attention.py``'s ``*_tp``) are this: the same kernels on
    the rank's local heads.  A head count the tensor axis does not
    divide is refused (JAX replicates the cache then)."""
    from torch import nn

    from .sharding import serve_tp_rules

    tp = mesh.shape[AXIS_TENSOR]
    heads = model.cfg.num_heads
    if heads % tp:
        raise ValueError(
            f"tensor-parallel serving over {tp} ranks needs heads "
            f"({heads}) divisible by it (each rank attends over its own "
            "heads)")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    specs = infer_params_sharding(shapes, mesh, serve_tp_rules())
    with torch.no_grad():
        for name, param in list(model.named_parameters()):
            if not (TP_CONSUMED.search(name) and AXIS_TENSOR
                    in spec_axis_names(specs[name])):
                continue
            place = Placement.of(specs[name], shapes[name], mesh,
                                 3 if _BY_HEAD.search(name) else 1)
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf, nn.Parameter(
                place.shard(param.detach()).contiguous(),
                requires_grad=False))
    configure_model(model, mesh)
    return model


def spec_axis_names(spec: P) -> set:
    """Every mesh axis a spec names, on any dim."""
    return {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}


@dataclasses.dataclass(frozen=True)
class Placement:
    """One leaf's layout on this rank: its whole ``shape``, the ``dim``
    its ``axes`` split ``n`` ways (None: replicated), this rank's
    ``index`` over them, and ``blocks`` (> 1: the dim is ``blocks``
    equal blocks, each split ``n`` ways, the QKV's by-head layout).
    ``outer``: a leaf split on two dims, its leading dim over
    ``pipeline`` (a stage leaf) or ``expert`` (an expert leaf) beside the
    split above (``fsdp`` or ``tensor``), is this placement of dim 0,
    applied first."""

    shape: tuple
    dim: int | None = None
    axes: tuple = ()
    n: int = 1
    index: int = 0
    blocks: int = 1
    outer: "Placement | None" = None

    @classmethod
    def of(cls, spec: P, shape, mesh, blocks: int = 1) -> "Placement":
        spec = tuple(spec)
        dims = spec_dims(spec)
        if len(dims) > 1:
            # Axes of size 1 split nothing; two live dims are the
            # outer-then-inner layout.
            live = [(d, a) for d, a in dims if mesh.axes_size(a) > 1]
            if len(live) > 1:
                if live[0][0] != 0 or spec[0] not in (AXIS_PIPELINE,
                                                      AXIS_EXPERT):
                    raise NotImplementedError(
                        f"spec {spec}: only the leading pipeline or expert "
                        "dim nests another split")
                return dataclasses.replace(
                    cls.of(P(None, *spec[1:]), shape, mesh, blocks),
                    outer=cls.of(P(spec[0]), shape, mesh))
            spec = tuple(spec[d] if any(d == dd for dd, _ in live) else None
                         for d in range(len(spec)))
        dim, axes = spec_axes(spec)
        if dim is None:
            return cls(tuple(shape))
        return cls(tuple(shape), dim, axes, mesh.axes_size(axes),
                   mesh.axes_index(axes), blocks)

    @property
    def sharded(self) -> bool:
        return self.dim is not None and self.n > 1

    @property
    def group_axes(self) -> tuple:
        """Every axis the leaf is split over (its shards' group)."""
        return (self.outer.axes if self.outer else ()) + self.axes

    @property
    def local_shape(self) -> tuple:
        if not self.sharded:
            return self.shape
        s = list(self.shape)
        s[self.dim] //= self.n
        if self.outer is not None:
            s[0] //= self.outer.n
        return tuple(s)

    def shard(self, full: torch.Tensor, index: int | None = None):
        """Shard ``index`` (default this rank's) of the whole tensor."""
        if not self.sharded:
            return full
        if self.outer is not None:
            full = self.outer.shard(full)
        i = self.index if index is None else index
        x = full.movedim(self.dim, 0)
        rest = x.shape[1:]
        x = x.reshape(self.blocks, self.n, -1, *rest)[:, i]
        return x.reshape(-1, *rest).movedim(0, self.dim)

    def unshard(self, gathered: torch.Tensor) -> torch.Tensor:
        """The whole tensor from the shards concatenated along ``dim`` in
        index order (what ``all_gather`` returns)."""
        if not self.sharded or self.blocks == 1:
            return gathered
        x = gathered.movedim(self.dim, 0)
        rest = x.shape[1:]
        x = x.reshape(self.n, self.blocks, -1, *rest).transpose(0, 1)
        return x.reshape(-1, *rest).movedim(0, self.dim)


def _rows(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` as (n, -1): row i is its i-th block along ``dim``."""
    return t.movedim(dim, 0).reshape(n, -1)


def _from_rows(flat: torch.Tensor, shape: tuple, dim: int) -> torch.Tensor:
    """The inverse of ``_rows`` for a tensor of ``shape``."""
    moved = (shape[dim], *shape[:dim], *shape[dim + 1:])
    return flat.reshape(moved).movedim(0, dim)


class ShardedLayout:
    """The placement of a model's parameters (``param_specs``) and
    optimizer slots (``slot_specs``) on ``mesh``, and the collectives
    that keep a train step in it (module docstring).  ``consumed``: the
    leaves the model's tensor-parallel layers take as their shards."""

    def __init__(self, mesh, shapes: dict, param_specs: dict,
                 slot_specs: dict, consumed: frozenset = frozenset(),
                 sp_mode: str = "ring"):
        self.mesh = mesh
        self.names = list(shapes)
        self.param_specs, self.slot_specs = param_specs, slot_specs
        self.consumed = consumed
        self.sp_mode = sp_mode
        self.params = {
            n: Placement.of(param_specs[n], shapes[n], mesh,
                            3 if n in consumed and _BY_HEAD.search(n)
                            and AXIS_TENSOR in spec_axis_names(
                                param_specs[n]) else 1)
            for n in self.names}
        self.slots = {}
        for n in self.names:
            same = slot_specs[n] == param_specs[n]
            self.slots[n] = (self.params[n] if same else
                             Placement.of(slot_specs[n], shapes[n], mesh))
            if not same and self.params[n].sharded:
                raise NotImplementedError(
                    f"{n}: slots laid out otherwise than a sharded "
                    "parameter (only replicated parameters take their own "
                    "slot layout, ZeRO-1's)")
        self.n_batch = mesh.axes_size(BATCH_AXES)
        self.reduce_axes = tuple(a for a in _DATA_AXES if mesh.shape[a] > 1)

    # ---- layout queries --------------------------------------------------

    @property
    def sp_size(self) -> int:
        return self.mesh.shape[AXIS_SEQUENCE]

    @property
    def sp_index(self) -> int:
        return self.mesh.coords[AXIS_SEQUENCE]

    @property
    def dropout_rank(self) -> int:
        """The rank index dropout masks are seeded with: the batch index
        and sequence index, never the tensor index (a tensor group's
        replicated activations must draw the same masks)."""
        return self.mesh.batch_index * self.sp_size + self.sp_index

    def gather_axes(self, name: str) -> tuple:
        """The axes ``name`` is gathered over where it is used: its spec's,
        unless the layer consumes it sharded."""
        p = self.params[name]
        if not p.sharded or name in self.consumed:
            return ()
        return p.axes

    def _sum_gathered(self, name: str) -> tuple:
        axes = self.gather_axes(name)
        return () if AXIS_TENSOR in axes else axes

    def norm_groups(self, names) -> list:
        """For each of ``names``, the group its gradient (in the slot
        layout) is sharded over, None where it is whole."""
        return [self.mesh.group(self.slots[n].group_axes)
                if self.slots[n].sharded else None for n in names]

    # ---- gather at use ---------------------------------------------------

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` (``name``'s shard, or the whole leaf) whole, through the
        differentiable gather (module docstring)."""
        axes = self.gather_axes(name)
        p = self.params[name]
        if not axes or tuple(t.shape) == p.shape:
            return t
        if AXIS_TENSOR in axes and len(axes) > 1:
            raise NotImplementedError(
                f"{name}: gathered over {axes}; the tensor axis is gathered "
                "alone")
        group = self.mesh.group(axes)
        if AXIS_TENSOR in axes:
            return collectives.gather_slice(t, group, p.dim)
        return collectives.gather_sum(t, group, p.dim)

    # ---- gradients -------------------------------------------------------

    def _plan(self, name: str) -> tuple[tuple, tuple]:
        """``(psum_axes, scatter_axes)`` of ``name``'s gradient."""
        summed = self._sum_gathered(name)
        reduce = [a for a in self.reduce_axes if a not in summed]
        s, p = self.slots[name], self.params[name]
        scatter = tuple(a for a in s.axes if a not in p.axes) \
            if s.sharded else ()
        if any(a not in reduce for a in scatter):
            raise NotImplementedError(
                f"{name}: slot axes {s.axes} beyond the gradient's reduce "
                f"axes {reduce}")
        return tuple(a for a in reduce if a not in scatter), scatter

    def sync_fn(self, names: list):
        """The gradient sync of ``parallel/grad_accum.py``'s one-call
        contract for a step over ``names`` (the state's parameter
        order): f32 gradients in the parameters' local layout, then the
        loss and aux values, in; gradients in the slots' layout and the
        values' global means out."""
        plans = [self._plan(n) for n in names]
        scale = 1.0 / self.n_batch

        def sync(tensors: list, carry):
            grads, values = tensors[:len(names)], tensors[len(names):]
            out: list = [None] * len(grads)
            buckets: dict = {}
            for i, (n, plan) in enumerate(zip(names, plans)):
                buckets.setdefault(plan, []).append(i)
            for (psum_axes, scatter), idx in buckets.items():
                if scatter:
                    self._reduce_scatter(names, grads, idx, scatter,
                                         psum_axes, out)
                else:
                    flat = torch.cat([grads[i].reshape(-1) for i in idx])
                    group = self.mesh.group(psum_axes)
                    if group is not None:
                        collectives.psum(flat, group)
                    for i, v in zip(idx, flat.split(
                            [grads[i].numel() for i in idx])):
                        out[i] = v.view(grads[i].shape)
            out = [g * scale for g in out]
            if values:
                flat = torch.cat([v.reshape(-1) for v in values])
                group = self.mesh.group(self.reduce_axes)
                if group is not None:
                    collectives.psum(flat, group)
                flat = flat * scale
                values = [v.view(t.shape) for v, t in zip(
                    flat.split([t.numel() for t in values]), values)]
            return out + list(values), carry

        return sync

    def _reduce_scatter(self, names, grads, idx, scatter, psum_axes, out):
        """One reduce-scatter over ``scatter`` for the leaves ``idx`` (each
        packed as its rows along its slot dim), then the psum over
        ``psum_axes`` of the (smaller) result."""
        group = self.mesh.group(scatter)
        n = self.mesh.axes_size(scatter)
        rows = [_rows(grads[i], self.slots[names[i]].dim, n) for i in idx]
        packed = torch.cat(rows, dim=1)
        mine = collectives.reduce_scatter(packed, group)[0]
        other = self.mesh.group(psum_axes)
        if other is not None:
            collectives.psum(mine, other)
        for i, v in zip(idx, mine.split([r.shape[1] for r in rows])):
            s = self.slots[names[i]]
            out[i] = _from_rows(v, s.local_shape, s.dim)

    def scatter_grads(self, names: list, full: dict) -> dict:
        """Whole (mean) gradients laid out as the slots: each rank's
        slice of every slot-sharded leaf."""
        return {n: self.slots[n].shard(full[n]) if self.slots[n].sharded
                and not self.params[n].sharded else full[n] for n in names}

    # ---- the update ------------------------------------------------------

    def update_views(self, names: list, params: list):
        """``(views, finish)``: the tensors the optimizer updates in place
        for ``params`` (each parameter, or the slice of a replicated one
        its sharded slots cover) and the call that all-gathers those
        slices back into the whole parameters afterwards."""
        views, regather = [], []
        for n, p in zip(names, params):
            s = self.slots[n]
            if s.sharded and not self.params[n].sharded:
                views.append(s.shard(p))
                regather.append(len(views) - 1)
            else:
                views.append(p)

        def finish():
            by_group: dict = {}
            for i in regather:
                by_group.setdefault(self.slots[names[i]].axes, []).append(i)
            for axes, idx in by_group.items():
                group = self.mesh.group(axes)
                n = self.mesh.axes_size(axes)
                mine = torch.cat([views[i].movedim(
                    self.slots[names[i]].dim, 0).reshape(-1) for i in idx])
                allr = collectives.all_gather(mine, group).view(n, -1)
                for i, cols in zip(idx, allr.split(
                        [views[i].numel() for i in idx], dim=1)):
                    s = self.slots[names[i]]
                    params[i].copy_(_from_rows(cols, s.shape, s.dim))

        return views, finish

    # ---- checkpoints -----------------------------------------------------

    def placement_of(self, ckpt_name: str, t: torch.Tensor):
        """The placement of a checkpoint entry (``checkpoint/manager.py``'s
        names), None for a replicated one."""
        if ckpt_name.startswith("params/"):
            return self.params.get(ckpt_name[len("params/"):])
        if ckpt_name.startswith("opt_state/") and t.dim() > 0:
            return self.slots.get(ckpt_name.rsplit("/", 1)[1])
        return None

    def full_shape(self, ckpt_name: str, t: torch.Tensor) -> tuple:
        p = self.placement_of(ckpt_name, t)
        return p.shape if p is not None else tuple(t.shape)

    def gather_full(self, ckpt_name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of a checkpoint entry, on every rank
        (collective over the entry's group)."""
        p = self.placement_of(ckpt_name, t)
        if p is None or not p.sharded:
            return t
        gathered = p.unshard(collectives.all_gather(
            t.detach().contiguous(), self.mesh.group(p.axes),
            gather_axis=p.dim))
        if p.outer is not None:
            gathered = collectives.all_gather(
                gathered.contiguous(), self.mesh.group(p.outer.axes))
        return gathered

    def shard_full(self, ckpt_name: str, live: torch.Tensor,
                   full: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``full`` for the live entry ``live``."""
        p = self.placement_of(ckpt_name, live)
        return full if p is None else p.shard(full)


def state_bytes(state) -> int:
    """This rank's bytes of parameters and optimizer slots (sharded or
    not)."""
    from .sharding import _tensors

    return sum(t.numel() * t.element_size() for t in
               [*state.params.values(), *_tensors(state.opt_state)])


def install_gather_hooks(model, layout: ShardedLayout) -> None:
    """Forward pre/post hooks on each unit of ``model`` that gather its
    sharded leaves at use and put the shards back (module docstring)."""
    units: dict = {}
    for name in layout.names:
        if not layout.gather_axes(name):
            continue
        m = re.match(r"^(.*?\.\d+)\.(.+)$", name)
        unit, rest = (m.group(1), m.group(2)) if m else ("", name)
        owner, _, leaf = rest.rpartition(".")
        units.setdefault(unit, []).append((owner, leaf, name))
    for unit, entries in units.items():
        module = model.get_submodule(unit)
        stack: list = []

        def pre(mod, args, entries=entries, stack=stack):
            saved = []
            for owner, leaf, name in entries:
                m = mod.get_submodule(owner)
                t = m._parameters[leaf]
                full = layout.gather(name, t)
                if full is not t:
                    saved.append((m, leaf, t))
                    m._parameters[leaf] = full
            stack.append(saved)

        def post(mod, args, output, stack=stack):
            for m, leaf, t in stack.pop():
                m._parameters[leaf] = t

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)


def build_layout(model, mesh, *, rules, opt_rules=None,
                 sp_mode: str = "ring") -> ShardedLayout:
    """The layout of ``model``'s parameters (whole, as built) on
    ``mesh``: ``rules`` for the parameters, ``opt_rules`` (default the
    same) for the slots; the TP-consumed leaves are those the tensor
    axis shards and the model's layers take sharded."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    specs = infer_params_sharding(shapes, mesh, rules)
    slot_specs = (specs if opt_rules is None
                  else infer_params_sharding(shapes, mesh, opt_rules))
    tp_aware = any(hasattr(type(m), "parallel") for m in model.modules())
    consumed = frozenset(
        n for n in shapes if (tp_aware and TP_CONSUMED.search(n)
                              and AXIS_TENSOR in spec_axis_names(specs[n]))
        # A pipeline stage's leaves are its rank's own: the pipeline's
        # stage body gathers what it needs (parallel/gpt2_pipeline.py).
        or AXIS_PIPELINE in spec_axis_names(specs[n])
        # The MoE layer runs its rank's experts and tensor shard.
        or (_EXPERTS.search(n) and spec_axis_names(specs[n])
            & {AXIS_EXPERT, AXIS_TENSOR}))
    return ShardedLayout(mesh, shapes, specs, slot_specs, consumed, sp_mode)


def shard_model(model, layout: ShardedLayout) -> None:
    """Replace each sharded parameter's data with this rank's shard (a
    contiguous copy) and install the gather hooks; the parallel-aware
    modules get their context."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            pl = layout.params[n]
            if pl.sharded:
                p.data = pl.shard(p.data).contiguous().clone()
    install_gather_hooks(model, layout)
    configure_model(model, layout.mesh, layout.sp_mode)


def slot_templates(layout: ShardedLayout, params: dict) -> list:
    """Zero tensors shaped as each parameter's slots on this rank (what
    ``Transform.init`` builds its moments like)."""
    return [torch.zeros(layout.slots[n].local_shape, dtype=p.dtype,
                        device=p.device) for n, p in params.items()]


def describe(layout: ShardedLayout) -> str:
    """One line: the mesh's non-trivial axes and how many leaves each
    placement shards."""
    axes = {a: s for a, s in layout.mesh.shape.items() if s > 1}
    sharded = sum(p.sharded for p in layout.params.values())
    slots = sum(s.sharded for s in layout.slots.values())
    tp = sum(AXIS_TENSOR in layout.params[n].axes for n in layout.consumed)
    return (f"sharding: {axes or {'data': 1}} | {sharded}/{len(layout.names)} "
            f"parameters sharded, {slots} slot sets sharded, "
            f"{tp} consumed by tensor-parallel layers")
