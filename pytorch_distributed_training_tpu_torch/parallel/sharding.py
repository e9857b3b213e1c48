"""Parameter placement: the JAX package's ``parallel/sharding.py`` over a
port :class:`~..comm.mesh.Mesh`.

JAX assigns each array a ``PartitionSpec`` over the named mesh axes and
lets GSPMD insert the collectives.  The port keeps JAX's decisions and
makes the collectives explicit (``parallel/sharded.py``): the same
regexes (``ShardingRules``), matched against the same flax paths, decide
the same leaves.  The port's parameter names and dims are not flax's, so
each name is mapped once to its flax path and dims
(``models/convert.py::jax_leaf_paths`` / ``jax_leaf_dims``, beside the
weight bridge's name map); :func:`infer_params_sharding` applies the
rules there and returns, for each leaf, the port spec :class:`P`: one
entry per port dim, the mesh axis (or axes) that shards it or None.

Data parallelism (``DDP_RULES``) replicates every array:
``replicate_state`` broadcasts rank 0's parameters, batch statistics and
optimizer slots to every rank once, at the start, which is
``DistributedDataParallel``'s constructor broadcast.  The model is not
wrapped in ``DistributedDataParallel``: the train step takes its
gradients with ``torch.autograd.grad`` on a functional call
(``parallel/grad_accum.py``), and DDP's reducer hooks, which fire on
``.grad`` accumulation in ``backward()``, never would.  The step
all-reduces the gradients itself (``comm.collectives.pmean``), and the
sharded paths put their collectives into the graph
(``comm.collectives.gather_sum`` and friends).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

import torch

from ..comm import collectives
from ..comm.mesh import (
    AXIS_DATA, AXIS_EXPERT, AXIS_FSDP, AXIS_SEQUENCE, AXIS_TENSOR, BATCH_AXES,
    MESH_AXES,
)

MIN_FSDP_SIZE = 2**14  # below this, replication beats sharding (biases, norms)


class P(tuple):
    """A ``PartitionSpec``: one entry per dim, ``None``, an axis name or a
    tuple of names; ``P()`` is replication."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _sizes(mesh) -> dict[str, int]:
    """Axis -> size of ``mesh`` (a port ``Mesh`` or a dict), 1 where
    absent."""
    shape = mesh if isinstance(mesh, dict) else mesh.shape
    return {a: int(shape.get(a, 1)) for a in MESH_AXES}


def batch_sharding(mesh, *, ndim: int = 1,
                   sequence_sharded: bool = False) -> P:
    """The spec of a batch leaf: dim 0 over ``BATCH_AXES``, and with
    ``sequence_sharded`` dim 1 over ``sequence``."""
    spec: list[Any] = [None] * ndim
    spec[0] = BATCH_AXES
    if sequence_sharded and ndim >= 2:
        spec[1] = AXIS_SEQUENCE
    return P(*spec)


def shard_batch(batch: dict, mesh, *, sequence_sharded: bool = False,
                num_microbatches: int = 1) -> dict:
    """This rank's part of a global batch (numpy arrays or tensors): its
    rows of each of ``num_microbatches`` row-wise microbatches (the
    loader's ``rank_rows`` over the batch group, so the ranks of one
    tensor or sequence group take the same rows) and, with
    ``sequence_sharded``, its ``L / sequence`` positions."""
    from ..data.loader import rank_rows

    n = mesh.axes_size(BATCH_AXES)
    index = mesh.batch_index
    out = {}
    for k, x in batch.items():
        x = rank_rows(x, index, n, num_microbatches)
        if sequence_sharded and x.ndim >= 2:
            s, i = mesh.shape[AXIS_SEQUENCE], mesh.coords[AXIS_SEQUENCE]
            ll = x.shape[1] // s
            x = x[:, i * ll:(i + 1) * ll]
        out[k] = x
    return out


def _fsdp_spec(shape: tuple[int, ...], fsdp_size: int, min_size: int) -> P:
    """Shard the largest axis divisible by ``fsdp_size``; replicate if
    none."""
    return _largest_axis_spec(shape, fsdp_size, AXIS_FSDP, min_size)


def _largest_axis_spec(shape: tuple[int, ...], size: int, axis: str,
                       min_size: int) -> P:
    if size <= 1:
        return P()
    total = 1
    for d in shape:
        total *= d
    if total < min_size:
        return P()  # tiny params (biases, norm scales): replication is cheaper
    candidates = [i for i, d in enumerate(shape) if d % size == 0]
    if not candidates:
        return P()
    best = max(candidates, key=lambda i: shape[i])
    spec: list[Any] = [None] * len(shape)
    spec[best] = axis
    return P(*spec)


def _drop_trivial_axes(spec: P, mesh) -> P | None:
    """Strip mesh axes of size 1 from a spec entry-wise; None when every
    referenced axis is trivial."""
    sizes = _sizes(mesh)

    def keep(ax):
        return sizes.get(ax, 1) > 1

    out, any_kept = [], False
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if keep(a))
            out.append(kept if kept else None)
            any_kept |= bool(kept)
        else:
            out.append(entry if keep(entry) else None)
            any_kept |= keep(entry)
    return P(*out) if any_kept else None


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Param-path-regex -> spec rules, first match wins; ``fallback``
    handles unmatched (or dropped) params: "fsdp" (largest divisible
    axis over ``fsdp``), "data" (the same over ``data``: ZeRO-1's slots)
    or "replicate".  ``classify`` gives JAX's reasons as well."""

    rules: Sequence[tuple[str, Any]] = ()
    fallback: str = "fsdp"  # "fsdp" | "replicate" | "data"
    min_fsdp_size: int = MIN_FSDP_SIZE

    def spec_for(self, path: str, shape: tuple[int, ...], mesh) -> P:
        return self.classify(path, shape, mesh)[0]

    def classify(self, path: str, shape: tuple[int, ...],
                 mesh) -> tuple[P, str]:
        sizes = _sizes(mesh)
        matched = None
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                if callable(spec):
                    spec = spec(shape, mesh)
                if len(spec) == 0:
                    return P(), "rule-replicate"
                spec = _drop_trivial_axes(spec, mesh)
                if spec is not None:
                    spec = _drop_indivisible_axes(spec, shape, mesh)
                if spec is not None:
                    return spec, "rule"
                matched = pattern
                break
        dropped = matched is not None
        if self.fallback == "fsdp":
            spec = _fsdp_spec(shape, sizes[AXIS_FSDP], self.min_fsdp_size)
        elif self.fallback == "data":
            spec = _largest_axis_spec(shape, sizes[AXIS_DATA], AXIS_DATA,
                                      self.min_fsdp_size)
        else:
            return P(), "rule-dropped" if dropped else "fallback-replicate"
        if len(spec) == 0:
            return P(), "rule-dropped" if dropped else "fallback-replicate"
        return spec, "fallback"


def _drop_indivisible_axes(spec: P, shape: tuple[int, ...], mesh) -> P | None:
    """Drop spec axes whose mesh extent does not divide the dimension
    (GPT-2's 50257-row vocab under ``tensor``); None if nothing
    shardable survives (the caller falls through to the fallback)."""
    sizes = _sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out, any_left, dropped = [], False, False
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        extent = 1
        for a in axes:
            extent *= sizes[a]
        if dim % extent == 0:
            out.append(entry)
            any_left = True
        else:
            out.append(None)
            dropped = True
    if not any_left:
        return None
    if not dropped:
        return spec
    while out and out[-1] is None:
        out.pop()
    return P(*out)


# DDP: everything replicated (the reference's layout).
DDP_RULES = ShardingRules(rules=(), fallback="replicate")
# ZeRO-3: everything sharded over fsdp where divisible.
FSDP_RULES = ShardingRules(rules=(), fallback="fsdp")
# ZeRO-1 (arXiv:2004.13336): replicated params, optimizer slots sharded
# over ``data``; pass as ``opt_rules``.
ZERO1_OPT_RULES = ShardingRules(rules=(), fallback="data")


def tp_rules_for(model: str) -> ShardingRules:
    """Megatron-style tensor-parallel rules for the transformer families
    (column-parallel QKV and MLP up, row-parallel proj and MLP down, the
    vocab-sharded embedding), FSDP behind them; the conv nets get
    ``FSDP_RULES``."""
    if model.startswith(("gpt2", "vit")):
        rules = (
            (r"moe/w_up", P(AXIS_EXPERT, None, AXIS_TENSOR)),
            (r"moe/w_down", P(AXIS_EXPERT, AXIS_TENSOR, None)),
            (r"moe/router", P()),
            (r"attn/qkv/kernel", P(None, AXIS_TENSOR)),
            (r"attn/proj/kernel", P(AXIS_TENSOR, None)),
            (r"mlp_up/kernel", P(None, AXIS_TENSOR)),
            (r"mlp_down/kernel", P(AXIS_TENSOR, None)),
            (r"wte", P(AXIS_TENSOR, None)),  # vocab-sharded embedding
            (r"qkv/bias|mlp_up/bias", P(AXIS_TENSOR)),
        )
        return ShardingRules(rules=rules, fallback="fsdp")
    return FSDP_RULES


def serve_tp_rules(model: str = "gpt2") -> ShardingRules:
    """``tp_rules_for`` for a tensor-parallel serving engine, with the
    deliberate replication of ``wpe`` spelled out (JAX's
    ``serve_tp_rules``).  ``wte`` keeps its vocab-split rule, which
    GPT-2's 50257-row vocabulary never divides (dropped, so
    replicated).  The port's engine consumes the column- and row-split
    leaves as its shards (``parallel/sharded.py::shard_for_serving``) and
    keeps every other leaf whole on each rank."""
    base = tp_rules_for(model)
    return dataclasses.replace(
        base, rules=((r"wpe", P()),) + tuple(base.rules))


def infer_params_sharding(shapes: dict, mesh,
                          rules: ShardingRules = DDP_RULES) -> dict[str, P]:
    """``{name: spec}`` for ``shapes`` (``{name: shape}`` of one model's
    parameters, or of their slots): each name's flax path and dims
    (``models/convert.py``), ``rules`` applied there as JAX applies them,
    and the spec carried back to the port's dims.  Every spec has one
    entry per dim."""
    from ..models.convert import jax_leaf_dims, jax_leaf_paths

    paths = jax_leaf_paths(shapes)
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        dims = jax_leaf_dims(paths[name], len(shape))
        jax_shape = [0] * len(shape)
        for i, j in enumerate(dims):
            jax_shape[j] = shape[i]
        spec = rules.spec_for(paths[name], tuple(jax_shape), mesh)
        spec = list(spec) + [None] * (len(shape) - len(spec))
        out[name] = P(*(spec[j] for j in dims))
    return out


def _entry_axes(entry) -> tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def spec_dims(spec: P) -> list[tuple[int, tuple[str, ...]]]:
    """``(dim, axes)`` of every dim ``spec`` shards, in dim order, each
    dim's axes in mesh order."""
    return [(i, tuple(sorted(_entry_axes(e), key=MESH_AXES.index)))
            for i, e in enumerate(spec) if e is not None]


def spec_axes(spec: P) -> tuple[int | None, tuple[str, ...]]:
    """``(dim, axes)`` of a spec that shards at most one dim (``(None,
    ())`` for replication).  A leaf sharded on two dims (the expert
    leaves under expert x tensor, a pipeline stage leaf under PP x FSDP
    or PP x TP) is ``parallel/sharded.py``'s ``Placement.outer`` layout,
    its leading dim's split applied first."""
    dims = spec_dims(spec)
    if not dims:
        return None, ()
    if len(dims) > 1:
        raise ValueError(
            f"spec {spec} shards {len(dims)} dims; take it as a "
            "Placement (parallel/sharded.py)")
    return dims[0]


def shard_params(params: dict, mesh,
                 rules: ShardingRules = DDP_RULES) -> dict[str, torch.Tensor]:
    """This rank's shard of each of ``params`` (full tensors) under
    ``rules``: the contiguous block of its index over each sharded dim's
    axes (``parallel/sharded.py`` lays the tensor-consumed QKV out by
    head instead)."""
    specs = infer_params_sharding(
        {n: tuple(t.shape) for n, t in params.items()}, mesh, rules)
    out = {}
    for name, t in params.items():
        for dim, axes in spec_dims(specs[name]):
            t = t.chunk(mesh.axes_size(axes), dim)[mesh.axes_index(axes)]
        out[name] = t
    return out


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
