"""The JAX package's ``comm/mesh.py`` over ``torch.distributed`` process
groups: the six-axis mesh of the sharded training paths, and the
two-tier view of a data-parallel group that the hierarchical gradient
sync (``comm/hierarchical.py``) runs on.

**The mesh.**  :class:`Mesh` holds, for this rank, its coordinate on
each of JAX's axes (``MESH_AXES``) and one process group per axis: the
ranks that differ from this one in that axis alone.  Ranks follow JAX's
device order: the world's ranks laid out row-major over ``MESH_AXES``,
``data`` outermost and ``tensor`` innermost, so a tensor group is
adjacent ranks (the ranks of one node when a node holds a tensor group)
and ``data`` is the axis that crosses nodes.  :func:`make_mesh` refuses
what ``MeshConfig.resolve`` refuses, with its messages;
:func:`make_hybrid_mesh` lays a ``dcn_axis`` slice-major over the nodes
as JAX's simulated-device branch does.  ``Mesh.group(axes)`` builds the
group over several axes at once (the batch group ``BATCH_AXES``, the
gradient's reduce group) the first time it is asked for; every rank asks
for the same groups in the same order, as ``dist.new_group`` requires.

JAX factors its ``data`` mesh axis into ``data_dcn`` (across TPU slices,
the slow data-center network) and ``data_ici`` (within a slice).  The
port's slices are nodes: the links within a node take the ICI tier and
the links between nodes the DCN tier.  :func:`split_slice_groups` splits
a process group of ``S x L`` ranks into this rank's ICI group (the ``L``
ranks of its slice) and its DCN group (the rank of the same lane in every
slice), the counterpart of ``split_slice_mesh``.  Ranks are slice-major,
as ``make_hybrid_mesh`` lays devices out: slice ``s`` holds group ranks
``s*L .. s*L + L - 1``, and lane ``l`` of slice ``s`` is group rank
``s*L + l``.

:func:`num_slices` counts the nodes of a ``torch.distributed.run`` launch
(world / ``LOCAL_WORLD_SIZE``), where JAX reads the devices'
``slice_index``.  A count given explicitly simulates more slices than
there are nodes (several ranks of one node standing in for a slice each),
as the JAX package's tests simulate slices on CPU devices.

The ``data`` axis of a mesh splits into slices as any group does:
``split_slice_groups(mesh.group("data"))``.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch.distributed as dist

from .collectives import new_group

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_EXPERT = "expert"
AXIS_PIPELINE = "pipeline"
AXIS_SEQUENCE = "sequence"
AXIS_TENSOR = "tensor"

# Outermost (crosses nodes) -> innermost (adjacent ranks), JAX's order.
MESH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_PIPELINE, AXIS_SEQUENCE,
             AXIS_TENSOR)
# Axes over which a batch is split.
BATCH_AXES = (AXIS_DATA, AXIS_FSDP)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each mesh axis; ``-1`` on one axis fills the rest of the
    world (``data=-1`` is data parallelism over every rank)."""

    data: int = -1
    fsdp: int = 1
    expert: int = 1
    pipeline: int = 1
    sequence: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {a: getattr(self, a) for a in MESH_AXES}
        wildcard = [k for k, v in sizes.items() if v == -1]
        if len(wildcard) > 1:
            raise ValueError(
                f"At most one mesh axis may be -1, got {wildcard}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wildcard:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wildcard[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"Mesh axes product {fixed} != device count {n_devices}")
        return sizes


class Mesh:
    """This rank's place on a mesh of ranks: ``shape`` (axis -> size),
    ``coords`` (axis -> this rank's index), ``ranks`` (the world ranks as
    an array of the mesh's shape) and the process groups.  A mesh of one
    rank (or with no process group) has no groups: every axis is 1."""

    def __init__(self, ranks: np.ndarray, rank: int):
        self.ranks = np.asarray(ranks)
        if self.ranks.ndim != len(MESH_AXES):
            raise ValueError(f"a mesh has {len(MESH_AXES)} axes, got "
                             f"{self.ranks.shape}")
        self.shape = dict(zip(MESH_AXES, self.ranks.shape))
        where = np.argwhere(self.ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not once in the mesh")
        self.coords = dict(zip(MESH_AXES, (int(i) for i in where[0])))
        self.rank = rank
        self._groups: dict = {}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axes_size(self, axes) -> int:
        """The product of ``axes``' sizes (one name or several)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def axes_index(self, axes) -> int:
        """This rank's index over ``axes``, row-major in mesh order (its
        rank in ``group(axes)``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        index = 0
        for a in sorted(axes, key=MESH_AXES.index):
            index = index * self.shape[a] + self.coords[a]
        return index

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        in ``axes`` (one name or several), in ``axes_index`` order; None
        when those axes have size 1 (nothing to communicate).
        Collective the first time: every rank creates every such group."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(sorted(set(axes), key=MESH_AXES.index))
        if self.axes_size(axes) == 1:
            return None
        if axes not in self._groups:
            moved = np.moveaxis(self.ranks, [MESH_AXES.index(a)
                                             for a in axes],
                                range(-len(axes), 0))
            members = moved.reshape(-1, self.axes_size(axes))
            mine = None
            for row in members:
                g = new_group([int(r) for r in row])
                if self.rank in row:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]

    @property
    def batch_index(self) -> int:
        """This rank's share of the batch: its index over ``BATCH_AXES``."""
        return self.axes_index(BATCH_AXES)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(config: MeshConfig | None = None, *,
              world: int | None = None, rank: int | None = None) -> Mesh:
    """The mesh of ``config`` over the world's ranks (default: the
    process group's), row-major over ``MESH_AXES``.  ``world``/``rank``
    describe a mesh without a process group (placement decisions and
    tests).  A world of several nodes whose ``data`` size divides the
    node count goes through :func:`make_hybrid_mesh`, as JAX's does."""
    config = config or MeshConfig()
    w, r = _world()
    world = w if world is None else world
    rank = r if rank is None else rank
    sizes = config.resolve(world)
    nodes = num_slices()
    if nodes > 1:
        for axis in (AXIS_DATA, AXIS_FSDP, AXIS_PIPELINE, AXIS_EXPERT):
            if sizes[axis] % nodes == 0:
                return make_hybrid_mesh(config, n_slices=nodes,
                                        dcn_axis=axis, world=world,
                                        rank=rank)
    ranks = np.arange(world).reshape(tuple(sizes[a] for a in MESH_AXES))
    return Mesh(ranks, rank)


def make_hybrid_mesh(config: MeshConfig | None = None,
                     n_slices: int | None = None, dcn_axis: str = AXIS_DATA,
                     *, world: int | None = None,
                     rank: int | None = None) -> Mesh:
    """A mesh whose ``dcn_axis`` spans ``n_slices`` slices of consecutive
    ranks (nodes, or simulated slices), every other axis inside a slice:
    JAX's layout for devices without ``slice_index``."""
    config = config or MeshConfig()
    w, r = _world()
    world = w if world is None else world
    rank = r if rank is None else rank
    if n_slices is None:
        n_slices = num_slices()
    if n_slices < 2:
        raise ValueError(f"hybrid mesh needs >= 2 slices, got {n_slices}")
    if world % n_slices:
        raise ValueError(
            f"{world} devices not divisible into {n_slices} slices")
    sizes = config.resolve(world)
    if sizes[dcn_axis] % n_slices:
        raise ValueError(
            f"DCN axis {dcn_axis!r} has size {sizes[dcn_axis]}, not "
            f"divisible by {n_slices} slices; the {dcn_axis} axis must span "
            "all slices")
    per_slice = dict(sizes)
    per_slice[dcn_axis] = sizes[dcn_axis] // n_slices
    ici_shape = tuple(per_slice[a] for a in MESH_AXES)
    arr = np.arange(world).reshape((n_slices,) + ici_shape)
    arr = np.moveaxis(arr, 0, MESH_AXES.index(dcn_axis))
    return Mesh(arr.reshape(tuple(sizes[a] for a in MESH_AXES)), rank)


def batch_shard_size(mesh) -> int:
    """Number of ways the global batch is split (data x fsdp axes)."""
    return math.prod(mesh.shape[a] for a in BATCH_AXES)


def dcn_axis_name(axis: str) -> str:
    """Name of the cross-slice (DCN) factor of a split axis."""
    return f"{axis}_dcn"


def ici_axis_name(axis: str) -> str:
    """Name of the within-slice (ICI) factor of a split axis."""
    return f"{axis}_ici"


def stripe_lane_perm(ici_size: int, shift: int) -> list[tuple[int, int]]:
    """Rotation over the ICI group: lane ``i`` sends to lane ``(i + shift)
    % ici_size``.  Stripe ``j`` of a DCN payload is rotated ``shift=j``
    lanes before its hop and ``shift=-j`` after it
    (``comm/striping.py``); the rotation stays within one slice."""
    if ici_size < 1:
        raise ValueError(f"ici_size must be >= 1, got {ici_size}")
    return [(i, (i + shift) % ici_size) for i in range(ici_size)]


def num_slices() -> int:
    """The nodes of a ``torch.distributed.run`` launch: world size over
    ``LOCAL_WORLD_SIZE``; 1 without torchrun's env or a process group."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is None or not (dist.is_available() and dist.is_initialized()):
        return 1
    return max(dist.get_world_size() // int(local), 1)


@dataclasses.dataclass(frozen=True)
class SliceGroups:
    """This rank's two tiers of a split group."""

    ici: object            # the L ranks of this rank's slice
    dcn: object            # this lane's rank in each of the S slices
    n_slices: int
    ici_size: int
    slice_index: int
    lane: int


def split_slice_groups(group=None, n_slices: int | None = None, *,
                       axis: str = AXIS_DATA) -> SliceGroups:
    """Split ``group`` (default: the world) into ``n_slices`` slices of
    consecutive group ranks; ``n_slices=None`` takes :func:`num_slices`.

    Refuses a group that does not divide into the slices, and, when the
    world spans several nodes, ranks that are not node-contiguous (global
    rank // ranks-per-node must be torchrun's ``GROUP_RANK``) or slices
    that would span two nodes: those are the layouts on which the ICI
    tier would cross nodes, which JAX refuses as a mesh that is not
    slice-major.  Collective: every rank of the world creates every ICI
    and DCN group, in the same order."""
    if n_slices is None:
        n_slices = num_slices()
    ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
    size = len(ranks)
    if n_slices < 1 or size % n_slices:
        raise ValueError(
            f"axis {axis!r} (size {size}) not divisible into {n_slices} "
            "slices")
    per_slice = size // n_slices
    nodes = num_slices()
    if nodes > 1:
        # Every rank checks every rank's node, so all raise together.
        node_of = [None] * dist.get_world_size()
        dist.all_gather_object(node_of, int(os.environ.get("GROUP_RANK", 0)))
        per_node = dist.get_world_size() // nodes
        contiguous = all(node_of[r] == r // per_node for r in ranks)
        one_node = all(node_of[ranks[s * per_slice]]
                       == node_of[ranks[s * per_slice + per_slice - 1]]
                       for s in range(n_slices))
        if not (contiguous and one_node):
            raise ValueError(
                f"process group of axis {axis!r} is not slice-major over "
                f"{n_slices} slices on {nodes} nodes (node of each rank: "
                f"{node_of}); launch the ranks of each node contiguously "
                "(torchrun's --node_rank order) with whole slices per node")
    mine = ranks.index(dist.get_rank())
    ici = dcn = None
    for s in range(n_slices):
        g = new_group(ranks[s * per_slice:(s + 1) * per_slice])
        if mine // per_slice == s:
            ici = g
    for lane in range(per_slice):
        g = new_group(ranks[lane::per_slice])
        if mine % per_slice == lane:
            dcn = g
    return SliceGroups(ici=ici, dcn=dcn, n_slices=n_slices,
                       ici_size=per_slice, slice_index=mine // per_slice,
                       lane=mine % per_slice)
