"""The slice half of the JAX package's ``comm/mesh.py``: the two-tier view
of a data-parallel process group that the hierarchical gradient sync
(``comm/hierarchical.py``) runs on.

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

``MeshConfig``, ``make_mesh`` and ``make_hybrid_mesh`` wait for the
model-parallel slice of the port.
"""

from __future__ import annotations

import dataclasses
import os

import torch.distributed as dist

from .collectives import new_group

AXIS_DATA = "data"


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
