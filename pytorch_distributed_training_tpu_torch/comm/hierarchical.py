"""The two-tier gradient sync (``--grad-sync``): the counterpart of the
JAX package's ``comm/hierarchical.py`` over ``torch.distributed`` process
groups.

The reference syncs gradients with DDP's one bucketed all-reduce
(``src/main.py:78``).  Across nodes that all-reduce moves every f32 byte
over the slow inter-node links.  The two-tier sync takes explicit control
of it, bucket by bucket (``comm.compress._BucketLayout``), in three
phases:

1. **reduce-scatter over the ICI group** (the ranks of one node): each
   rank ends with its node's partial sum of a 1/L shard of every bucket;
2. **all-reduce over the DCN group** (the same lane on every node): only
   the 1/L shards cross nodes, as f32 (``hier``), bf16 (``hier-bf16``,
   sent as its bit pattern), int8 or packed int4 with a per-bucket scale
   (``hier-int8``, ``hier-int4``), or magnitude top-k (``hier-topk``).
   The lossy modes carry error-feedback residuals in
   ``TrainState.grad_sync_residual``: the error ``err - decode(encode(
   err))`` of one sync is added to the next one's input.  A compressed
   payload is all-gathered and every node decodes and sums the payloads
   in f32;
3. **all-gather over the ICI group**: every rank gets the whole mean.

``stripe`` spreads each DCN payload over several lanes' links and
``phase_overlap`` pipelines the three phases over the buckets
(``comm/striping.py``); both are bitwise the serial schedule.  Under
gradient accumulation with ``overlap`` microbatch ``i-1``'s gradients are
synced beside microbatch ``i``'s compute (``parallel/grad_accum.py``).

The group splits into slices as ``comm/mesh.py::split_slice_groups``
says: the nodes of a torchrun launch, or an explicit ``n_slices``.  The
sync runs on each rank's own gradients (JAX runs the forward and backward
per device inside a ``shard_map`` for the same reason), and the loss and
aux values are averaged over the group.

ZeRO-1 (``zero1``, JAX's ``GradSyncConfig(zero1=True)``) syncs once a
step, after the accumulation (``overlap`` is forced off, as in JAX, so
the compressed hop quantizes the same sums).  JAX then skips the
trailing ICI all-gather and hands each device its scattered columns of
the buckets.  The port's ZeRO-1 slots keep JAX's per-leaf largest-dim
layout (``parallel/sharding.py::ZERO1_OPT_RULES``), not the buckets', so
the sync keeps its ICI all-gather and the sharded step takes each
rank's slot slices of the whole mean (``parallel/sharded.py::
scatter_grads``): the same values, no f32 bytes across the DCN.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import collectives
from .collectives import Pending
from .compress import (
    _BucketLayout,
    _MODE_CODEC,
    auto_bucket_mb,
    bucket_wire_bytes,
    decode_int4,
    decode_int8,
    decode_topk,
    encode_int4,
    encode_int8,
    encode_topk,
)
from .mesh import AXIS_DATA, split_slice_groups
from .striping import (
    ici_bytes_per_sync,
    pipelined_sync,
    resolve_stripe,
    striped_dcn_hop,
)

GRAD_SYNC_MODES = (
    "flat", "hier", "hier-bf16", "hier-int8", "hier-int4", "hier-topk",
)

# Modes whose DCN payload carries error-feedback residuals.
_EF_MODES = frozenset({"hier-int8", "hier-int4", "hier-topk"})

# Packing granularity the codec imposes on the per-rank shard width: int4
# packs nibble pairs, top-k an 8-bit index bitmap.
_CODEC_PACK = {"int4": 2, "topk": 8}


@dataclasses.dataclass(frozen=True)
class GradSyncConfig:
    """How the gradient all-reduce is performed (JAX's fields and checks).

    ``mode``: ``flat`` is the one all-reduce of ``--distributed`` (no
    ``GradSync`` is built for it); the ``hier*`` modes are the two-tier
    sync with the DCN payload in f32, bf16, int8, int4 or top-k.
    ``n_slices=None`` takes the node count.  ``bucket_mb`` is DDP's
    ``bucket_cap_mb``, ``"auto"`` for ``comm.compress.auto_bucket_mb``.
    ``overlap`` syncs once per microbatch beside the next one's compute
    (off: once after the accumulation).  ``topk_frac`` is the
    transmitted fraction of ``hier-topk``.  ``stripe`` (``"off"``,
    ``"auto"`` or a lane count) and ``phase_overlap`` are the transport
    transforms of ``comm/striping.py``.  ``zero1`` (ZeRO-1's
    step, module docstring) implies ``overlap=False``."""

    mode: str = "hier"
    axis: str = AXIS_DATA
    n_slices: int | None = None
    bucket_mb: float | str = "auto"
    overlap: bool = True
    zero1: bool = False
    topk_frac: float = 0.1
    stripe: int | str = "off"
    phase_overlap: bool = False

    def __post_init__(self):
        if self.mode not in GRAD_SYNC_MODES:
            raise ValueError(
                f"grad-sync mode {self.mode!r} not in {GRAD_SYNC_MODES}"
            )
        if isinstance(self.stripe, str):
            if self.stripe not in ("auto", "off"):
                try:
                    object.__setattr__(self, "stripe", int(self.stripe))
                except ValueError:
                    raise ValueError(
                        f"stripe must be 'auto', 'off', or a lane count, "
                        f"got {self.stripe!r}"
                    ) from None
        if isinstance(self.stripe, int) and self.stripe < 1:
            raise ValueError(
                f"stripe lane count must be >= 1, got {self.stripe}"
            )
        if isinstance(self.bucket_mb, str):
            if self.bucket_mb != "auto":
                raise ValueError(
                    f"bucket_mb must be 'auto' or a positive number, got "
                    f"{self.bucket_mb!r}"
                )
        elif not self.bucket_mb > 0:
            raise ValueError(f"bucket_mb must be > 0, got {self.bucket_mb}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(
                f"topk_frac must be in (0, 1], got {self.topk_frac}"
            )


class GradSync:
    """The two-tier sync bound to one (group, params, config): the split
    groups, the stripe, the bucket size and the layout are fixed here.
    Every rank of ``group`` builds it at the same point (the split
    creates process groups)."""

    def __init__(self, group, params: dict, config: GradSyncConfig):
        if config.mode == "flat":
            raise ValueError(
                "GradSync is the explicit two-tier engine; mode='flat' "
                "means the one data-parallel all-reduce — don't construct "
                "a GradSync"
            )
        self.config = config
        self.group = group
        dist = torch.distributed
        size = dist.get_world_size(group) if dist.is_initialized() else 1
        if size == 1:
            # Before the split: a one-rank group has nothing to split.
            raise ValueError(
                f"hierarchical grad sync over axis {config.axis!r} needs "
                f"size > 1, got a trivial axis (group of {size} rank)"
            )
        self.groups = split_slice_groups(group, config.n_slices,
                                         axis=config.axis)
        self.n_slices = self.groups.n_slices
        self.ici_size = self.groups.ici_size
        self.axis_size = size
        total_bytes = 4 * sum(p.numel() for p in params.values())
        self.stripe = resolve_stripe(
            config.stripe, ici_size=self.ici_size, n_slices=self.n_slices
        )
        self.phase_overlap = bool(config.phase_overlap)
        if config.bucket_mb == "auto":
            self.bucket_policy = "auto"
            self.bucket_mb = auto_bucket_mb(
                total_bytes, mode=config.mode, topk_frac=config.topk_frac,
                phase_overlap=self.phase_overlap,
            )
        else:
            self.bucket_policy = "manual"
            self.bucket_mb = float(config.bucket_mb)
        pack = _CODEC_PACK.get(_MODE_CODEC[config.mode], 1)
        self.layout = _BucketLayout.build(
            params, bucket_mb=self.bucket_mb, divisor=self.axis_size * pack
        )
        self.overlap = config.overlap and not config.zero1
        self._device = next(iter(params.values())).device

    # ---- residual state (error feedback) -------------------------------

    @property
    def has_residual(self) -> bool:
        return self.config.mode in _EF_MODES

    def init_residual(self) -> Any:
        """This rank's error-feedback residual: zeros (n_buckets,
        bucket_elems / L) f32, its row of JAX's (axis_size, n_buckets,
        shard) array; ``()`` for modes without error feedback."""
        if not self.has_residual:
            return ()
        shard = self.layout.bucket_elems // self.ici_size
        return torch.zeros((self.layout.n_buckets, shard),
                           dtype=torch.float32, device=self._device)

    # ---- the three phases ------------------------------------------------

    def _dcn_hop(self, x: torch.Tensor, gather: bool, async_op: bool):
        """The DCN all-gather (stacked on a new leading axis) or psum of
        one payload component, striped over the ICI lanes."""
        def hop(s, async_op):
            if gather:
                return collectives.all_gather(s, self.groups.dcn,
                                              tiled=False, async_op=async_op)
            return collectives.psum(s.contiguous(), self.groups.dcn,
                                    async_op=async_op)

        return striped_dcn_hop(x, hop, ici_group=self.groups.ici,
                               ici_size=self.ici_size,
                               n_stripes=self.stripe, async_op=async_op)

    def _dcn_allreduce(self, part: torch.Tensor, residual: Any,
                       async_op: bool = False):
        """Cross-slice all-reduce of the (rows, shard) ICI partials:
        ``(summed, new_residual)``.  The compressed modes all-gather the
        encoded payload (never f32) and decode and sum it in f32; bf16
        components cross as their int16 bit pattern, as JAX bitcasts
        them to u16, so no conversion can widen them on the wire."""
        mode = self.config.mode
        if mode == "hier":
            hop = self._dcn_hop(part, False, True)
            return _later(lambda: (hop.wait(), residual), async_op)
        if mode == "hier-bf16":
            hop = self._dcn_hop(part.to(torch.bfloat16).view(torch.int16),
                                True, True)

            def finish():
                gathered = hop.wait().view(torch.bfloat16)
                return gathered.float().sum(dim=0), residual

            return _later(finish, async_op)
        err = part + residual
        cols = err.shape[-1]
        if mode == "hier-int8":
            payload, decode = encode_int8(err), decode_int8
        elif mode == "hier-int4":
            payload, decode = encode_int4(err), decode_int4
        elif mode == "hier-topk":
            payload = encode_topk(err, self.config.topk_frac)

            def decode(b, q, s):
                return decode_topk(b, q, s, cols)
        else:
            raise ValueError(f"unknown grad-sync mode {mode!r}")
        new_residual = err - decode(*payload)
        hops = [self._dcn_hop(p.view(torch.int16)
                              if p.dtype == torch.bfloat16 else p, True, True)
                for p in payload]

        def finish():
            gathered = [h.wait() for h in hops]
            gathered = [g.view(torch.bfloat16) if p.dtype == torch.bfloat16
                        else g for g, p in zip(gathered, payload)]
            s, rows = gathered[0].shape[:2]
            flat = [g.reshape(s * rows, *g.shape[2:]) for g in gathered]
            decoded = decode(*flat).view(s, rows, cols)
            return decoded.sum(dim=0), new_residual

        return _later(finish, async_op)

    def _rs(self, rows: torch.Tensor, async_op: bool = False):
        return collectives.reduce_scatter(rows, self.groups.ici,
                                          scatter_axis=1, async_op=async_op)

    def _ag(self, rows: torch.Tensor, async_op: bool = False):
        return collectives.all_gather(rows, self.groups.ici, gather_axis=1,
                                      async_op=async_op)

    def _sync_buckets(self, buckets: torch.Tensor, residual: Any,
                      async_op: bool = False):
        """(n_buckets, elems) local sums → their mean over the group, and
        the new residual: reduce-scatter over ICI, the compressed
        all-reduce over DCN, all-gather over ICI; under
        ``phase_overlap`` the wavefront of ``comm/striping.py``.  Under
        ``async_op`` it returns a :class:`Pending` once the serial
        schedule's reduce-scatter is issued (the wavefront starts when
        it is waited on)."""
        # The mean's scale comes before the hop, so the residual lives in
        # the units it is re-fed in.
        buckets = buckets * (1.0 / self.axis_size)
        if self.phase_overlap and self.layout.n_buckets > 1:
            return _later(lambda: pipelined_sync(
                buckets, residual, rs=self._rs, dcn=self._dcn_allreduce,
                ag=self._ag, has_residual=self.has_residual,
            ), async_op)
        part = self._rs(buckets, async_op=True)

        def finish():
            summed, new = self._dcn_allreduce(part.wait(), residual)
            return self._ag(summed), new

        return _later(finish, async_op)

    def _sync_tree(self, grads: list, residual: Any, async_op: bool = False):
        """The accumulation's sync contract: f32 gradients in the
        layout's order of names → their group mean, and the residual;
        under ``async_op`` a :class:`Pending` of them (``_sync_buckets``),
        so the next microbatch computes while the sync is in flight."""
        pending = self._sync_buckets(self.layout.flatten(grads), residual,
                                     async_op=True)

        def done():
            synced, new = pending.wait()
            return list(self.layout.unflatten(synced).values()), new

        return _later(done, async_op)

    # ---- the entry point -------------------------------------------------

    def accumulate_and_sync(self, loss_fn: Callable, params: dict,
                            batch: dict, num_microbatches: int, *,
                            residual: Any, has_aux: bool = False):
        """``accumulate_gradients`` with the two-tier sync: ``loss_fn(
        params, microbatch, i)`` on this rank's rows, as the train step
        builds it.  Returns ``(value, grads, new_residual)`` with the loss
        (and aux) averaged over the group and the gradients the group's
        mean, cast like the parameters."""
        from ..parallel.grad_accum import (
            accumulate_gradients, tree_leaves, tree_unflatten,
        )

        value, grads, residual = accumulate_gradients(
            loss_fn, params, batch, num_microbatches, has_aux=has_aux,
            pass_microbatch_index=True, sync_fn=self._sync_tree,
            sync_carry=residual, sync_overlap=self.overlap,
        )
        means = collectives.pmean([v.float() for v in tree_leaves(value)],
                                  self.group)
        return tree_unflatten(value, means), grads, residual

    # ---- accounting -----------------------------------------------------

    def dcn_bytes_per_sync(self) -> int:
        """Analytic bytes crossing between slices for ONE sync."""
        return dcn_bytes_per_sync(
            self.layout.padded, self.n_slices, self.ici_size,
            self.config.mode, n_buckets=self.layout.n_buckets,
            topk_frac=self.config.topk_frac,
        )

    def ici_bytes_per_sync(self) -> int:
        """Analytic within-slice bytes for ONE sync, the stripe rotations
        included (``comm.striping.ici_bytes_per_sync``)."""
        return ici_bytes_per_sync(
            self.layout.padded, self.n_slices, self.ici_size,
            self.config.mode, n_buckets=self.layout.n_buckets,
            topk_frac=self.config.topk_frac, stripe=self.stripe,
        )

    @property
    def overlap_depth(self) -> int:
        """Buckets in flight under the pipelined schedule (1 = serial)."""
        return self.layout.n_buckets if self.phase_overlap else 1

    def syncs_per_step(self, num_microbatches: int) -> int:
        return num_microbatches if self.overlap else 1


def _later(finish: Callable, async_op: bool):
    """``finish`` as a :class:`Pending` (``async_op``) or its result."""
    pending = Pending([], finish)
    return pending if async_op else pending.wait()


def dcn_bytes_per_sync(
    n_elems: int, n_slices: int, ici_size: int, mode: str,
    *, n_buckets: int = 1, topk_frac: float = 0.1,
) -> int:
    """Inter-slice bytes of one sync of ``n_elems`` (the padded layout
    total) f32 gradients, JAX's model: ``flat`` and ``hier`` move
    ``2*(S-1)`` f32 shards a rail (a ring reduce-scatter and all-gather
    over the S slices), the compressed modes all-gather ``S*(S-1)``
    encoded payloads a rail (``bucket_wire_bytes`` per bucket row); L
    rails."""
    if n_slices <= 1:
        return 0
    shard = n_elems // ici_size
    if mode in ("flat", "hier"):
        per_rail = 2 * (n_slices - 1) * shard * 4
    else:
        codec = _MODE_CODEC.get(mode)
        if codec is None:
            raise ValueError(f"unknown mode {mode!r}")
        row = shard // n_buckets
        per_rail = (n_slices * (n_slices - 1)) * n_buckets * \
            bucket_wire_bytes(row, codec, topk_frac=topk_frac)
    return per_rail * ici_size

