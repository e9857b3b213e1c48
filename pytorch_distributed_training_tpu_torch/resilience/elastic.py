"""Elastic world resizing: shrink-to-survivors, peer-RAM state, grow-back.
The counterpart of the JAX package's ``resilience/elastic.py``
(``--elastic-resize``), over real ``torch.distributed`` ranks where JAX
simulates a multi-slice mesh on one controller.

The supervised ``--elastic`` path kills the world on any failure and
relaunches it at the same size from a disk checkpoint.  Losing one slice
of a multi-slice data-parallel run leaves a healthy slice idling through
that backoff and restore.  This plane keeps it training instead:

- **detection** (:class:`SliceHealthMonitor`) from heartbeat staleness,
  never from exit codes: a rank more than ``patience_steps`` boundaries
  stale takes its slice with it, and a shorter stall is flagged as a
  ``host_stall`` anomaly without a death (``host_hang@N:S``,
  :data:`~.faults.ELASTIC_FAULT_KINDS`).
- **peer-redundant snapshots** (:class:`PeerSnapshotStore`): on the
  snapshot cadence the state's learned fields are serialized to raw
  bytes, split into one equal row per rank, and each row is mirrored to
  a buddy rank on the next slice, so losing one slice loses no row.  Raw
  bytes because the restore contract is bit-identity for every dtype;
  the lossy grad-sync codecs are refused.  Wire cost is priced with
  ``comm.compress.bucket_wire_bytes``, as JAX prices it.
- **resize** (:func:`run_elastic_episode`): on a loss the survivors roll
  back to the last committed peer snapshot (restored leaves pinned
  bit-identical), step over the survivors' group, and keep the global
  batch (a pure function of the global step) by scaling accumulation by
  the world ratio.
- **grow-back**: the returning slice waits on the supervisor's
  :class:`~..utils.backoff.BackoffPolicy`, receives the current state
  from a survivor, and the run re-expands at a step boundary.

Every transition is an ``elastic_transition`` record mirrored into the
``elastic_*`` counters, and the goodput ledger's identity
``sum(categories) == wall`` holds in integer ns through the episode: the
episode runs against a virtual clock in multiples of 2^-3 s (the
discipline of ``analysis/ledger_audit.py``), so every total is one exact
integer, whatever the model or the world size.

**Across ranks.**  Each rank of the group is one of JAX's devices, and
every rank runs the same deterministic script under the same virtual
clock, so all reach the same verdicts:

- Control plane: at each step boundary one all-gather over the world
  carries every rank's heartbeat (a silent or hung rank sends none) and
  its fire decision, which must equal rank 0's.  Rank 0 alone writes
  the fault markers (``state_dir``); their state at the start crosses to
  the other ranks once.  The "lost" ranks stay alive, as JAX's devices
  do, and keep joining this gather through the shrunk window.  Rank 0
  keeps the emitter (it records the beats, as JAX's ``beats()`` does);
  the ledger and the report are kept on every rank and agree.  A closing
  gather hands every rank the survivors' final step and restore verdict,
  so rank 0's report holds even when its own slice was the lost one.
- Data plane: ``train/step.py``'s data-parallel step over the active
  ranks' group, each rank on its rows of the global batch in JAX's
  microbatch order (``data.loader.rank_rows``).  The world's group and
  each "world without slice k" group are built once at the start
  (``new_group`` is collective over every rank), so no group is created
  while a slice is silent, and in the shrunk window every data-plane
  collective runs on the survivors' group only.
- Snapshots (:class:`PeerSnapshotStore` built with a group): rank r
  holds its own row and the mirror of the rank whose buddy it is; a row
  crosses by ``comm.collectives.ppermute`` (host bytes over gloo).  Each
  rank hashes only its own row at a commit (SHA-256; the row digests are
  all-gathered, and the committed digest is the SHA-256 of their
  concatenation); at a restore each survivor hashes the rows it serves
  and they are held to the committed row digests, then the rows are
  gathered over the survivors' group, the primary where the owner lives
  and the mirror where it does not.
- Grow: the returning slice receives the state by one broadcast over
  the world from the lowest survivor.

The snapshot carries every learned leaf bit for bit, the counts
included: the port's Adam count is a Python int (8 bytes, int64, in the
blob; it comes back an int) where JAX's is a 0-dim int32 array, so the
port's blob is 4 bytes longer than JAX's for the same model.

JAX runs its episode with the persistent compilation cache off (a
cache-deserialized executable corrupted its heap after the survivor-mesh
interlude); the port compiles nothing, so that workaround has no twin.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Iterable

import numpy as np
import torch

from ..utils.backoff import BackoffPolicy
from .faults import (
    ELASTIC_FAULT_KINDS, Fault, _FiredMarkers, parse_elastic_faults,
)

# The learned fields of a TrainState a snapshot carries (the JAX
# package's resilience/recovery.py list).
SNAPSHOT_FIELDS = ("params", "opt_state", "batch_stats", "grad_sync_residual")

# The transition kinds an ``elastic_transition`` record may carry.
ELASTIC_TRANSITIONS = ("shrink", "peer_restore", "grow")

# Where a restore's payload came from; stamped on the checkpoint_restore
# record so the provenance survives into the post-mortem.
RESTORE_SOURCES = ("disk", "peer")

# Scripted ledger durations (seconds).  All multiples of 2^-3, so every
# expected category total is one exact integer in ns.
COMPILE_S = 2.0          # initial compile of the train step
RESHAPE_COMPILE_S = 0.5  # recompile at the resized world
PULL_S = 0.125           # input pull per step -> data_wait
DISPATCH_S = 0.25        # batch-ready -> dispatch
TAIL_S = 0.125           # post-dispatch host tail
SNAP_S = 0.25            # peer snapshot staging + mirror -> ckpt_save
PEER_RESTORE_S = 0.25    # one-hop RAM restore -> ckpt_restore
DISK_RESTORE_S = 2.0     # the disk fallback's manifest walk (bench leg)
GROW_SYNC_S = 0.25       # buddy -> returning slice state transfer
BACKOFF_BASE_S = 0.5     # BackoffPolicy base for the re-entry wait
EPOCH_TAIL_S = 0.125     # episode-end bookkeeping -> other


class _VirtualClock:
    """Monotonic clock the episode advances explicitly."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Knobs of the membership plane (CLI ``--elastic-resize``)."""

    n_slices: int = 2
    # Heartbeat staleness (in step boundaries) past which a silent rank
    # takes its slice down.  Staleness at or below it only flags.
    patience_steps: int = 3
    # Staleness that flags a host_stall anomaly without a death.
    stall_flag_after: int = 1
    snapshot_every_steps: int = 2


class SliceHealthMonitor:
    """Slice liveness from per-rank heartbeat staleness — never exit codes.

    :meth:`ingest` consumes one heartbeat event per rank per step
    boundary and :meth:`observe` turns staleness into verdicts: a rank
    more than ``patience_steps`` boundaries stale declares its whole
    slice lost (a data-parallel collective with a silent member hangs
    every survivor, so slice granularity is the only safe one), and a
    rank past ``stall_flag_after`` but within patience raises a
    ``host_stall`` anomaly once per stall episode.
    """

    def __init__(
        self,
        world_size: int,
        n_slices: int,
        *,
        patience_steps: int = 3,
        stall_flag_after: int = 1,
        emitter=None,
    ):
        if world_size % n_slices:
            raise ValueError(
                f"world {world_size} not divisible into {n_slices} slices"
            )
        if not 0 < stall_flag_after <= patience_steps:
            raise ValueError(
                f"want 0 < stall_flag_after <= patience_steps, got "
                f"{stall_flag_after}/{patience_steps}"
            )
        self.world_size = world_size
        self.n_slices = n_slices
        self.per_slice = world_size // n_slices
        self.patience_steps = patience_steps
        self.stall_flag_after = stall_flag_after
        self.emitter = emitter
        self._last_beat = {r: -1 for r in range(world_size)}
        self._stall_flagged: set[int] = set()
        self.host_stalls = 0

    def slice_of(self, rank: int) -> int:
        return rank // self.per_slice

    def ingest(self, event: dict[str, Any]) -> None:
        """Consume one heartbeat event (``kind="heartbeat"`` with
        ``step`` and ``hb_rank`` fields, as the episode emits them)."""
        if event.get("kind") != "heartbeat":
            return
        rank, step = int(event["hb_rank"]), int(event["step"])
        if step > self._last_beat[rank]:
            self._last_beat[rank] = step

    def staleness(self, rank: int, step: int) -> int:
        return step - self._last_beat[rank]

    def observe(self, step: int) -> dict[str, Any]:
        """Verdicts at boundary ``step``: ``lost_slices`` (sorted) and
        ``stalled_ranks`` (silent past the flag threshold but within
        patience)."""
        lost: set[int] = set()
        stalled: list[int] = []
        for rank in range(self.world_size):
            stale = self.staleness(rank, step)
            if stale > self.patience_steps:
                lost.add(self.slice_of(rank))
            elif stale > self.stall_flag_after:
                stalled.append(rank)
                if rank not in self._stall_flagged:
                    self._stall_flagged.add(rank)
                    self.host_stalls += 1
                    if self.emitter is not None:
                        self.emitter.anomaly(
                            "host_stall", step=step, stalled_rank=rank,
                            staleness_steps=stale,
                        )
            else:
                self._stall_flagged.discard(rank)
        return {"lost_slices": sorted(lost), "stalled_ranks": stalled}


# ---------------------------------------------------------------------- #
# the learned fields as leaves: flatten, serialize, rebuild
# ---------------------------------------------------------------------- #


def _flatten(tree: Any, path: str) -> tuple[list, tuple]:
    """``(leaves, treedef)`` of a state subtree: leaves are ``(path,
    tensor-or-int)`` in a fixed order; dicts, lists, tuples, dataclasses
    and None are structure."""
    if isinstance(tree, torch.Tensor) or (
            isinstance(tree, int) and not isinstance(tree, bool)):
        return [(path, tree)], ("leaf",)
    if tree is None:
        return [], ("none",)
    if isinstance(tree, dict):
        leaves, kids = [], []
        for k, v in tree.items():
            sub, d = _flatten(v, f"{path}/{k}")
            leaves += sub
            kids.append(d)
        return leaves, ("dict", tuple(tree), tuple(kids))
    if isinstance(tree, (list, tuple)):
        leaves, kids = [], []
        for i, v in enumerate(tree):
            sub, d = _flatten(v, f"{path}/{i}")
            leaves += sub
            kids.append(d)
        return leaves, (type(tree).__name__, tuple(kids))
    if dataclasses.is_dataclass(tree):
        names = tuple(f.name for f in dataclasses.fields(tree))
        leaves, kids = [], []
        for n in names:
            sub, d = _flatten(getattr(tree, n), f"{path}/{n}")
            leaves += sub
            kids.append(d)
        return leaves, ("dataclass", type(tree), names, tuple(kids))
    raise TypeError(f"{path}: a snapshot cannot carry a {type(tree).__name__}")


def _unflatten(treedef: tuple, leaves: Iterable) -> Any:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind in ("list", "tuple"):
            items = [build(c) for c in d[1]]
            return items if kind == "list" else tuple(items)
        return d[1](**{n: build(c) for n, c in zip(d[2], d[3])})

    return build(treedef)


def _state_leaves(state) -> tuple[list, tuple]:
    """The learned fields' leaves (paths like ``opt_state/0/count``) and
    their treedef."""
    return _flatten({f: getattr(state, f) for f in SNAPSHOT_FIELDS}, "")


def _specs(leaves: list) -> list[tuple]:
    """``(path, kind, dtype, shape)`` per leaf: a host int travels as
    int64 (``kind="int"``) and comes back an int."""
    out = []
    for path, v in leaves:
        if isinstance(v, torch.Tensor):
            out.append((path.lstrip("/"), "tensor", v.dtype, tuple(v.shape)))
        else:
            out.append((path.lstrip("/"), "int", torch.int64, ()))
    return out


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _nbytes(spec: tuple) -> int:
    _, _, dtype, shape = spec
    return int(np.prod(shape, dtype=np.int64)) * _itemsize(dtype)


def _blob(leaves: list) -> torch.Tensor:
    """The leaves' raw bytes, concatenated, as one uint8 tensor on the
    first tensor leaf's device."""
    device = next((v.device for _, v in leaves
                   if isinstance(v, torch.Tensor)), torch.device("cpu"))
    parts = []
    for _, v in leaves:
        t = (v.detach() if isinstance(v, torch.Tensor)
             else torch.tensor(v, dtype=torch.int64))
        parts.append(t.to(device).contiguous().reshape(-1).view(torch.uint8))
    if not parts:
        return torch.empty(0, dtype=torch.uint8, device=device)
    return torch.cat(parts)


def _parse(blob: torch.Tensor, specs: list, treedef: tuple) -> Any:
    """Rebuild the committed tree from its bytes (host tensors; int
    leaves as ints)."""
    leaves, off = [], 0
    for spec in specs:
        n = _nbytes(spec)
        raw = blob[off:off + n]
        if off % _itemsize(spec[2]):
            raw = raw.clone()   # a view of another dtype needs alignment
        t = raw.view(spec[2]).reshape(spec[3])
        leaves.append(int(t) if spec[1] == "int" else t)
        off += n
    return _unflatten(treedef, leaves)


def _committed_copy(state) -> list:
    """Every learned leaf as ``(path, tensor or int)``, the tensors cloned
    where they lie: the committed copy the peer restore is pinned
    against."""
    leaves, _ = _state_leaves(state)
    return [(p, v.detach().clone() if isinstance(v, torch.Tensor)
             else int(v)) for p, v in leaves]


def _same_leaves(state, committed: list) -> bool:
    """Each learned leaf of ``state`` equal to ``committed``'s in kind,
    dtype, shape and bytes."""
    leaves, _ = _state_leaves(state)
    if [p for p, _ in leaves] != [p for p, _ in committed]:
        return False
    for (_, a), (_, b) in zip(leaves, committed):
        if isinstance(a, torch.Tensor) != isinstance(b, torch.Tensor):
            return False
        if not isinstance(a, torch.Tensor):
            if a != b:
                return False
        elif (a.dtype != b.dtype or a.shape != b.shape
              or not torch.equal(a.reshape(-1).view(torch.uint8),
                                 b.reshape(-1).view(torch.uint8))):
            return False
    return True


def _assign(live: Any, new: Any) -> Any:
    """``live`` with ``new``'s values: tensors copied in place (the
    model's parameters stay its parameters), ints replaced; returns the
    updated tree."""
    if isinstance(live, torch.Tensor):
        if new is not live:
            with torch.no_grad():
                live.copy_(new)
        return live
    if isinstance(live, int) or live is None:
        return new
    if isinstance(live, dict):
        for k in live:
            live[k] = _assign(live[k], new[k])
        return live
    if isinstance(live, list):
        for i in range(len(live)):
            live[i] = _assign(live[i], new[i])
        return live
    if isinstance(live, tuple):
        return tuple(_assign(a, b) for a, b in zip(live, new))
    for f in dataclasses.fields(live):
        setattr(live, f.name, _assign(getattr(live, f.name),
                                      getattr(new, f.name)))
    return live


def _load(state, tree: dict, step: int):
    """``state`` holding ``tree``'s learned fields at ``step``."""
    return dataclasses.replace(state, step=int(step), **{
        f: _assign(getattr(state, f), tree[f]) for f in SNAPSHOT_FIELDS})


# ---------------------------------------------------------------------- #
# small collectives of the control plane
# ---------------------------------------------------------------------- #


def _wire_device(group) -> torch.device:
    """Where a group's payloads live: the card for NCCL, else the host."""
    import torch.distributed as dist

    if dist.get_backend(group) == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather_ints(values: list[int], group) -> list[list[int]]:
    """Every member's ``values`` (equal lengths), in group-rank order."""
    from ..comm import collectives

    x = torch.tensor(values, dtype=torch.int64, device=_wire_device(group))
    n = torch.distributed.get_world_size(group)
    return collectives.all_gather(x, group).view(n, -1).tolist()


def _broadcast_leaves(leaves: list, group, src: int) -> list:
    """``leaves`` ((path, value) pairs) with every value the group's rank
    ``src``'s: the tensors in place, the Python ints over an int64 wire.
    ``src`` is a rank within ``group``."""
    from ..comm import collectives

    collectives.broadcast([v for _, v in leaves
                           if isinstance(v, torch.Tensor)], group, src=src)
    ints = [v for _, v in leaves if not isinstance(v, torch.Tensor)]
    if not ints:
        return leaves
    wire = torch.tensor(ints, dtype=torch.int64, device=_wire_device(group))
    collectives.broadcast([wire], group, src=src)
    new = iter(wire.tolist())
    return [(p, v if isinstance(v, torch.Tensor) else next(new))
            for p, v in leaves]


# ---------------------------------------------------------------------- #
# the peer snapshot tier
# ---------------------------------------------------------------------- #


class PeerSnapshotStore:
    """In-memory snapshots, row-sharded over ranks with cross-slice buddies.

    The committed state's learned fields (:data:`SNAPSHOT_FIELDS`) are
    serialized leaf by leaf to raw bytes, concatenated, padded, and split
    into one equal byte row per rank.  Rank ``r`` keeps its own row; its
    buddy (the same position on the NEXT active slice) keeps a mirror, so
    losing any one slice loses no row.  Raw bytes, not the grad codecs'
    f32 flatten, because the restore contract is BIT-identity for every
    dtype in the tree; the lossy codecs are refused.  Wire cost per
    mirror hop is ``comm.compress.bucket_wire_bytes`` of the row's f32
    columns, the table the grad sync prices its DCN traffic with.

    Built without a group it is JAX's one-process store: every row and
    mirror in this process (``_primary`` / ``_mirror``: rank -> bytes),
    the whole blob hashed.  Built with ``process_group`` (the world) it
    runs across ranks (module docstring): ``put(step, state, ranks=,
    group=)`` is collective over ``group``, the active ranks' group (a
    rank outside ``ranks`` keeps the bookkeeping only), and ``restore(
    group=)`` over the survivors'.
    """

    def __init__(
        self,
        world_size: int,
        n_slices: int,
        *,
        codec: str = "f32",
        emitter=None,
        process_group=None,
    ):
        if world_size % n_slices:
            raise ValueError(
                f"world {world_size} not divisible into {n_slices} slices"
            )
        if codec != "f32":
            raise ValueError(
                f"peer snapshots require the lossless f32 codec, got "
                f"{codec!r}: the restore contract is bit-identity, which "
                "no lossy grad-sync codec (bf16/int8/int4/topk) can honor"
            )
        self.world_size = world_size
        self.n_slices = n_slices
        self.per_slice = world_size // n_slices
        self.codec = codec
        self.emitter = emitter
        self.group = process_group
        self.me = (torch.distributed.get_rank(process_group)
                   if process_group is not None else None)
        self.committed_step: int | None = None
        self._committed_ranks: list[int] = []
        self._specs: list[tuple] | None = None
        self._treedef = None
        self._blob_len = 0
        self._row = 0
        self._digest: str | None = None
        self._ranks: list[int] = list(range(world_size))
        self._primary: dict[int, bytes] = {}
        self._mirror: dict[int, bytes] = {}
        # Across ranks: who holds each committed row's mirror, the row
        # digests, and this rank's two rows (tensors).
        self._holder: dict[int, int | None] = {}
        self._row_digests: list[bytes] | None = None
        self._own: torch.Tensor | None = None
        self._mirror_of: int | None = None
        self._mirror_row: torch.Tensor | None = None
        self.total_wire_bytes = 0

    def buddy(self, rank: int, ranks: list[int] | None = None) -> int | None:
        """The rank holding ``rank``'s mirror: same position on the next
        active slice, or None when only one slice is active (degraded —
        no peer tier, disk is the only fallback)."""
        ranks = self._ranks if ranks is None else ranks
        slices = sorted({r // self.per_slice for r in ranks})
        if len(slices) < 2:
            return None
        s, pos = rank // self.per_slice, rank % self.per_slice
        nxt = slices[(slices.index(s) + 1) % len(slices)]
        return nxt * self.per_slice + pos

    # ---- commit ---------------------------------------------------------

    def put(self, step: int, state, *, ranks: list[int] | None = None,
            group=None) -> int:
        """Commit ``state``'s learned fields at boundary ``step`` over the
        ``ranks`` currently in the world; returns the wire bytes the
        mirror hops cost (0 when degraded to one slice)."""
        from ..comm.compress import bucket_wire_bytes

        ranks = sorted(ranks) if ranks is not None else list(
            range(self.world_size))
        leaves, self._treedef = _state_leaves(state)
        self._specs = _specs(leaves)
        self._blob_len = sum(_nbytes(s) for s in self._specs)
        # Pad so the blob splits into equal rows of whole f32 columns —
        # bucket_wire_bytes prices per column, like the grad buckets.
        n = len(ranks)
        row = -(-self._blob_len // (4 * n)) * 4
        self._row = row
        holder = {r: self.buddy(r, ranks) for r in ranks}
        wire = sum(bucket_wire_bytes(row // 4, self.codec)
                   for r in ranks if holder[r] is not None)
        if self.group is None:
            self._put_local(leaves, ranks, row, holder)
        elif self.me in ranks:
            self._put_rank(leaves, ranks, row, holder, group)
        else:
            # Outside the active world: bookkeeping only.
            self._own = self._mirror_row = None
            self._mirror_of = None
            self._row_digests = None
        self._ranks = ranks
        self._holder = holder
        self.committed_step = step
        self._committed_ranks = ranks
        self.total_wire_bytes += wire
        return wire

    def _put_local(self, leaves, ranks, row, holder) -> None:
        blob = bytes(_blob(leaves).cpu().numpy())
        self._digest = hashlib.sha256(blob).hexdigest()
        blob += b"\x00" * (row * len(ranks) - self._blob_len)
        self._primary = {r: blob[i * row:(i + 1) * row]
                         for i, r in enumerate(ranks)}
        # Mirror of r's row, physically resident on its buddy.
        self._mirror = {r: self._primary[r] for r in ranks
                        if holder[r] is not None}

    def _put_rank(self, leaves, ranks, row, holder, group) -> None:
        from ..comm import collectives

        group = self.group if group is None else group
        i = ranks.index(self.me)
        blob = _blob(leaves)
        # Only this rank's row leaves the card (zeros past the blob's end).
        own = torch.zeros(row, dtype=torch.uint8)
        part = blob[i * row:(i + 1) * row]
        own[:part.numel()] = part.cpu()
        del blob, part
        self._own = own
        wire = _wire_device(group)
        digest = torch.frombuffer(
            bytearray(hashlib.sha256(own.numpy()).digest()), dtype=torch.uint8)
        got = collectives.all_gather(digest.to(wire), group).cpu()
        self._row_digests = [bytes(got[j * 32:(j + 1) * 32].numpy())
                             for j in range(len(ranks))]
        self._digest = hashlib.sha256(b"".join(self._row_digests)).hexdigest()
        self._mirror_of = self._mirror_row = None
        perm = [(ranks.index(r), ranks.index(b)) for r, b in holder.items()
                if b is not None]
        if perm:
            got = collectives.ppermute(own.to(wire), group, perm).cpu()
            src = [r for r, b in holder.items() if b == self.me]
            if src:
                self._mirror_of, self._mirror_row = src[0], got

    # ---- loss + restore -------------------------------------------------

    def drop_slice(self, lost_slice: int) -> None:
        """Slice death: its ranks' primaries vanish, and so does every
        mirror that was resident on one of them."""
        dead = {r for r in self._ranks if r // self.per_slice == lost_slice}
        for r in dead:
            self._primary.pop(r, None)
        for r in list(self._mirror):
            if self.buddy(r) in dead:
                del self._mirror[r]
        if self.me in dead:
            self._own = self._mirror_row = None
            self._mirror_of = None
        self._ranks = [r for r in self._ranks if r not in dead]

    def missing_rows(self) -> list[int]:
        """Committed ranks whose row survives nowhere: the owner and the
        rank holding its mirror both dead."""
        if self.group is None:
            return [r for r in self._committed_ranks
                    if r not in self._primary and r not in self._mirror]
        alive = set(self._ranks)
        return [r for r in self._committed_ranks
                if r not in alive and self._holder.get(r) not in alive]

    def restore(self, *, group=None):
        """Reassemble the committed tree from surviving rows (primary
        where the owner lives, its buddy's mirror where it does not) and
        unpack it BIT-identically: ``(step, {field: subtree})``, host
        tensors.  Raises when a row survives nowhere (the caller falls
        back to the disk tier) or the rows do not match the committed
        digest.  Across ranks it is collective over ``group``, the
        survivors'."""
        if self.committed_step is None:
            raise RuntimeError("no committed peer snapshot to restore")
        # Every rank of the COMMIT must contribute its row — a rank
        # whose primary and mirror both died is absent from the
        # survivors entirely, not present-but-None.
        missing = self.missing_rows()
        if missing:
            raise RuntimeError(
                f"peer snapshot rows lost for ranks {missing}: both owner "
                "and buddy died — fall back to the disk tier"
            )
        if self.group is None:
            rows = [self._primary.get(r, self._mirror.get(r))
                    for r in self._committed_ranks]
            blob = b"".join(rows)[: self._blob_len]
            if hashlib.sha256(blob).hexdigest() != self._digest:
                raise RuntimeError(
                    "reassembled peer snapshot does not match the committed "
                    "digest — refusing a corrupt restore"
                )
            host = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
        else:
            host = self._gather_rows(self.group if group is None else group)
        return self.committed_step, _parse(host, self._specs, self._treedef)

    def _gather_rows(self, group) -> torch.Tensor:
        """The survivors' rows, each rank serving its own and the mirror
        of a dead owner it holds; each served row is hashed by the rank
        that serves it."""
        from ..comm import collectives

        owners, alive = self._committed_ranks, sorted(self._ranks)
        served = self._mirror_of if self._mirror_of not in alive else None
        slots = torch.zeros((2, self._row), dtype=torch.uint8)
        ok = True
        for k, (owner, row) in enumerate(((self.me, self._own),
                                          (served, self._mirror_row))):
            if owner is None or owner not in owners:
                continue
            slots[k] = row
            want = self._row_digests[owners.index(owner)]
            ok &= hashlib.sha256(row.numpy()).digest() == want
        if not all(v for (v,) in _gather_ints([int(ok)], group)):
            raise RuntimeError(
                "reassembled peer snapshot does not match the committed "
                "digest — refusing a corrupt restore"
            )
        got = collectives.all_gather(
            slots.to(_wire_device(group)), group).cpu().view(
                len(alive), 2, self._row)
        rows = [got[alive.index(r), 0] if r in alive
                else got[alive.index(self._holder[r]), 1] for r in owners]
        return torch.cat(rows)[: self._blob_len]


class ElasticWorld:
    """Membership + accounting spine of one elastic run.

    Owns the integer transition counters (the host side of the
    ``counters == telemetry == report`` pin), the transition log, and
    the ``/slo`` ``elastic`` block (:meth:`snapshot`, wired through
    ``obs.http.OpsServer(elastic=...)``).
    """

    def __init__(self, world_size: int, n_slices: int, *, emitter=None):
        self.initial_world_size = world_size
        self.world_size = world_size
        self.n_slices = n_slices
        self.active_slices = sorted(range(n_slices))
        self.emitter = emitter
        self.counters = {
            "elastic_shrinks": 0,
            "elastic_grows": 0,
            "elastic_peer_restores": 0,
            "elastic_peer_snapshot_bytes": 0,
            "elastic_host_stalls": 0,
        }
        self.transitions: list[dict[str, Any]] = []
        self._gauge()

    def _gauge(self) -> None:
        if self.emitter is not None:
            self.emitter.gauge("elastic_world_size", self.world_size)

    def count(self, name: str, value: int = 1) -> None:
        self.counters[name] += value
        if self.emitter is not None:
            self.emitter.counter_add(name, value)

    def transition(self, kind: str, *, step: int, world_to: int,
                   **fields: Any) -> None:
        if kind not in ELASTIC_TRANSITIONS:
            raise ValueError(f"unknown elastic transition {kind!r}")
        # "transition", not "kind": the record payload merges into the
        # event envelope, whose "kind" field is the event kind itself.
        rec = {
            "transition": kind, "step": int(step),
            "world_from": self.world_size, "world_to": int(world_to),
            **fields,
        }
        self.transitions.append(rec)
        self.world_size = int(world_to)
        self._gauge()
        if self.emitter is not None:
            self.emitter.emit("record", {"record": "elastic_transition", **rec})

    def snapshot(self) -> dict[str, Any]:
        """The ``/slo`` payload's ``elastic`` block."""
        return {
            "world_size": self.world_size,
            "initial_world_size": self.initial_world_size,
            "active_slices": list(self.active_slices),
            "counters": dict(self.counters),
            "transitions": [dict(t) for t in self.transitions],
        }


# ---------------------------------------------------------------------- #
# the scripted elastic episode (CLI --elastic-resize, tests, chip_smoke)
# ---------------------------------------------------------------------- #


def _global_batch_for(step: int, *, seed: int, rows: int, seq_len: int,
                      vocab: int) -> np.ndarray:
    """The consumed-batch schedule: a pure function of the GLOBAL step,
    so any world size consumes the identical global batch at step N —
    the invariant that makes resize-time re-partitioning a pure
    accumulation-scaling problem."""
    rng = np.random.default_rng(seed * 1_000_003 + step)
    return rng.integers(0, vocab, (rows, seq_len), np.int32)


def batch_digest(tokens: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(tokens).tobytes()).hexdigest()[:16]


def oracle_batch_digests(n_steps: int, *, seed: int = 0, rows: int = 16,
                         seq_len: int = 16, vocab: int = 128) -> list[str]:
    """What ANY correctly re-partitioned run must consume at each global
    step — the oracle the shrunk run's schedule is pinned against."""
    return [
        batch_digest(_global_batch_for(
            g, seed=seed, rows=rows, seq_len=seq_len, vocab=vocab
        ))
        for g in range(n_steps)
    ]


def tiny_gpt2_config(seq_len: int = 16):
    """JAX's episode model: the tiny f32 GPT-2 of
    ``tools/grad_sync_diag`` (vocab 128, 2 layers, 2 heads, width 32)."""
    from ..models.gpt2 import GPT2Config

    return GPT2Config(vocab_size=128, max_seq_len=seq_len, num_layers=2,
                      num_heads=2, hidden_dim=32)


def episode_state(model_config, policy, seed: int, device, process_group):
    """The episode's model and train state: GPT-2 at ``model_config``
    with weights from ``seed``, ``optax.adam(1e-3)``'s transformation,
    replicated over ``process_group`` (rank 0's)."""
    from ..models import create_model
    from ..train import create_train_state, optim

    model = create_model("gpt2", device=device, seed=seed,
                         cfg_overrides=dataclasses.asdict(model_config))
    tx = optim.chain(optim.scale_by_adam(), optim.scale_by_learning_rate(1e-3))
    return create_train_state(model, tx, policy=policy,
                              process_group=process_group)


def episode_rows(step: int, *, seed: int, global_batch: int, seq_len: int,
                 vocab: int, rank: int, world: int, accum: int) -> np.ndarray:
    """Rank ``rank``'s rows of global step ``step``'s batch at a world of
    ``world`` and ``accum`` microbatches (JAX's microbatch order)."""
    from ..data.loader import rank_rows

    tokens = _global_batch_for(step, seed=seed, rows=global_batch,
                               seq_len=seq_len, vocab=vocab)
    return rank_rows(tokens, rank, world, accum)


def run_elastic_episode(
    *,
    faults: list[Fault] | str,
    n_steps: int = 10,
    process_group=None,
    config: ElasticConfig | None = None,
    accum: int = 2,
    global_batch: int = 16,
    seq_len: int = 16,
    seed: int = 0,
    emitter=None,
    ledger=None,
    clock: _VirtualClock | None = None,
    backoff: BackoffPolicy | None = None,
    state_dir: str | None = None,
    model_config=None,
    policy=None,
    device=None,
    profile: dict | None = None,
) -> dict[str, Any]:
    """One deterministic elastic episode over the ranks of
    ``process_group`` (default: the world; it must span the world), as
    ``n_slices`` slices of consecutive ranks; every rank calls it.

    Trains GPT-2 (``model_config``, default JAX's tiny f32 one; ``policy``
    default f32) at the full world, fires the elastic fault plan, shrinks
    to the survivors on detection (peer-RAM restore, the survivors'
    group, scaled accumulation), grows back on ``slice_return``, and
    returns JAX's audited report on every rank: transitions, host
    counters, per-step consumed-batch digests, the bit-identity verdict
    of the peer restore, and the goodput ledger's finalized integer-ns
    attribution.  Rank 0 alone uses ``emitter`` and writes the markers
    under ``state_dir``.  ``device`` is where each rank's model and step
    live (default its card; ``"cpu"`` asks for the host).  ``profile`` (a
    dict) receives the host times: each executed step's loss and seconds
    (the loss read back, so the step is waited for), and each peer
    put's, the restore's and the grow transfer's seconds and bytes, and
    the final ``state``.  Everything the report carries is a pure
    function of the arguments — the run-twice determinism pin.
    """
    import torch.distributed as dist

    from ..comm import collectives
    from ..comm.compress import bucket_wire_bytes
    from ..data.loader import rank_rows
    from ..obs.ledger import GoodputLedger
    from ..train import make_train_step
    from ..train.policy import Policy
    from ..utils.device import resolve_device

    cfg = config or ElasticConfig()
    if isinstance(faults, str):
        faults = parse_elastic_faults(faults)
    for f in faults:
        if f.kind not in ELASTIC_FAULT_KINDS:
            raise ValueError(
                f"fault {f.name} is not an elastic membership fault "
                f"{ELASTIC_FAULT_KINDS} — training faults belong to "
                "--inject-faults"
            )
    joined = dist.is_available() and dist.is_initialized()
    if process_group is None and joined:
        process_group = dist.group.WORLD
    world = dist.get_world_size(process_group) if joined else 1
    n_slices = cfg.n_slices
    if world % n_slices or world // n_slices < 2:
        raise ValueError(
            f"{world} devices do not form {n_slices} slices of >= 2"
        )
    if world != dist.get_world_size():
        raise ValueError(
            f"the episode's group of {world} ranks must span the world of "
            f"{dist.get_world_size()}: its survivors' groups are built over "
            "every rank"
        )
    per_slice = world // n_slices
    for f in faults:
        if f.kind == "slice_lost" and not 0 <= int(f.arg) < n_slices:
            raise ValueError(
                f"elastic fault {f.name}: slice {int(f.arg)} out of range "
                f"for {n_slices} slices"
            )
    shrink_accum = accum * n_slices // (n_slices - 1) if n_slices > 1 else accum
    if global_batch % world or global_batch % accum \
            or global_batch % shrink_accum:
        raise ValueError(
            f"global batch {global_batch} must divide over {world} ranks, "
            f"{accum} microbatches, and the shrunk-world {shrink_accum} "
            "microbatches — the global batch is preserved across a resize "
            "by scaling accumulation, never by changing the batch"
        )
    me = dist.get_rank(process_group)
    device = resolve_device(device)
    emitter = emitter if me == 0 else None

    clock = clock or _VirtualClock()
    ledger = ledger or GoodputLedger(clock=clock, inherited_backoff_s=0.0)
    backoff = backoff or BackoffPolicy(base_s=BACKOFF_BASE_S, jitter=0.0)
    markers = _FiredMarkers(state_dir if me == 0 else None)
    # The plan's marker state crosses once; rank 0 alone writes markers.
    pre = _gather_ints([int(markers.fired(f.name)) if me == 0 else 0
                        for f in faults] or [0], process_group)[0]
    if me != 0:
        for f, fired in zip(faults, pre):
            if fired:
                markers.mark(f.name)
    monitor = SliceHealthMonitor(
        world, n_slices, patience_steps=cfg.patience_steps,
        stall_flag_after=cfg.stall_flag_after, emitter=emitter,
    )
    store = PeerSnapshotStore(world, n_slices, emitter=emitter,
                              process_group=process_group)
    eworld = ElasticWorld(world, n_slices, emitter=emitter)
    # Every "world without slice k" group, built while every rank can
    # enter new_group.
    survivor_groups = {
        k: collectives.new_group(
            [r for r in range(world) if r // per_slice != k])
        for k in range(n_slices)
    }

    # ---- model + step at the full world --------------------------------
    model_cfg = model_config or tiny_gpt2_config(seq_len)
    policy = policy or Policy()
    state = episode_state(model_cfg, policy, seed, device, process_group)

    def build_step(group, n_micro):
        return make_train_step(kind="lm", policy=policy,
                               num_microbatches=n_micro,
                               process_group=group)

    data_group = process_group
    cur_accum = accum
    with ledger.bracket("compile"):
        clock.advance(COMPILE_S)
    step_fn = build_step(data_group, cur_accum)

    # ---- membership simulation state ------------------------------------
    lost_slice: int | None = None     # declared-lost slice (shrunk window)
    silent: set[int] = set()          # ranks not beating (slice_lost)
    hang_until: dict[int, int] = {}   # host_hang: rank -> first step it beats
    return_armed = False              # slice_return fired, awaiting grow
    restore_bit_identical: bool | None = None
    restores_seen = 0                 # the restores this rank took part in
    committed_copy: list | None = None
    committed_copy_step: int | None = None
    step_log: list[dict[str, Any]] = []
    active_ranks = list(range(world))
    if profile is not None:
        profile.update(steps=[], put=[], restore=[], grow=[])

    def commit(step_boundary: int, st) -> None:
        nonlocal committed_copy, committed_copy_step
        t0 = time.perf_counter()
        with ledger.bracket("ckpt_save"):
            clock.advance(SNAP_S)
            wire = store.put(step_boundary, st, ranks=active_ranks,
                             group=data_group)
        active = me in active_ranks
        committed_copy = _committed_copy(st) if active else None
        committed_copy_step = step_boundary
        if profile is not None and active:
            profile["put"].append({"step": step_boundary,
                                   "s": time.perf_counter() - t0,
                                   "row_bytes": store._row,
                                   "wire_bytes": wire})
        if wire:
            eworld.count("elastic_peer_snapshot_bytes", wire)
        ledger.note_snapshot(step_boundary)

    def fire_faults(g: int) -> int:
        """Fire this boundary's faults; returns the fired ones as a
        bitmask (rank 0's travels in the boundary's gather)."""
        nonlocal return_armed
        mask = 0
        for i, f in enumerate(faults):
            if f.step != g or markers.fired(f.name):
                continue
            markers.mark(f.name)
            mask |= 1 << i
            if emitter is not None:
                emitter.anomaly(
                    "fault_injected", fault=f.kind, fault_step=f.step,
                )
            if f.kind == "slice_lost":
                k = int(f.arg)
                silent.update(
                    r for r in range(world) if r // per_slice == k
                )
            elif f.kind == "slice_return":
                if silent:
                    silent.clear()
                    return_armed = True
                elif emitter is not None:
                    emitter.anomaly(
                        "slice_return", step=g, ignored=True,
                        reason="no slice is lost or silent",
                    )
            else:  # host_hang
                hang_until[0] = g + int(f.arg)
        return mask

    def beats(g: int, mask: int) -> None:
        """The boundary's all-gather: this rank's beat and fire mask;
        every beat gathered feeds the monitor (and rank 0's emitter)."""
        beat = me not in silent and not (me in hang_until
                                         and g < hang_until[me])
        got = _gather_ints([int(beat), mask], process_group)
        if any(m != got[0][1] for _, m in got):
            raise RuntimeError(
                f"ranks disagree on the elastic faults fired at step {g}: "
                f"{[m for _, m in got]}"
            )
        for r, (b, _) in enumerate(got):
            if not b:
                continue
            if emitter is not None:
                emitter.heartbeat(step=g, hb_rank=r)
            monitor.ingest({"kind": "heartbeat", "step": g, "hb_rank": r})

    def shrink(g: int, lost: int) -> int:
        """Shrink to the survivors at detection boundary ``g``; returns
        the resume step (the committed snapshot boundary)."""
        nonlocal data_group, cur_accum, step_fn, lost_slice
        nonlocal restore_bit_identical, restores_seen, active_ranks, state
        lost_slice = lost
        if emitter is not None:
            emitter.anomaly(
                "slice_lost", step=g, lost_slice=lost,
                detected_from="heartbeat_staleness",
            )
        snap_step = store.committed_step
        # The doomed window's already-charged steps move to rework
        # (discarded originals); their re-executions classify as rework
        # too via the watermark.  The detection step itself never
        # dispatched, so its first execution stays fresh.
        if g > snap_step:
            ledger.note_rollback(snap_step, g - 1)
        ledger.set_rework_until(g)
        store.drop_slice(lost)
        active_ranks = [r for r in active_ranks if r // per_slice != lost]
        survivors = [r for r in range(world) if r // per_slice != lost]
        eworld.active_slices = [s for s in eworld.active_slices if s != lost]
        eworld.count("elastic_shrinks")
        eworld.transition(
            "shrink", step=g, world_to=len(survivors), lost_slice=lost,
            resumed_from_step=snap_step,
        )
        data_group = survivor_groups[lost]
        missing = store.missing_rows()
        if missing:   # every rank knows: all raise together
            raise RuntimeError(
                f"peer snapshot rows lost for ranks {missing}: both owner "
                "and buddy died — fall back to the disk tier"
            )
        restored_step = snap_step
        t0 = time.perf_counter()
        with ledger.bracket("ckpt_restore"):
            clock.advance(PEER_RESTORE_S)
            if me in active_ranks:
                restored_step, host_tree = store.restore(group=data_group)
                state = _load(state, host_tree, restored_step)
                # The restored leaves, in place, against the copy taken
                # at the commit.
                restore_bit_identical = (
                    committed_copy_step == restored_step
                    and _same_leaves(state, committed_copy))
                restores_seen = eworld.counters["elastic_peer_restores"] + 1
        if profile is not None and me in active_ranks:
            profile["restore"].append({
                "step": g, "s": time.perf_counter() - t0,
                "gathered_bytes": 2 * store._row * len(active_ranks)})
        if emitter is not None:
            emitter.emit("record", {
                "record": "checkpoint_restore", "step": restored_step,
                "restore_source": "peer",
            })
        eworld.count("elastic_peer_restores")
        eworld.transition(
            "peer_restore", step=g, world_to=eworld.world_size,
            restore_source="peer", snapshot_step=restored_step,
        )
        # Re-partition: the SAME global batch at the smaller world means
        # proportionally more microbatches per surviving rank.
        cur_accum = accum * (world // len(survivors))
        with ledger.bracket("compile"):
            clock.advance(RESHAPE_COMPILE_S)
        step_fn = build_step(data_group, cur_accum)
        return restored_step

    def grow(g: int) -> None:
        """Re-expand to the full world at boundary ``g``: backoff wait,
        the state from a survivor, the full world's step, re-armed peer
        tier."""
        nonlocal data_group, cur_accum, step_fn, lost_slice, return_armed
        nonlocal active_ranks, state

        with ledger.bracket("supervisor_backoff"):
            clock.advance(backoff.delay(1))
        # The returning slice pulls the current state from a survivor —
        # setup cost, not a restore of THIS run's state.
        with ledger.bracket("other"):
            clock.advance(GROW_SYNC_S)
        grow_wire = bucket_wire_bytes(-(-store._blob_len // 4), store.codec)
        if emitter is not None:
            emitter.anomaly("slice_return", step=g, returned_slice=lost_slice)
        t0 = time.perf_counter()
        leaves, treedef = _state_leaves(state)
        leaves = _broadcast_leaves(leaves, process_group, active_ranks[0])
        state = _load(state, _unflatten(treedef, [v for _, v in leaves]), g)
        if profile is not None:
            profile["grow"].append({"step": g, "s": time.perf_counter() - t0,
                                    "bytes": store._blob_len})
        data_group = process_group
        active_ranks = list(range(world))
        cur_accum = accum
        with ledger.bracket("compile"):
            clock.advance(RESHAPE_COMPILE_S)
        step_fn = build_step(data_group, cur_accum)
        eworld.active_slices = sorted(eworld.active_slices + [lost_slice])
        eworld.count("elastic_grows")
        eworld.transition(
            "grow", step=g, world_to=world, returned_slice=lost_slice,
            wire_bytes=grow_wire,
        )
        lost_slice = None
        return_armed = False
        # Re-arm the peer tier immediately: the re-entered slice's first
        # duty is holding its buddies' mirrors again.
        commit(g, state)

    def pulls(n: int) -> Iterable:
        for _ in range(n):
            clock.advance(PULL_S)
            yield None

    # Initial commit: the peer tier is armed from step 0, so the first
    # loss never needs the disk.
    commit(0, state)

    g = 0
    while g < n_steps:
        # One segment = a contiguous run of steps at one world size,
        # bracketed by wrap_batches so pull time is data_wait and the
        # batch-ready..dispatch interval joins each step's own class.
        # A shrink breaks out (rewinding g) and opens a fresh segment.
        for _ in ledger.wrap_batches(pulls(n_steps - g)):
            # Step boundary: faults fire, heartbeats land, verdicts.
            beats(g, fire_faults(g))
            verdict = monitor.observe(g)
            if monitor.host_stalls > eworld.counters["elastic_host_stalls"]:
                eworld.count(
                    "elastic_host_stalls",
                    monitor.host_stalls
                    - eworld.counters["elastic_host_stalls"],
                )
            newly_lost = [
                s for s in verdict["lost_slices"]
                if s in eworld.active_slices
            ]
            if newly_lost and lost_slice is None:
                g = shrink(g, newly_lost[0])
                break  # new segment at the shrunk world
            if return_armed and lost_slice is not None:
                grow(g)

            # ---- the step itself ---------------------------------------
            tokens = _global_batch_for(
                g, seed=seed, rows=global_batch, seq_len=seq_len,
                vocab=model_cfg.vocab_size,
            )
            step_log.append({
                "step": g,
                "digest": batch_digest(tokens),
                "world": eworld.world_size,
                "accum": cur_accum,
                "global_rows": int(tokens.shape[0]),
            })
            clock.advance(DISPATCH_S)
            ledger.begin_step(g)
            if me in active_ranks:
                rows = rank_rows(tokens, active_ranks.index(me),
                                 len(active_ranks), cur_accum)
                t0 = time.perf_counter()
                state, metrics = step_fn(
                    state, {"tokens": torch.from_numpy(rows).to(device)})
                if profile is not None:
                    loss = float(metrics["loss"])
                    profile["steps"].append({
                        "step": g, "world": len(active_ranks),
                        "accum": cur_accum, "loss": loss,
                        "s": time.perf_counter() - t0})
            clock.advance(TAIL_S)
            g += 1
            ledger.note_progress(g)
            if g % cfg.snapshot_every_steps == 0 and g < n_steps:
                commit(g, state)

    clock.advance(EPOCH_TAIL_S)
    final = ledger.finalize(emitter)
    # The closing gather: the survivors' step and the last restore's
    # verdict reach every rank, rank 0 included when its slice was lost.
    verdict_code = -1 if restore_bit_identical is None else int(
        restore_bit_identical)
    got = _gather_ints([int(me in active_ranks), int(state.step),
                        restores_seen, verdict_code], process_group)
    final_step = next(s for a, s, _, _ in got if a)
    last = eworld.counters["elastic_peer_restores"]
    codes = [v for _, _, n, v in got if n == last and v >= 0]
    restore_bit_identical = bool(codes[0]) if last and codes else None
    if profile is not None:
        profile["state"] = state
    report = {
        "world": {
            "initial": world,
            "final": eworld.world_size,
            "n_slices": n_slices,
        },
        "counters": dict(eworld.counters),
        "transitions": [dict(t) for t in eworld.transitions],
        "steps": step_log,
        "batch_digests": [row["digest"] for row in step_log],
        "restore_bit_identical": restore_bit_identical,
        "host_stalls": monitor.host_stalls,
        "peer_snapshot_wire_bytes": store.total_wire_bytes,
        "final_step": final_step,
        "ledger": final,
        "elastic": eworld.snapshot(),
    }
    return report
