"""Tensor-parallel serving across processes: the lockstep driver, and
tensor-parallel replicas led by other processes behind one router.

The JAX package serves tensor-parallel from one controller: one host
runs the scheduler and the engine, and each step is one SPMD program
over the TP submesh, so it needs nothing like this module.  The port
under ``torchrun`` has one process a shard, each with its own engine
over its own head shard (``parallel/sharded.py::shard_for_serving``), and
the engines must take the same steps on the same requests.

The **leader** (tensor index 0 of the group) runs the scheduler (and the
disaggregated tier, when there is one) on a :class:`LockstepEngine`:
every call to a mutating method (``start``, ``cancel``, ``step``,
``export_handoff``, ``adopt``, ``reset``) is first broadcast as
``(method, args)`` with ``broadcast_object_list`` over a gloo group, then
applied.  The **followers** run :func:`follow`, which applies the same
calls to their engines in the same order until the leader's ``close``.

Why the ranks stay identical: the engine's host state (slot tables,
block refcounts, copy on write, spills to and restores from each rank's
own host tier, contiguous row copies) changes only in those calls and
replays the same on every rank, each on its own head shard.  The logits
are replicated after the row-parallel all-reduce, so greedy and seeded
sampling draw the same tokens everywhere.  Only the leader reads the
clock: deadlines and arrivals become ``cancel`` and ``start`` calls, and
cannot split the ranks.

A leader that raises sends ``abort`` from ``close(error)``, and the
followers raise too; a follower that raises leaves the leader blocked
in the step's all-reduce until the launcher stops the job on the
follower's exit.

**Replicas across processes** (``--serve-tp T --serve-replicas R`` under
a world of T x R, tensor innermost: group k is ranks ``[k T, (k + 1) T)``,
as JAX lays replica k on ``devs[k*T:(k+1)*T]``).  Rank 0 runs the router,
every replica's scheduler and the controllers, and leads group 0 through
a :class:`LockstepEngine`.  For each group k > 0 it holds a
:class:`RemoteReplica`: every call the router, the schedulers and the
controllers make on an engine goes to group k's leader over a gloo pair
group, the leader (:func:`serve_replica`) applies it through its own
``LockstepEngine`` and sends back the value (events, stranded ids, a
count).  A remote engine changes only in the mutating calls rank 0
sends, so a read is cached until the next one, and the four values that
never change (slots, pool kind, prefix cache, block size) once.  Rank 0
counts the round trips and their host seconds.  The router posts every
remote group's ``step`` before it steps group 0 and collects the replies
after, so the groups' forwards overlap; every other call is a blocking
round trip.

**The sibling fetch between groups.**  Each rank holds its own head
shard of every block, so shard i of the warm group goes to shard i of the
chosen group's host tier over gloo.  Rank 0 plans the fetch from the
groups' ``resolvable_chain`` answers in the order and striping of
``kv_store.sibling_fetch_striped``, then posts the sends to the source
groups and the receive to the destination group before it waits on any
(waiting in between would deadlock the two groups).  Block hashes are
per process (Python's salted ``hash``), so the messages name chain
positions, never hashes.

Only rank 0 reads the clock: remote replicas see time only as calls.
Every group has its own n-gram index (drafters in other processes cannot
share rank 0's), so greedy tokens equal one process's and draft
acceptance may not.
"""

from __future__ import annotations

import time

import numpy as np
import torch.distributed as dist

from ..comm.mesh import AXIS_TENSOR
from .kv_store import striped_walk

MUTATING = ("start", "cancel", "step", "export_handoff", "adopt", "reset",
            "fail_role", "revive_role", "resplit", "drop_handoff",
            "shrink_host_tier", "restore_host_tier", "fetch_send",
            "fetch_recv")
# A disaggregated engine's role calls: a remote replica has them only
# when its engine is disaggregated (the controllers test for them).
_ROLE_CALLS = ("fail_role", "revive_role", "resplit", "drop_handoff")


def serving_groups(mesh):
    """``(control group, leader's global rank)`` for this rank's tensor
    group of ``mesh`` (tensor innermost, so the group is adjacent ranks):
    the tensor group itself on a gloo world, else a gloo group over the
    same ranks (every rank creates every such group, in order)."""
    tp = mesh.shape[AXIS_TENSOR]
    leader = mesh.rank - mesh.coords[AXIS_TENSOR]
    if dist.get_backend() == "gloo":
        return mesh.group(AXIS_TENSOR), leader
    mine = None
    for start in range(0, mesh.size, tp):
        g = dist.new_group(list(range(start, start + tp)), backend="gloo")
        if start == leader:
            mine = g
    return mine, leader


def _send(group, src: int, message) -> None:
    dist.broadcast_object_list([message], src=src, group=group)


def _receive(group, src: int):
    box = [None]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


class LockstepEngine:
    """The leader's face of a tensor-parallel engine (or tier): reads go
    to ``engine``, mutating calls are broadcast to the followers first
    (module docstring).  ``broadcasts`` and ``broadcast_s`` count the
    calls sent (``close``'s excepted) and the host seconds spent sending
    them."""

    def __init__(self, engine, group, src: int):
        object.__setattr__(self, "_engine", engine)
        object.__setattr__(self, "_group", group)
        object.__setattr__(self, "_src", src)
        object.__setattr__(self, "broadcasts", 0)
        object.__setattr__(self, "broadcast_s", 0.0)

    def _broadcast(self, message) -> None:
        t0 = time.perf_counter()
        _send(self._group, self._src, message)
        object.__setattr__(self, "broadcast_s",
                           self.broadcast_s + time.perf_counter() - t0)
        object.__setattr__(self, "broadcasts", self.broadcasts + 1)

    def __getattr__(self, name):
        attr = getattr(self._engine, name)
        if name not in MUTATING:
            return attr

        def call(*args, **kwargs):
            self._broadcast((name, args, kwargs))
            return attr(*args, **kwargs)

        return call

    def __setattr__(self, name, value) -> None:
        setattr(self._engine, name, value)

    def close(self, error: BaseException | None = None) -> None:
        """Release the followers: ``stop``, or ``abort`` with the
        leader's error."""
        _send(self._group, self._src,
              ("stop", (), {}) if error is None
              else ("abort", (repr(error),), {}))


def follow(engine, group, src: int) -> int:
    """A follower's loop: apply the leader's calls to ``engine`` until
    ``stop``; raises on ``abort``.  Returns the calls applied."""
    applied = 0
    while True:
        name, args, kwargs = _receive(group, src)
        if name == "stop":
            return applied
        if name == "abort":
            raise RuntimeError(f"the serving leader failed: {args[0]}")
        if name not in MUTATING:
            raise RuntimeError(f"unexpected lockstep call {name!r}")
        getattr(engine, name)(*args, **kwargs)
        applied += 1


# ---------------------------------------------------------------------- #
# tensor-parallel replicas across processes
# ---------------------------------------------------------------------- #


class ReplicaFabric:
    """The groups of a fleet of tensor-parallel replicas over ``mesh``
    (``data`` = replicas, ``tensor`` = T): this rank's lockstep control
    group and leader (:func:`serving_groups`), the gloo pair groups
    between rank 0 and each other group's leader (``links``), and a gloo
    group over the world for the sibling fetch's block transfers.  Every
    rank creates every group, in the same order."""

    def __init__(self, mesh):
        self.tp = mesh.shape[AXIS_TENSOR]
        self.world = mesh.size
        self.replicas = self.world // self.tp
        self.rank = mesh.rank
        self.tensor_index = mesh.coords[AXIS_TENSOR]
        self.group_index = self.rank // self.tp
        self.control, self.leader = serving_groups(mesh)
        self.links: dict = {}
        for k in range(1, self.replicas):
            g = dist.new_group([0, k * self.tp], backend="gloo")
            if self.rank in (0, k * self.tp):
                self.links[k] = g
        self.xfer = (dist.group.WORLD if dist.get_backend() == "gloo"
                     else dist.new_group(list(range(self.world)),
                                         backend="gloo"))

    def peer(self, group: int) -> int:
        """The rank of group ``group`` holding this rank's head shard."""
        return group * self.tp + self.tensor_index


def _blocks_of(engine):
    """An engine's (or a disaggregated tier's) shared BlockPool, or None."""
    blocks = getattr(engine, "blocks", None)
    if blocks is None:
        blocks = getattr(engine.pool, "blocks", None)
    return blocks


class GroupMember:
    """A rank's engine inside a tensor-parallel replica group, with the
    sibling fetch between groups: :meth:`fetch_send` and
    :meth:`fetch_recv` move this rank's head shard of prefix blocks to and
    from the same tensor index of another group.  Everything else is the
    engine's."""

    def __init__(self, engine, fabric: ReplicaFabric):
        object.__setattr__(self, "_engine", engine)
        object.__setattr__(self, "_fabric", fabric)
        object.__setattr__(self, "group_index", fabric.group_index)

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __setattr__(self, name, value) -> None:
        setattr(self._engine, name, value)

    @property
    def has_blocks(self) -> bool:
        return _blocks_of(self._engine) is not None

    @property
    def has_host_tier(self) -> bool:
        blocks = _blocks_of(self._engine)
        return blocks is not None and blocks.host is not None

    def _chain(self, prompt) -> list:
        from .kv_pool import hash_prompt_blocks

        blocks = _blocks_of(self._engine)
        return hash_prompt_blocks(np.asarray(prompt, np.int32).reshape(-1),
                                  blocks.block_size)

    def resolvable_chain(self, prompt) -> list[bool]:
        """Whether each full block of ``prompt``'s chain is resolvable here
        (either tier)."""
        blocks = _blocks_of(self._engine)
        return [blocks.resolvable(h) for h in self._chain(prompt)]

    def fetch_send(self, dst_group: int, prompt, positions: list) -> int:
        """Send this rank's shard of ``prompt``'s blocks at ``positions``
        to its peer in group ``dst_group``."""
        blocks = _blocks_of(self._engine)
        chain = self._chain(prompt)
        payload = [blocks.read_block_bytes(chain[i]) for i in positions]
        dist.send_object_list([payload], dst=self._fabric.peer(dst_group),
                              group=self._fabric.xfer)
        return len(positions)

    def fetch_recv(self, prompt, plan: list) -> int:
        """Receive the planned blocks (``[(position, source group)]`` in
        walk order) from this rank's peers and adopt them into the host
        tier in order, stopping at the first one refused, as
        ``sibling_fetch_striped`` does; returns the blocks fetched."""
        blocks = _blocks_of(self._engine)
        chain = self._chain(prompt)
        payloads = {}
        for src in sorted({g for _, g in plan}):
            box = [None]
            dist.recv_object_list(box, src=self._fabric.peer(src),
                                  group=self._fabric.xfer)
            payloads[src] = iter(box[0])
        fetched = 0
        for i, src in plan:
            arrays = next(payloads[src])
            parent = chain[i - 1] if i else None
            if arrays is None or not blocks.adopt_host_block(
                    chain[i], parent, arrays):
                break
            fetched += 1
        blocks.sibling_fetched_blocks += fetched
        return fetched


def sibling_fetch_groups(dst, srcs, prompt) -> int:
    """``kv_store.sibling_fetch_striped`` between tensor-parallel groups:
    ``dst`` and ``srcs`` are group engines (rank 0's ``LockstepEngine``
    over a :class:`GroupMember`, or :class:`RemoteReplica`).  The walk
    (``kv_store.striped_walk``) is planned whole from the groups' chain
    answers, then the sends and the receive are all posted before any is
    waited on.  Returns the blocks fetched."""
    if not getattr(dst, "has_host_tier", False):
        return 0
    srcs = [s for s in srcs if s is not dst
            and getattr(s, "has_blocks", False)
            and s.group_index != dst.group_index]
    if not srcs:
        return 0
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    have = dst.resolvable_chain(prompt)
    src_have = [s.resolvable_chain(prompt) for s in srcs]
    plan = list(striped_walk(len(have), have.__getitem__,
                             lambda k, i: src_have[k][i], len(srcs)))
    if not plan:
        return 0
    calls = [(srcs[k], "fetch_send",
              (dst.group_index, prompt, [i for i, kk in plan if kk == k]))
             for k in sorted({k for _, k in plan})]
    calls.append((dst, "fetch_recv",
                  (prompt, [(i, srcs[k].group_index) for i, k in plan])))
    # The remote groups first (posted, not waited on), then this
    # process's own group, then the replies.
    pending, value = [], {}
    for member, name, args in calls:
        if isinstance(member, RemoteReplica):
            pending.append((member, member.post(name, *args)))
    for member, name, args in calls:
        if not isinstance(member, RemoteReplica):
            value[id(member)] = getattr(member, name)(*args)
    for member, finish in pending:
        value[id(member)] = finish()
    return value[id(dst)]


def _key(value):
    """A hashable key of a read's arguments (prompts by their bytes)."""
    if isinstance(value, np.ndarray):
        return ("nd", value.dtype.str, value.shape, value.tobytes())
    if isinstance(value, (list, tuple)):
        return tuple(_key(v) for v in value)
    return value


class _RemotePool:
    """The pool reads the router and the schedulers make."""

    def __init__(self, remote: "RemoteReplica", info: dict):
        self._remote = remote
        self.prefix_cache_enabled = info["prefix_cache_enabled"]

    @property
    def num_active(self) -> int:
        return self._remote.read("pool.num_active")

    def lookup(self, prompt) -> int:
        return self._remote.read("pool.lookup", prompt)


def _describe(engine) -> dict:
    """What never changes of a group's engine, read once by rank 0."""
    blocks = _blocks_of(engine)
    info = {
        "num_slots": engine.num_slots, "paged": engine.paged,
        "max_len": engine.max_len,
        "prefix_cache_enabled": bool(getattr(engine.pool,
                                             "prefix_cache_enabled", False)),
        "has_blocks": blocks is not None,
        "has_host": blocks is not None and blocks.host is not None,
        "disagg": hasattr(engine, "fail_role"),
    }
    if info["disagg"]:
        info["prefill_slots"] = engine.prefill_slots
        info["decode_slots"] = engine.decode_slots
    return info


class RemoteReplica:
    """Rank 0's face of replica group ``k``, led by another process: the
    engine surface the router, the schedulers and the controllers use,
    each call a round trip to the group's leader (:func:`serve_replica`).
    Reads are cached until the next mutating call; ``round_trips``,
    ``round_trip_s`` (rank 0's host seconds from send to reply),
    ``wait_s`` (the part of those rank 0 spent blocked on the reply: a
    posted step's overlaps rank 0's own work), ``served_s`` (the leader's
    seconds applying the calls, its group's forwards included) and
    ``cached_reads`` count them.  Token events the
    leader returns stream through this object's ``stream_cb``."""

    def __init__(self, fabric: ReplicaFabric, k: int):
        self._link = fabric.links[k]
        self._leader = k * fabric.tp
        self.group_index = k
        self.round_trips = 0
        self.round_trip_s = 0.0
        self.wait_s = 0.0
        self.served_s = 0.0
        self.cached_reads = 0
        self._cache: dict = {}
        self.stream_cb = None
        # The scheduler hands its span recorder to its engine; a remote
        # group records no tick spans.
        self.spans = None
        self.spans_replica = None
        self.drafter = None  # each group has its own n-gram index
        info = self._round_trip("get", "describe", (), {})
        self._info = info
        self.num_slots, self.paged = info["num_slots"], info["paged"]
        self.max_len = info["max_len"]
        self.has_blocks = info["has_blocks"]
        self.has_host_tier = info["has_host"]
        if info["disagg"]:
            self.prefill_slots = info["prefill_slots"]
            self.decode_slots = info["decode_slots"]
        self.pool = _RemotePool(self, info)

    # ---- the wire ------------------------------------------------------

    def post(self, name: str, *args, **kwargs):
        """Send a mutating call and return the function that waits for its
        value (the sibling fetch posts several before waiting)."""
        self._cache.clear()
        return self._post("call", name, args, kwargs)

    def _post(self, op, name, args, kwargs):
        t0 = time.perf_counter()
        _send(self._link, 0, (op, name, args, kwargs))

        def finish():
            t1 = time.perf_counter()
            status, value, served = _receive(self._link, self._leader)
            t2 = time.perf_counter()
            self.round_trips += 1
            self.round_trip_s += t2 - t0
            self.wait_s += t2 - t1
            self.served_s += served
            if status == "error":
                raise value
            return value

        return finish

    def _round_trip(self, op, name, args, kwargs):
        return self._post(op, name, args, kwargs)()

    def read(self, name: str, *args):
        """A read (a method call when there are arguments or the name is a
        method, else an attribute), cached until the next mutation."""
        key = (name, _key(args))
        if key in self._cache:
            self.cached_reads += 1
            value = self._cache[key]
        else:
            value = self._cache[key] = self._round_trip("read", name, args,
                                                        {})
        return list(value) if isinstance(value, list) else value

    def call(self, name: str, *args, **kwargs):
        return self.post(name, *args, **kwargs)()

    def close(self, error: BaseException | None = None) -> None:
        """Release the group: ``stop``, or ``abort`` with rank 0's error."""
        _send(self._link, 0, ("stop", "", (), {}) if error is None
              else ("abort", repr(error), (), {}))

    # ---- the engine surface -------------------------------------------

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in _ROLE_CALLS and self._info["disagg"]:
            return lambda *a, **kw: self.call(name, *a, **kw)
        raise AttributeError(name)

    @property
    def busy(self) -> bool:
        return self.read("busy")

    @property
    def dead_roles(self) -> tuple:
        return tuple(self.read("dead_roles"))

    @property
    def role_split(self) -> tuple:
        return tuple(self.read("role_split"))

    def validate_request(self, prompt_len: int, max_new: int) -> None:
        self.read("validate_request", prompt_len, max_new)

    def can_admit(self, prompt, max_new: int) -> bool:
        return self.read("can_admit", prompt, max_new)

    def live_requests(self) -> list:
        return self.read("live_requests")

    def stats(self) -> dict:
        return dict(self.read("stats"))

    def resolvable_chain(self, prompt) -> list:
        return self.read("resolvable_chain", prompt)

    def start(self, request_id, prompt, max_new: int):
        return self.call("start", request_id, prompt, max_new)

    def cancel(self, request_id):
        return self.call("cancel", request_id)

    def step(self) -> list:
        return self.post_step()()

    def post_step(self):
        """Send ``step`` and return the function that waits for its events
        (the router posts every remote group's step before it steps its
        own, so the groups' forwards overlap)."""
        finish = self.post("step")

        def events() -> list:
            out = finish()
            if self.stream_cb is not None:
                for ev in out:
                    if ev.kind == "token":
                        self.stream_cb(ev.request_id, ev.token)
            return out

        return events

    def reset(self) -> None:
        self.call("reset")

    def shrink_host_tier(self):
        return self.call("shrink_host_tier")

    def restore_host_tier(self, capacity_bytes: int) -> None:
        self.call("restore_host_tier", capacity_bytes)


def _resolve(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def serve_replica(lockstep: LockstepEngine, link, leader: int) -> int:
    """Group k's leader: apply rank 0's calls through ``lockstep`` (the
    mutating ones reach the followers first) and send back each value,
    until ``stop``; on ``abort`` release the followers and raise.
    Returns the calls served."""
    served = 0
    while True:
        op, name, args, kwargs = _receive(link, 0)
        t0 = time.perf_counter()
        if op == "stop":
            lockstep.close()
            return served
        if op == "abort":
            error = RuntimeError(f"the serving router failed: {name}")
            lockstep.close(error)
            raise error
        try:
            if op == "call":
                value = getattr(lockstep, name)(*args, **kwargs)
            elif name == "describe":
                value = _describe(lockstep)
            else:
                value = _resolve(lockstep, name)
                if callable(value):
                    value = value(*args)
            reply = ("ok", value)
        except Exception as e:  # noqa: BLE001 - the caller re-raises it
            reply = ("error", e)
        _send(link, leader, (*reply, time.perf_counter() - t0))
        served += 1


def run_fleet_rank(fabric: ReplicaFabric, engine, drive):
    """This rank's part of a fleet of tensor-parallel replicas over
    ``fabric``, ``engine`` being its shard of its group's engine: rank 0
    returns ``drive(engines)`` over ``[group 0's LockstepEngine,
    RemoteReplica(1), ...]`` and then releases every group; another
    group's leader serves rank 0 (:func:`serve_replica`) and a follower
    follows its leader (:func:`follow`); both return their call counts."""
    member = GroupMember(engine, fabric)
    if fabric.rank != fabric.leader:
        return follow(member, fabric.control, fabric.leader)
    lock = LockstepEngine(member, fabric.control, fabric.leader)
    if fabric.rank != 0:
        return serve_replica(lock, fabric.links[fabric.group_index],
                             fabric.leader)
    remotes = [RemoteReplica(fabric, k) for k in range(1, fabric.replicas)]
    try:
        out = drive([lock, *remotes])
    except BaseException as e:
        for r in remotes:
            r.close(e)
        lock.close(e)
        raise
    for r in remotes:
        r.close()
    lock.close()
    return out
