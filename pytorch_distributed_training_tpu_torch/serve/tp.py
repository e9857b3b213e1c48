"""Tensor-parallel serving across processes: the lockstep driver.

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
"""

from __future__ import annotations

import time

import torch.distributed as dist

MUTATING = ("start", "cancel", "step", "export_handoff", "adopt", "reset")


def serving_groups(mesh):
    """``(control group, leader's global rank)`` for this rank's tensor
    group of ``mesh`` (tensor innermost, so the group is adjacent ranks):
    the tensor group itself on a gloo world, else a gloo group over the
    same ranks (every rank creates every such group, in order)."""
    tp = mesh.shape["tensor"]
    leader = mesh.rank - mesh.coords["tensor"]
    if dist.get_backend() == "gloo":
        return mesh.group("tensor"), leader
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
