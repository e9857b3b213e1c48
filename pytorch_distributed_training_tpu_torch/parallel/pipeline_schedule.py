"""Static schedule tables for interleaved (multi-chunk) 1F1B: the JAX
package's ``parallel/pipeline_schedule.py``, kept as its own copy (pure
numpy; the port imports nothing of the JAX package).

V model chunks per rank put S*V virtual stages over S pipeline ranks
(Megatron-LM's interleaved schedule, which divides the bubble by about
V).  S, V and M are known before the step runs, so the whole schedule is
computed here as integer tables (one row per rank, one column per tick),
and the engine (``pipeline.pipeline_train_interleaved``) looks up its
rank's row at each tick: every decision is a table lookup.

The schedule is greedy list scheduling over the work-item DAG:

  * work items F(m, vs) / B(m, vs) for microbatch m and virtual stage
    vs = chunk * S + rank (rank = vs mod S, so consecutive virtual stages
    sit on consecutive ranks and a chunk crossing rides the same
    next-rank edge as an ordinary stage hop);
  * F(m, vs) is ready one tick after F(m, vs-1) (the hop's latency);
    B(m, vs) one tick after B(m, vs+1), and after F(m, vs);
    B(m, SV-1) seeds from the loss one tick after F(m, SV-1);
  * each rank runs one item per tick; after Megatron's warmup quota of
    forwards it alternates forward and backward (smallest microbatch
    first; among forwards the earliest virtual stage, among backwards
    the latest chunk), which reproduces Megatron's round robin.

Buffers are static too: every transfer and every saved stage input has a
known production and consumption tick, so slots are assigned here by
greedy first-fit interval allocation and the engine's buffers are lists
of fixed length indexed from the tables.

``validate_schedule`` replays the tables against the DAG constraints at
generation time.  The tables are element for element JAX's
(``tests/test_torch_pipeline.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class InterleavedSchedule:
    """Integer tick tables for the interleaved-1F1B engine.

    All arrays are (S, T) int32 unless noted.  "Slot" columns are -1 when
    the corresponding action does not happen on that (device, tick).
    """

    S: int
    V: int
    M: int
    T: int
    # Forward work: does device s run a forward at tick t, and on what.
    f_do: np.ndarray        # 0/1
    f_chunk: np.ndarray     # chunk index v in [0, V)
    f_mb: np.ndarray        # microbatch index m in [0, M)
    f_first: np.ndarray     # 0/1 — input comes from first_fn (vs == 0)
    f_in_slot: np.ndarray   # in_buf slot to read when not f_first
    f_save_slot: np.ndarray  # x_buf slot where the stage INPUT is saved
    # Forward-arrival banking: does the activation arriving at tick t
    # (sent by device s-1 at tick t-1) get banked, and where.
    r_do: np.ndarray        # 0/1
    r_slot: np.ndarray
    # Backward work.
    b_do: np.ndarray        # 0/1
    b_chunk: np.ndarray
    b_mb: np.ndarray
    b_first: np.ndarray     # 0/1 — vs == 0: xbar feeds first_fn's vjp
    b_seed_loss: np.ndarray  # 0/1 — vs == SV-1: cotangent seeded from loss
    b_cot_slot: np.ndarray  # cot_buf slot to read when not seeded from loss
    b_x_slot: np.ndarray    # x_buf slot holding this item's saved input
    # Cotangent-arrival banking (sent by device s+1 at tick t-1).
    c_do: np.ndarray        # 0/1
    c_slot: np.ndarray
    # Buffer sizes (max over ranks, the same on every rank).
    n_in_slots: int
    n_x_slots: int
    n_cot_slots: int

    def bubble_fraction(self) -> float:
        """Per-device wall-clock bubble, (T - 2·M·V)/T: each device does
        2·M·V work ticks out of the T-tick makespan, and tick time scales
        as 1/V (a chunk is 1/(S·V) of the model), so this fraction is
        directly comparable across V."""
        return (self.T - 2 * self.M * self.V) / self.T


def _alloc_slots(intervals: list[tuple[int, int, tuple]]) -> tuple[dict, int]:
    """Greedy first-fit interval → slot assignment.

    ``intervals``: (start_tick, end_tick_inclusive, key).  Returns
    ({key: slot}, num_slots).  Two intervals may share a slot when they do
    not overlap; banking happens before consumption within a tick, so an
    interval ending at tick t and one starting at t must NOT share (the
    new arrival would clobber the value before its read) — overlap is
    tested inclusively on both ends.
    """
    assignment: dict = {}
    slot_free_at: list[int] = []  # slot -> first tick it is free again
    for start, end, key in sorted(intervals):
        for slot, free_at in enumerate(slot_free_at):
            # free_at == end+1 of the previous tenant: an interval ending
            # at t-1 and one starting at t MAY share (banking precedes
            # consumption within a tick, so only end == start excludes).
            if free_at <= start:
                slot_free_at[slot] = end + 1
                assignment[key] = slot
                break
        else:
            assignment[key] = len(slot_free_at)
            slot_free_at.append(end + 1)
    return assignment, len(slot_free_at)


def make_interleaved_schedule(S: int, V: int, M: int) -> InterleavedSchedule:
    """Greedy list-scheduled interleaved 1F1B over S devices, V chunks,
    M microbatches."""
    if S < 1 or V < 1 or M < 1:
        raise ValueError(f"need S, V, M >= 1, got {S=} {V=} {M=}")
    SV = S * V

    # --- 1. list scheduling -------------------------------------------------
    f_tick = np.full((M, SV), -1, np.int64)  # tick F(m, vs) runs
    b_tick = np.full((M, SV), -1, np.int64)
    done_f = 0
    done_b = 0
    # Megatron's interleaved warmup depth: device s runs this many
    # forwards before its first backward.  Deeper than non-interleaved
    # 1F1B's S - s (that is the memory cost of interleaving) — with only
    # the shallow quota, backwards steal ticks the forward critical path
    # needs and the bubble stays at the V=1 level instead of shrinking
    # by V (measured: S=4 V=2 M=8 drains in T=42 greedy-shallow vs 36
    # with this quota; ideal 2(MV + (S-1)/V) = 35).
    warmup = [
        min(2 * (S - s - 1) + (V - 1) * S, M * V) for s in range(S)
    ]
    f_done_dev = [0] * S
    last_kind = ["B"] * S  # so the steady state's first pick after warmup is B
    t = 0
    # (device, tick) -> ("F"|"B", m, vs)
    work: dict[tuple[int, int], tuple[str, int, int]] = {}

    def ready_b(s: int, t: int):
        """Best ready backward on device s at tick t (smallest microbatch,
        then latest chunk — drain order), or None."""
        best = None
        for vs in range(s, SV, S)[::-1]:
            for m in range(M):
                if b_tick[m, vs] >= 0:
                    continue
                if f_tick[m, vs] < 0 or f_tick[m, vs] >= t:
                    continue
                if vs == SV - 1:
                    ready = f_tick[m, vs] + 1  # loss seed, same device
                elif b_tick[m, vs + 1] >= 0:
                    ready = b_tick[m, vs + 1] + 1  # ppermute hop
                else:
                    continue
                if ready <= t and (
                    best is None or (m, -vs) < (best[0], -best[1])
                ):
                    best = (m, vs)
        return best

    def ready_f(s: int, t: int):
        """Best ready forward on device s at tick t (smallest microbatch,
        then earliest virtual stage — which reproduces Megatron's
        chunk-round-robin groups of S), or None."""
        best = None
        for vs in range(s, SV, S):
            for m in range(M):
                if f_tick[m, vs] >= 0:
                    continue
                if vs == 0:
                    ready = 0
                elif f_tick[m, vs - 1] >= 0:
                    ready = f_tick[m, vs - 1] + 1
                else:
                    continue
                if ready <= t and (best is None or (m, vs) < best):
                    best = (m, vs)
        return best

    while done_f < M * SV or done_b < M * SV:
        for s in range(S):
            # Warmup: forwards only, to the Megatron quota.  Steady state:
            # strict one-forward-one-backward alternation — taking two
            # ready backwards in a row stalls the forward critical path of
            # later microbatches and the bubble stays at the V=1 level.
            warming_up = f_done_dev[s] < warmup[s]
            if warming_up:
                order = ("F",)
            elif last_kind[s] == "B":
                order = ("F", "B")
            else:
                order = ("B", "F")
            picked = None
            for kind in order:
                item = ready_f(s, t) if kind == "F" else ready_b(s, t)
                if item is not None:
                    picked = (kind, item)
                    break
            if picked is None:
                continue
            kind, (m, vs) = picked
            work[(s, t)] = (kind, m, vs)
            if kind == "F":
                f_tick[m, vs] = t
                done_f += 1
                f_done_dev[s] += 1
            else:
                b_tick[m, vs] = t
                done_b += 1
            last_kind[s] = kind
        t += 1
        if t > 8 * (M * V + S) + 16:
            raise AssertionError(
                f"interleaved scheduler failed to converge ({S=} {V=} {M=})"
            )
    T = t

    # --- 2. buffer slot allocation -----------------------------------------
    # in_buf: F(m, vs) output arrives on device (vs+1) % S at f_tick+1 and
    # is consumed at f_tick[m, vs+1] (vs < SV-1).  Per-device intervals.
    in_intervals: dict[int, list] = {s: [] for s in range(S)}
    for m in range(M):
        for vs in range(SV - 1):
            dst = (vs + 1) % S
            in_intervals[dst].append(
                (int(f_tick[m, vs]) + 1, int(f_tick[m, vs + 1]), (m, vs + 1))
            )
    # x_buf: the stage INPUT of F(m, vs) is saved at f_tick and read by
    # B(m, vs) at b_tick (same device).
    x_intervals: dict[int, list] = {s: [] for s in range(S)}
    for m in range(M):
        for vs in range(SV):
            x_intervals[vs % S].append(
                (int(f_tick[m, vs]), int(b_tick[m, vs]), (m, vs))
            )
    # cot_buf: B(m, vs) xbar arrives on device (vs-1) % S at b_tick+1,
    # consumed by B(m, vs-1) (vs > 0).
    cot_intervals: dict[int, list] = {s: [] for s in range(S)}
    for m in range(M):
        for vs in range(1, SV):
            dst = (vs - 1) % S
            cot_intervals[dst].append(
                (int(b_tick[m, vs]) + 1, int(b_tick[m, vs - 1]), (m, vs - 1))
            )
    in_slots: dict[int, dict] = {}
    x_slots: dict[int, dict] = {}
    cot_slots: dict[int, dict] = {}
    n_in = n_x = n_cot = 1  # minimum 1 so buffer shapes are never empty
    for s in range(S):
        in_slots[s], k = _alloc_slots(in_intervals[s])
        n_in = max(n_in, k)
        x_slots[s], k = _alloc_slots(x_intervals[s])
        n_x = max(n_x, k)
        cot_slots[s], k = _alloc_slots(cot_intervals[s])
        n_cot = max(n_cot, k)

    # --- 3. tick tables ----------------------------------------------------
    def tbl(fill=0):
        return np.full((S, T), fill, np.int32)

    f_do, f_chunk, f_mb, f_first = tbl(), tbl(), tbl(), tbl()
    f_in_slot, f_save_slot = tbl(-1), tbl(-1)
    r_do, r_slot = tbl(), tbl(-1)
    b_do, b_chunk, b_mb, b_first, b_seed_loss = (
        tbl(), tbl(), tbl(), tbl(), tbl()
    )
    b_cot_slot, b_x_slot = tbl(-1), tbl(-1)
    c_do, c_slot = tbl(), tbl(-1)

    for (s, t_), (kind, m, vs) in work.items():
        if kind == "F":
            f_do[s, t_] = 1
            f_chunk[s, t_] = vs // S
            f_mb[s, t_] = m
            f_first[s, t_] = int(vs == 0)
            if vs > 0:
                f_in_slot[s, t_] = in_slots[s][(m, vs)]
            f_save_slot[s, t_] = x_slots[s][(m, vs)]
            # Arrival banking on the downstream device one tick later.
            if vs < SV - 1:
                dst = (vs + 1) % S
                r_do[dst, t_ + 1] = 1
                r_slot[dst, t_ + 1] = in_slots[dst][(m, vs + 1)]
        else:
            b_do[s, t_] = 1
            b_chunk[s, t_] = vs // S
            b_mb[s, t_] = m
            b_first[s, t_] = int(vs == 0)
            b_seed_loss[s, t_] = int(vs == SV - 1)
            if vs < SV - 1:
                b_cot_slot[s, t_] = cot_slots[s][(m, vs)]
            b_x_slot[s, t_] = x_slots[s][(m, vs)]
            if vs > 0:
                dst = (vs - 1) % S
                c_do[dst, t_ + 1] = 1
                c_slot[dst, t_ + 1] = cot_slots[dst][(m, vs - 1)]

    sched = InterleavedSchedule(
        S=S, V=V, M=M, T=T,
        f_do=f_do, f_chunk=f_chunk, f_mb=f_mb, f_first=f_first,
        f_in_slot=f_in_slot, f_save_slot=f_save_slot,
        r_do=r_do, r_slot=r_slot,
        b_do=b_do, b_chunk=b_chunk, b_mb=b_mb, b_first=b_first,
        b_seed_loss=b_seed_loss, b_cot_slot=b_cot_slot, b_x_slot=b_x_slot,
        c_do=c_do, c_slot=c_slot,
        n_in_slots=n_in, n_x_slots=n_x, n_cot_slots=n_cot,
    )
    validate_schedule(sched, f_tick, b_tick)
    return sched


def validate_schedule(
    sched: InterleavedSchedule, f_tick: np.ndarray, b_tick: np.ndarray
) -> None:
    """Replay the DAG constraints against the generated tables.

    Raises AssertionError on any violated dependency, double-booked tick,
    or buffer-slot clobber — run at generation time so a scheduler bug can
    never produce silently-wrong (as opposed to loudly-failing) tables.
    """
    S, V, M = sched.S, sched.V, sched.M
    SV = S * V
    assert (f_tick >= 0).all() and (b_tick >= 0).all(), "unscheduled items"
    for m in range(M):
        for vs in range(SV):
            if vs > 0:
                assert f_tick[m, vs] > f_tick[m, vs - 1], (m, vs, "F dep")
            if vs < SV - 1:
                assert b_tick[m, vs] > b_tick[m, vs + 1], (m, vs, "B dep")
            assert b_tick[m, vs] > f_tick[m, vs], (m, vs, "B after own F")
    # One work item per (device, tick).
    per_tick = sched.f_do + sched.b_do
    assert per_tick.max() <= 1, "device double-booked"
    # Slot reads must see exactly the item they expect: simulate the
    # buffers tick by tick, tracking (m, vs) identities.  Arrival identity
    # is re-derived from f_tick/b_tick (what was sent into the ring at
    # t-1), independent of the allocator's bookkeeping.
    f_sent_at = {}  # (src_device, tick) -> (m, vs) whose OUTPUT was sent
    b_sent_at = {}
    for m in range(M):
        for vs in range(SV):
            if vs < SV - 1:
                f_sent_at[(vs % S, int(f_tick[m, vs]))] = (m, vs)
            if vs > 0:
                b_sent_at[(vs % S, int(b_tick[m, vs]))] = (m, vs)
    for s in range(S):
        in_held: dict[int, tuple] = {}
        cot_held: dict[int, tuple] = {}
        x_held: dict[int, tuple] = {}
        for t in range(sched.T):
            if sched.r_do[s, t]:
                src = f_sent_at.get(((s - 1) % S, t - 1))
                assert src is not None, (s, t, "banked a non-payload tick")
                in_held[int(sched.r_slot[s, t])] = (src[0], src[1] + 1)
            if sched.c_do[s, t]:
                src = b_sent_at.get(((s + 1) % S, t - 1))
                assert src is not None, (s, t, "banked a non-payload cot")
                cot_held[int(sched.c_slot[s, t])] = (src[0], src[1] - 1)
            if sched.f_do[s, t]:
                item = (int(sched.f_mb[s, t]),
                        int(sched.f_chunk[s, t]) * S + s)
                if not sched.f_first[s, t]:
                    got = in_held.get(int(sched.f_in_slot[s, t]))
                    assert got == item, (s, t, "in slot", got, item)
                x_held[int(sched.f_save_slot[s, t])] = item
            if sched.b_do[s, t]:
                item = (int(sched.b_mb[s, t]),
                        int(sched.b_chunk[s, t]) * S + s)
                if not sched.b_seed_loss[s, t]:
                    got = cot_held.get(int(sched.b_cot_slot[s, t]))
                    assert got == item, (s, t, "cot slot", got, item)
                got = x_held.get(int(sched.b_x_slot[s, t]))
                assert got == item, (s, t, "x slot", got, item)
