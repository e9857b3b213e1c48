"""Multi-path striping of the DCN hop and the ICI/DCN phase pipeline of
the two-tier sync: the counterpart of the JAX package's
``comm/striping.py``.  Both are transport transforms, exact to the bit:
no codec arithmetic changes, only which link carries which bytes and
when.

**Striping.**  In the serial schedule lane ``r``'s reduce-scattered shard
crosses between nodes on lane ``r``'s own link.  :func:`striped_dcn_hop`
splits each DCN payload into ``N`` stripes along its last axis and
rotates stripe ``j`` by ``j`` lanes over the ICI group (``ppermute`` with
:func:`comm.mesh.stripe_lane_perm`), so that it crosses on lane
``(r + j) % L``'s link; after the per-stripe DCN collective the inverse
rotation brings the stripes home and they concatenate back.

**Phase pipelining.**  :func:`pipelined_sync` walks the buckets as JAX's
skewed wavefront: at wave ``t`` bucket ``t``'s ICI reduce-scatter, bucket
``t-1``'s DCN all-reduce and bucket ``t-2``'s ICI all-gather are issued
together (``async_op=True``, the ICI group and the DCN group each
progressing on its own) and waited on in that order.  JAX ties a wave
with ``lax.optimization_barrier`` for XLA's scheduler; here the issue
order is the schedule.  Every per-bucket quantity (a row's scale, its
error-feedback residual) is row-independent, so the wavefront is bitwise
the serial schedule.

:func:`ici_bytes_per_sync` is the within-node byte model, the ICI-side
complement of ``comm.hierarchical.dcn_bytes_per_sync``.
:func:`resolve_channel_stripe` reads the same flag for the pipeline's
point-to-point stage edge (``--pp-compress``'s hops).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..obs.trace import scope
from .collectives import Pending, ppermute
from .compress import _MODE_CODEC, bucket_wire_bytes
from .mesh import stripe_lane_perm

# ``--grad-sync-stripe auto`` caps the lane count: past a few lanes the
# per-stripe payload shrinks under the latency x bandwidth crossover.
_AUTO_STRIPE_CAP = 4

STRIPE_CHOICES = ("auto", "off")  # or an explicit positive lane count


def resolve_stripe(stripe, *, ici_size: int, n_slices: int) -> int:
    """A ``--grad-sync-stripe`` value as a lane count: ``"off"``/``None``
    → 1, ``"auto"`` → ``min(ici_size, 4)``, an explicit N within ``1 <= N
    <= ici_size``; one slice has no DCN hop to stripe, so every value is
    1 there."""
    if stripe in (None, "off", "1", 1):
        return 1
    if stripe == "auto":
        n = min(ici_size, _AUTO_STRIPE_CAP)
    else:
        n = int(stripe)
        if n < 1:
            raise ValueError(f"stripe lane count must be >= 1, got {n}")
        if n > ici_size:
            raise ValueError(
                f"stripe lane count {n} exceeds the ICI sub-axis size "
                f"{ici_size} — there are only {ici_size} distinct "
                "slice-boundary crossing edges to stripe across"
            )
    return 1 if n_slices <= 1 else max(1, n)


def resolve_channel_stripe(stripe) -> int:
    """A ``--grad-sync-stripe`` value for a POINT-TO-POINT channel (the
    pipeline stage edge): no lane rotation bounds the count there, so
    ``"auto"`` is the cap and any explicit ``N >= 1`` is taken."""
    if stripe in (None, "off", "1", 1):
        return 1
    if stripe == "auto":
        return _AUTO_STRIPE_CAP
    n = int(stripe)
    if n < 1:
        raise ValueError(f"stripe lane count must be >= 1, got {n}")
    return n


def split_stripes(x: torch.Tensor, n_stripes: int) -> list[torch.Tensor]:
    """``x``'s last axis in at most ``n_stripes`` contiguous, balanced
    stripes, never an empty one (a component narrower than the lane
    count, such as a per-bucket scale column, uses fewer lanes)."""
    cols = x.shape[-1]
    k = min(n_stripes, cols)
    if k <= 1:
        return [x]
    base, extra = divmod(cols, k)
    return list(x.split([base + (1 if j < extra else 0) for j in range(k)],
                        dim=-1))


def striped_dcn_hop(x: torch.Tensor, hop: Callable, *, ici_group,
                    ici_size: int, n_stripes: int, async_op: bool = False):
    """The DCN collective ``hop(stripe, async_op)`` (a psum or an
    all-gather over the DCN group; it may add a leading axis but keeps
    the last one) applied to ``x`` striped across the ICI lanes: stripe
    ``j`` rotated ``j`` lanes, hopped, rotated home, and the stripes
    concatenated back along the last axis, bitwise ``hop(x)``.  With
    ``n_stripes <= 1`` it is ``hop(x)``.

    Under ``async_op`` it returns a :class:`Pending`: stripe 0's hop and
    the outward rotations are issued now, the remaining hops and the
    rotations home when it is waited on."""
    stripes = split_stripes(x, n_stripes)
    if len(stripes) == 1:
        return hop(x, async_op)
    first = hop(stripes[0], True)
    with scope("grad_sync/stripe"):
        out = [ppermute(s, ici_group, stripe_lane_perm(ici_size, j),
                        async_op=True) for j, s in enumerate(stripes) if j]

    def finish():
        parts = [first.wait()]
        for j, rotated in enumerate(out, start=1):
            g = hop(rotated.wait(), False)
            with scope("grad_sync/stripe"):
                parts.append(ppermute(g, ici_group,
                                      stripe_lane_perm(ici_size, -j)))
        return torch.cat(parts, dim=-1)

    pending = Pending([], finish)
    return pending if async_op else pending.wait()


def pipelined_sync(buckets: torch.Tensor, residual: Any, *, rs: Callable,
                   dcn: Callable, ag: Callable | None, has_residual: bool):
    """The skewed RS/AR/AG wavefront over ``buckets`` (n_buckets, cols).

    ``rs(rows, async_op)`` and ``ag(rows, async_op)`` are the ICI phases
    and ``dcn(part, resid, async_op) -> (summed, resid)`` the DCN phase,
    each on one ``(1, cols)`` bucket row; each returns a
    :class:`Pending` when ``async_op`` is set.  ``ag=None`` keeps the
    scattered form (a 2-deep wavefront).  Returns ``(out, residual)``,
    the rows concatenated, bitwise the serial schedule."""
    nb = buckets.shape[0]
    depth = 2 if ag is None else 3
    part: list = [None] * nb
    summed: list = [None] * nb
    resid_rows: list = [None] * nb
    full: list = [None] * nb
    for t in range(nb + depth - 1):
        i, j = t - 1, t - 2
        wave_rs = rs(buckets[t:t + 1], True) if t < nb else None
        wave_dcn = None
        if 0 <= i < nb:
            r_in = residual[i:i + 1] if has_residual else residual
            wave_dcn = dcn(part[i], r_in, True)
        wave_ag = (ag(summed[j], True)
                   if ag is not None and 0 <= j < nb else None)
        if wave_rs is not None:
            part[t] = wave_rs.wait()
        if wave_dcn is not None:
            summed[i], resid_rows[i] = wave_dcn.wait()
        if wave_ag is not None:
            full[j] = wave_ag.wait()
    rows = summed if ag is None else full
    out = torch.cat(rows, dim=0)
    if has_residual:
        residual = torch.cat(resid_rows, dim=0)
    return out, residual


def ici_bytes_per_sync(
    n_elems: int, n_slices: int, ici_size: int, mode: str,
    *, n_buckets: int = 1, topk_frac: float = 0.1, stripe: int = 1,
    zero1: bool = False,
) -> int:
    """Within-node (ICI) bytes of ONE sync of ``n_elems`` f32 gradients,
    JAX's model: the ring reduce-scatter moves ``(L-1)/L`` of each rank's
    input, ``S*(L-1)*n*4`` bytes over the S slices; the all-gather as much
    again (not under ZeRO-1); striping adds ``(k-1)/k`` of each rank's
    encoded wire payload, out and home."""
    codec = _MODE_CODEC.get(mode)
    if codec is None:
        raise ValueError(f"unknown grad-sync mode {mode!r}")
    if ici_size <= 1:
        return 0
    phase = n_slices * (ici_size - 1) * n_elems * 4
    total = phase
    if not zero1:
        total += phase
    k = min(max(int(stripe), 1), ici_size)
    if k > 1 and n_slices > 1 and mode != "flat":
        shard = n_elems // ici_size
        row = shard // n_buckets
        wire = n_buckets * bucket_wire_bytes(row, codec, topk_frac=topk_frac)
        total += 2 * n_slices * ici_size * (wire * (k - 1) // k)
    return total
