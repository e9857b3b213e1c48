"""Pipeline parallelism: the JAX package's ``parallel/pipeline.py``, three
schedules over the ``pipeline`` group of a port :class:`~..comm.mesh.Mesh`.

  * :func:`pipeline_forward` — GPipe: M microbatches through M+S-1 ticks,
    a hop (``comm.compress.boundary_permute``) handing each stage's
    output to the next every tick, and autograd through the tick loop and
    the differentiable hops for the backward; bubble (S-1)/(M+S-1).
  * :func:`pipeline_train_1f1b` — PipeDream-flush: a manual forward /
    backward interleave with per-stage recompute; at most ``min(M, S-s)``
    saved stage inputs are live on stage ``s``.
  * :func:`pipeline_train_interleaved` — Megatron's interleaved 1F1B: V
    model chunks per rank, driven by the tables of
    ``pipeline_schedule.make_interleaved_schedule``.

JAX runs one SPMD program under ``shard_map``; the port is MPMD: each
rank holds its stage's parameters (the leaves' stage axis sharded over
``pipeline``: locally ``(1, ...)``, or ``(1, V, ...)`` interleaved) and
runs its own row of the schedule.  What keeps the ranks in step is the
hops: every rank of the pipeline group calls both hops (GPipe: the one
forward hop) on every tick, bubble ticks included, in the same order, so
each point-to-point send meets its receive.  A rank with nothing to send
sends zeros, as JAX's idle ticks permute zeros.

**GPipe's backward** is autograd through the ticks.  For the ranks to
run the hops' inverses in the same order, every hop of every rank must
lie on its rank's graph between the objective and the parameters: each
tick's output depends on what arrived and on the parameters (a bubble
tick passes the arrival on plus a zero taken from a parameter, where
JAX's branch-free loop runs the stage body on it),
stage 0 selects its injected microbatch with ``torch.where`` so the
discarded arrival stays in the graph, and the last tick's arrival enters
the objective with weight 0 (:func:`pipeline_forward`'s ``anchor``).
Each rank's chain of hops is then strictly sequential, and the backward
walks it from the last tick to the first on every rank.  A bubble
tick's output reaches only other bubble ticks, the discarded wrap
arrival and the anchor, so its cotangent is zero and skipping its
stage body changes no gradient.  Under int8 hops the error-feedback
residual carries a leading bubble's output into the first real hop, so
those ticks still compute the stage's value (without a graph) as JAX
does; the trailing ones, whose residual no real hop reads, skip it.

**The manual schedules** run no autograd across ranks: a forward tick
runs the stage under ``no_grad`` and saves its input; a backward tick
recomputes the stage from that input and takes the vector-Jacobian
product with the cotangent that arrived (or the loss's, on the last
stage).  Dropout masks replay because each stage call draws them from
generators seeded by (seed, step, microbatch, virtual stage, layer)
(:func:`fold_seed`, ``models/gpt2.py``'s per-site generators).

After the loop, loss and gradients are combined as JAX's
``_combine_accumulators`` does: averaged over the batch axes (each data
row saw its slice of every microbatch), then the outer leaves (embedding,
final LayerNorm, the tied head) and the loss summed over the pipeline
group, on which each is non-zero on one stage.  Stage leaves are never
summed over ``pipeline``.

JAX's ``_vma_markers`` and ``_scoped_tick`` are ``shard_map`` typing and
XLA trace-scope mechanics; they have no counterpart here.  The GPipe
forward keeps ``remat_ticks``: each tick's stage call runs under
``torch.utils.checkpoint`` (the hop stays outside, so a recompute never
sends again).

Gloo groups carry a CUDA tensor's hop through the host
(``comm/collectives.py``); NCCL groups send it directly.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..comm import collectives
from ..comm.compress import boundary_has_residual, boundary_permute
from ..comm.mesh import (
    AXIS_DATA, AXIS_FSDP, AXIS_PIPELINE, AXIS_SEQUENCE, BATCH_AXES,
)
from ..obs.trace import scope

F32 = torch.float32


def fold_seed(*ints) -> int | None:
    """A dropout seed derived from ``ints`` (JAX's ``fold_in`` chain): the
    same ints give the same seed on every rank and on a recompute; None
    when the first is None (no dropout)."""
    if ints[0] is None:
        return None
    state = np.random.SeedSequence([int(i) for i in ints]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(2))    # a non-negative int64


def stack_stage_params(per_stage_params: list[dict]) -> dict:
    """[stage0, stage1, ...] (dicts of one structure) → one dict with each
    leaf stacked on a new axis 0."""
    return {k: torch.stack([p[k] for p in per_stage_params])
            for k in per_stage_params[0]}


def stack_virtual_stage_params(per_stage_params: list[dict], S: int) -> dict:
    """[vs0, vs1, ...] (S*V dicts, virtual-stage order) → leaves shaped
    (S, V, ...): axis 0 the rank, axis 1 the chunk; rank s holds virtual
    stages ``{v*S + s}``."""
    SV = len(per_stage_params)
    if SV % S:
        raise ValueError(f"{SV} virtual stages not divisible by {S} devices")
    V = SV // S
    return {k: torch.stack([p[k] for p in per_stage_params]).reshape(
        V, S, *per_stage_params[0][k].shape).transpose(0, 1)
        for k in per_stage_params[0]}


def fsdp_gather_leaves(params: dict, fsdp_dims: dict | None, mesh) -> dict:
    """``params`` with each leaf named in ``fsdp_dims`` (name -> dim)
    all-gathered whole over ``fsdp`` along its dim, as a new leaf the
    manual engines differentiate (the gather itself is no part of the
    graph); the others as they are."""
    if not fsdp_dims:
        return params
    group = mesh.group(AXIS_FSDP)
    return {n: collectives.all_gather(p.detach().contiguous(), group,
                                      gather_axis=fsdp_dims[n])
            .requires_grad_() if n in fsdp_dims else p
            for n, p in params.items()}


class _Ring:
    """This rank's place on the pipeline ring: its stage ``s`` of ``S``,
    the ring's group, the two hop permutations, and the axes a gradient
    is summed over (the ranks that see other rows, or other positions)."""

    def __init__(self, mesh, axis_name: str = AXIS_PIPELINE):
        self.mesh = mesh
        self.S = mesh.shape[axis_name]
        self.s = mesh.coords[axis_name]
        self.group = mesh.group(axis_name)
        self.reduce_axes = tuple(a for a in (AXIS_DATA, AXIS_FSDP,
                                             AXIS_SEQUENCE)
                                 if mesh.shape[a] > 1)
        self.n_batch = mesh.axes_size(BATCH_AXES)
        self.next = [(i, (i + 1) % self.S) for i in range(self.S)]
        self.prev = [(i, (i - 1) % self.S) for i in range(self.S)]

    @property
    def first(self) -> bool:
        return self.s == 0

    @property
    def last(self) -> bool:
        return self.s == self.S - 1


def _psum_flat(tensors: list, group) -> list:
    """``tensors`` summed over ``group`` as one flat f32 all-reduce."""
    if group is None or not tensors:
        return [t.to(F32) for t in tensors]
    flat = torch.cat([t.reshape(-1).to(F32) for t in tensors])
    collectives.psum(flat, group)
    return [v.view(t.shape) for v, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]


def _combine_accumulators(ring: _Ring, stage_grads: dict, outer_grads: dict,
                          loss: torch.Tensor, *, fsdp_dims=None,
                          scatter: bool = False):
    """The post-loop combine of every engine (JAX's
    ``_combine_accumulators`` and ``_finalize_fsdp_grads``): the loss and
    every gradient summed over the ranks that saw other rows or positions
    and divided by the batch axes' extent (each rank's loss is its rows'
    mean, or under a ``sequence`` axis its positions' share of it), then
    the loss and the outer gradients summed over the pipeline group.

    ``fsdp_dims`` (name -> dim): stage leaves sharded over ``fsdp``,
    whose gradients are summed over ``fsdp`` already (GPipe: the gather's
    backward reduce-scatters them) or, with ``scatter``, are in gathered
    form and reduce-scattered here (the manual engines' hoisted gather);
    those are then summed over the remaining axes only."""
    fsdp_dims = fsdp_dims or {}
    mesh = ring.mesh
    if scatter:
        group = mesh.group(AXIS_FSDP)
        stage_grads = {n: collectives.reduce_scatter(
            g.contiguous(), group, scatter_axis=fsdp_dims[n])
            if n in fsdp_dims else g for n, g in stage_grads.items()}
    rest_axes = tuple(a for a in ring.reduce_axes if a != AXIS_FSDP)
    whole = [n for n in stage_grads if n not in fsdp_dims]
    split = [n for n in stage_grads if n in fsdp_dims]
    names_o = list(outer_grads)
    tensors = ([stage_grads[n] for n in whole]
               + [outer_grads[n] for n in names_o] + [loss.reshape(1)])
    tensors = [t / ring.n_batch for t in _psum_flat(
        tensors, mesh.group(ring.reduce_axes) if ring.reduce_axes else None)]
    parts = [t / ring.n_batch for t in _psum_flat(
        [stage_grads[n] for n in split],
        mesh.group(rest_axes) if rest_axes else None)]
    stage = {**dict(zip(whole, tensors)), **dict(zip(split, parts))}
    rest = _psum_flat(tensors[len(whole):], ring.group)
    return ({n: stage[n] for n in stage_grads},
            dict(zip(names_o, rest[:-1])), rest[-1].reshape(()))


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

def pipeline_forward(
    stage_fn: Callable,
    stage_params: dict,
    microbatches: torch.Tensor,
    mesh,
    *,
    axis_name: str = AXIS_PIPELINE,
    remat_ticks: bool = False,
    seed: int | None = None,
    boundary_compress: str = "none",
    boundary_stripe: int = 1,
    replicate: bool = False,
    with_aux: bool = False,
):
    """Run (M, mb, ...) ``microbatches`` through the S pipelined stages:
    ``(outputs, anchor)``, with ``with_aux`` ``(outputs, anchor, aux)``.

    ``stage_fn(params, x, seed)`` is one stage on this rank's slice
    ``params`` (``{k: leaf[0]}`` of ``stage_params``, whose leaves are
    the rank's ``(1, ...)`` shard) and one microbatch ``x``; ``seed`` is
    the microbatch's dropout seed (None without ``seed``).  Stage 0
    reads ``microbatches`` (the other ranks only its shape).

    ``outputs`` is the (M, mb, ...) stack on the last stage and None on
    the others; with ``replicate`` (evaluation, no gradient) every rank
    gets the last stage's outputs.  ``anchor`` is a 0-dim zero tied to the
    last tick's arrival: add it to the objective on every rank (the module
    docstring), on the last stage with the loss, elsewhere alone.
    ``remat_ticks`` runs each tick's stage call under
    ``torch.utils.checkpoint``.  ``boundary_compress`` (``--pp-compress``)
    compresses every hop, the backward's cotangent hops included.
    ``with_aux``: ``stage_fn`` returns ``(y, aux)``, ``aux`` a tensor of
    scalars (the MoE stage's aux loss and drop-rate sum), summed here over
    this rank's valid ticks only (a bubble tick's values must not count),
    as JAX's GPipe accumulates them in its scan carry; the caller sums
    them over the stages."""
    ring = _Ring(mesh, axis_name)
    S, s = ring.S, ring.s
    M = microbatches.shape[0]
    params = {k: v[0] for k, v in stage_params.items()}
    cur = torch.zeros_like(microbatches[0])
    pick_first = torch.ones((), dtype=torch.bool, device=cur.device)
    residual = boundary_has_residual(boundary_compress)
    resid = (torch.zeros(cur.shape, dtype=F32, device=cur.device)
             if residual else ())
    tie = next(iter(params.values())).reshape(-1)[0]
    outputs: list = [None] * M
    aux = None

    def call(x, key):
        return stage_fn(params, x, key)

    for t in range(M + S - 1):
        with scope("pipeline/tick"):
            m = t - s
            if ring.first:
                # The arrival (the wrap edge) stays in the graph with a zero
                # cotangent, as JAX's jnp.where keeps it.
                x = torch.where(pick_first, microbatches[min(t, M - 1)], cur)
            else:
                x = cur
            if not 0 <= m < M:
                # A bubble tick (the module docstring): the arrival passes on,
                # tied by a zero to the arrival and to the stage's parameters
                # so that its hop stays on the graph.
                value = x
                if m < 0 and residual:
                    with torch.no_grad():
                        value = call(x, None)
                    if with_aux:
                        value = value[0]
                y = value + (x + tie) * 0
            elif remat_ticks and torch.is_grad_enabled():
                y = checkpoint(call, x, fold_seed(seed, m, s),
                               use_reentrant=False)
            else:
                y = call(x, fold_seed(seed, m, s))
            if with_aux and 0 <= m < M:
                y, tick_aux = y
                aux = tick_aux if aux is None else aux + tick_aux
            if ring.last and m >= 0:
                outputs[m] = y
            cur, resid = boundary_permute(y, resid, ring.group, ring.next,
                                          boundary_compress, boundary_stripe)
    anchor = cur.reshape(-1)[0].float() * 0.0
    out = torch.stack(outputs) if ring.last else None
    if replicate:
        out = _from_last(out, microbatches, ring)
    return (out, anchor, aux) if with_aux else (out, anchor)


@torch.no_grad()
def _from_last(out, like: torch.Tensor, ring: _Ring) -> torch.Tensor:
    """The last stage's ``out`` on every rank of the ring."""
    if ring.group is None:
        return out
    buf = out if ring.last else torch.empty_like(like)
    collectives.broadcast([buf], ring.group, src=ring.S - 1)
    return buf


# ---------------------------------------------------------------------------
# 1F1B
# ---------------------------------------------------------------------------

def _fwd_sched(stage: int, t: int, S: int, M: int) -> tuple[bool, int]:
    """(does ``stage`` run a forward at tick ``t``, its microbatch)."""
    ws = min(M, S - stage)
    f_warm = t - stage
    if 0 <= f_warm < ws:
        return True, f_warm
    off = t - (2 * S - stage)
    f = ws + off // 2
    if off >= 0 and off % 2 == 0 and f < M:
        return True, f
    return False, 0


def _bwd_sched(stage: int, t: int, S: int, M: int) -> tuple[bool, int]:
    off = t - (2 * S - 1 - stage)
    if off >= 0 and off % 2 == 0 and off // 2 < M:
        return True, off // 2
    return False, 0


class _Accumulators:
    """The engines' f32 sums: stage gradients, outer gradients (first and
    last stage), the loss."""

    def __init__(self, stage_params: dict, outer_params: dict, device):
        self.stage = {k: torch.zeros(v.shape, dtype=F32, device=v.device)
                      for k, v in stage_params.items()}
        self.outer = {k: torch.zeros(v.shape, dtype=F32, device=v.device)
                      for k, v in outer_params.items()}
        self.loss = torch.zeros((), dtype=F32, device=device)

    @staticmethod
    def add(acc: dict, names: list, grads) -> None:
        for n, g in zip(names, grads):
            if g is not None:
                acc[n].add_(g)


def _backward_tick(acc: _Accumulators, *, stage_call, first_call, last_fn,
                   stage_params: dict, outer: dict, x_saved, cot, target,
                   first: bool, last: bool):
    """One backward tick: recompute the stage from its saved input (on
    stage 0 from the first function, recomputed too) and take the
    vector-Jacobian product with the cotangent that arrived, or with the
    loss on the last stage.  Adds into ``acc``; returns the input
    cotangent to send back (None on stage 0)."""
    names, outer_names = list(stage_params), list(outer)
    wrt = [stage_params[n] for n in names] + [outer[n] for n in outer_names]
    with torch.enable_grad():
        x = first_call() if first else x_saved.detach().requires_grad_()
        if not first:
            wrt.append(x)
        y = stage_call(x)
        if last:
            loss = last_fn(outer, y, target)
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
            acc.loss.add_(loss.detach().float())
        else:
            grads = torch.autograd.grad(y, wrt, cot, allow_unused=True)
    acc.add(acc.stage, names, grads[:len(names)])
    acc.add(acc.outer, outer_names, grads[len(names):len(wrt) - (not first)])
    return None if first else grads[-1]


def pipeline_train_1f1b(
    first_fn: Callable,
    stage_fn: Callable,
    last_fn: Callable,
    outer_params: dict,
    stage_params: dict,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    mesh,
    *,
    axis_name: str = AXIS_PIPELINE,
    seed: int | None = None,
    boundary_compress: str = "none",
    boundary_stripe: int = 1,
    fsdp_dims: dict | None = None,
):
    """Loss and gradients of one training step under 1F1B:
    ``(loss, (stage_grads, outer_grads))``, combined over the batch axes
    and (loss and outer) over the pipeline group.

    Schedule (JAX's closed form; unit ticks, one-tick hops): stage ``s``
    runs forward ``f`` at tick ``s + f`` for ``f < w_s`` (warmup) and at
    ``2S - s + 2(f - w_s)`` after it, backward ``b`` at ``2S - 1 - s +
    2b``, with ``w_s = min(M, S - s)`` microbatches in flight: the 1F1B
    memory bound.  2(M+S-1) ticks; forward and backward ticks never meet
    on a stage.

    ``first_fn(outer, inputs_mb, seed)``: the stage-0 input (embedding);
    ``stage_fn(params, x, seed)``: one stage on ``{k: leaf[0]}``;
    ``last_fn(outer, y, targets_mb)``: the microbatch's loss INCLUDING the
    1/M average.  ``inputs``/``targets``: (M, mb, ...), this rank's rows.
    ``outer_params`` serve as the first and the last function's
    parameters (the tied embedding); their two gradients are summed.
    The first and last functions run on stage 0 and stage S-1 only.

    ``fsdp_dims`` (name -> dim): stage leaves sharded over ``fsdp``.
    Their whole values are gathered once, before the tick loop (no
    collective runs inside a tick's stage call), the gradients
    accumulate in that whole form and are reduce-scattered after it
    (JAX's hoisted ``fsdp_gather_leaves`` / ``_finalize_fsdp_grads``)."""
    resid = boundary_has_residual(boundary_compress)
    ring = _Ring(mesh, axis_name)
    S, s = ring.S, ring.s
    M = inputs.shape[0]
    T = 2 * (M + S - 1)
    stage_params = fsdp_gather_leaves(stage_params, fsdp_dims, mesh)
    acc = _Accumulators(stage_params, outer_params, inputs.device)
    names = list(stage_params)

    def first_call(f):
        return first_fn(outer_params, inputs[f], fold_seed(seed, f, S))

    def stage_call(f):
        key = fold_seed(seed, f, s)
        return lambda x: stage_fn({k: stage_params[k][0] for k in names},
                                  x, key)

    act = _activation_like(first_fn, outer_params, inputs[0])
    zeros = torch.zeros_like(act)
    rx = rc = (torch.zeros(act.shape, dtype=F32, device=act.device)
               if resid else ())
    y_send, cot_send = zeros, zeros
    in_buf: list = [None] * S
    x_buf: list = [None] * S
    for t in range(T):
        with scope("pipeline/tick"):
            x_in, rx_new = boundary_permute(y_send, rx, ring.group, ring.next,
                                            boundary_compress, boundary_stripe)
            cot_in, rc_new = boundary_permute(cot_send, rc, ring.group,
                                              ring.prev, boundary_compress,
                                              boundary_stripe)
            if resid:
                # A residual commits only on a tick whose send was real.
                if _fwd_sched(s, t - 1, S, M)[0]:
                    rx = rx_new
                if _bwd_sched(s, t - 1, S, M)[0]:
                    rc = rc_new
            sender_did, sender_f = _fwd_sched(s - 1, t - 1, S, M)
            if sender_did and s > 0:
                in_buf[sender_f % S] = x_in
            do_f, f = _fwd_sched(s, t, S, M)
            do_b, b = _bwd_sched(s, t, S, M)
            y_send = cot_send = zeros
            if do_f:
                with torch.no_grad():
                    x = first_call(f) if ring.first else in_buf[f % S]
                    y_send = stage_call(f)(x)
                x_buf[f % S] = x
            if do_b:
                xbar = _backward_tick(
                    acc, stage_call=stage_call(b),
                    first_call=lambda: first_call(b), last_fn=last_fn,
                    stage_params=stage_params, outer=outer_params,
                    x_saved=x_buf[b % S], cot=cot_in, target=targets[b],
                    first=ring.first, last=ring.last)
                x_buf[b % S] = None
                if xbar is not None:
                    cot_send = xbar
    stage, outer, loss = _combine_accumulators(
        ring, acc.stage, acc.outer, acc.loss, fsdp_dims=fsdp_dims,
        scatter=True)
    return loss, (stage, outer)


@torch.no_grad()
def _activation_like(first_fn, outer, x0):
    """Zeros shaped like one stage activation (the first function's
    output; every rank evaluates it, so no rank waits for a shape)."""
    return torch.zeros_like(first_fn(outer, x0, None))


# ---------------------------------------------------------------------------
# interleaved 1F1B
# ---------------------------------------------------------------------------

def pipeline_train_interleaved(
    first_fn: Callable,
    stage_fn: Callable,
    last_fn: Callable,
    outer_params: dict,
    stage_params: dict,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    mesh,
    *,
    num_chunks: int,
    axis_name: str = AXIS_PIPELINE,
    seed: int | None = None,
    boundary_compress: str = "none",
    boundary_stripe: int = 1,
    fsdp_dims: dict | None = None,
):
    """Loss and gradients of one training step under interleaved 1F1B:
    as :func:`pipeline_train_1f1b`, with ``stage_params`` leaves
    ``(1, V, ...)`` locally (``stack_virtual_stage_params``, V =
    ``num_chunks``) and ``stage_fn`` running ONE chunk (1/(S·V) of the
    model) on ``{k: leaf[0, v]}``.  Virtual stage vs = v * S + rank, so a
    chunk crossing takes the same next-rank hop as a stage hop.  Every
    action is a lookup in this rank's row of the schedule's tables."""
    from .pipeline_schedule import make_interleaved_schedule

    resid = boundary_has_residual(boundary_compress)
    ring = _Ring(mesh, axis_name)
    S, s = ring.S, ring.s
    M = inputs.shape[0]
    sched = make_interleaved_schedule(S, num_chunks, M)
    V, T = sched.V, sched.T
    stage_params = fsdp_gather_leaves(stage_params, fsdp_dims, mesh)
    tb = {name: getattr(sched, name)[s].tolist() for name in (
        "f_do", "f_chunk", "f_mb", "f_first", "f_in_slot", "f_save_slot",
        "r_do", "r_slot", "b_do", "b_chunk", "b_mb", "b_first",
        "b_seed_loss", "b_cot_slot", "b_x_slot", "c_do", "c_slot")}
    acc = _Accumulators(stage_params, outer_params, inputs.device)
    names = list(stage_params)

    def first_call(m):
        return first_fn(outer_params, inputs[m], fold_seed(seed, m, S * V))

    def chunk_call(m, v):
        key = fold_seed(seed, m, v * S + s)
        return lambda x: stage_fn(
            {k: stage_params[k][0, v] for k in names}, x, key)

    act = _activation_like(first_fn, outer_params, inputs[0])
    zeros = torch.zeros_like(act)
    rx = rc = (torch.zeros(act.shape, dtype=F32, device=act.device)
               if resid else ())
    y_send, cot_send = zeros, zeros
    in_buf: list = [None] * sched.n_in_slots
    x_buf: list = [None] * sched.n_x_slots
    cot_buf: list = [None] * sched.n_cot_slots
    for t in range(T):
        with scope("pipeline/tick"):
            x_in, rx_new = boundary_permute(y_send, rx, ring.group, ring.next,
                                            boundary_compress, boundary_stripe)
            cot_in, rc_new = boundary_permute(cot_send, rc, ring.group,
                                              ring.prev, boundary_compress,
                                              boundary_stripe)
            if resid and t > 0:
                if tb["f_do"][t - 1]:
                    rx = rx_new
                if tb["b_do"][t - 1]:
                    rc = rc_new
            if tb["r_do"][t]:
                in_buf[tb["r_slot"][t]] = x_in
            if tb["c_do"][t]:
                cot_buf[tb["c_slot"][t]] = cot_in
            y_send = cot_send = zeros
            if tb["f_do"][t]:
                m, v = tb["f_mb"][t], tb["f_chunk"][t]
                with torch.no_grad():
                    x = (first_call(m) if tb["f_first"][t]
                         else in_buf[tb["f_in_slot"][t]])
                    y_send = chunk_call(m, v)(x)
                x_buf[tb["f_save_slot"][t]] = x
            if tb["b_do"][t]:
                m, v = tb["b_mb"][t], tb["b_chunk"][t]
                seeded = bool(tb["b_seed_loss"][t])
                xbar = _backward_tick(
                    acc, stage_call=chunk_call(m, v),
                    first_call=lambda m=m: first_call(m), last_fn=last_fn,
                    stage_params=stage_params, outer=outer_params,
                    x_saved=x_buf[tb["b_x_slot"][t]],
                    cot=None if seeded else cot_buf[tb["b_cot_slot"][t]],
                    target=targets[m], first=bool(tb["b_first"][t]),
                    last=seeded)
                x_buf[tb["b_x_slot"][t]] = None
                if xbar is not None:
                    cot_send = xbar
    stage, outer, loss = _combine_accumulators(
        ring, acc.stage, acc.outer, acc.loss, fsdp_dims=fsdp_dims,
        scatter=True)
    return loss, (stage, outer)
