"""Gradient transformations with optax's semantics, on lists of tensors.

The JAX package composes its optimizers from optax (``cli/main.py``):
``adam`` is coupled L2 (``add_decayed_weights → scale_by_adam →
scale_by_learning_rate``), ``adamw`` is ``optax.adamw``, ``sgd`` is
coupled L2 then momentum, and ``--grad-clip`` is ``clip_by_global_norm``
in front.  These are the same transformations, written out so the port
needs no JAX: each has ``init(params) -> state`` and ``update(updates,
state, params) -> (updates, state)`` over lists of tensors in one fixed
order.  Learning-rate schedules are host functions of the step count, so
evaluating one never waits for the device.

State tensors (moments, momentum) are updated in place: the port keeps
one copy of them, where JAX returns new arrays.

**The gated update** (``update(..., ok=...)``, the anomaly gate of
``resilience/anomaly.py``).  In JAX optax's counts (Adam's bias
correction, the schedule's position) live in ``opt_state`` and the
gate's ``lax.cond`` keeps them with everything else, so a skipped step
moves neither.  Here they are host ints, and the host cannot know
whether a step was skipped without waiting for the device.  So under the
gate each count becomes a 0-dim int64 tensor on the device (uploaded
once, at the first gated update) that advances only where ``ok``; the
values that depend on it — Adam's ``1 / (1 - b**count)`` and the
schedule's learning rate — are read from f32 tables computed on the
host once and read on the device (``index_select``: subscripting a
tensor with a 0-dim index tensor reads the index back to the host), and
go into the ``_foreach`` ops as 0-dim tensors.  Both paths multiply: a CUDA division by a Python scalar
is a product with its f32 reciprocal, a division by a device tensor is
not, so Adam's bias correction is a product on either path, by the same
f32 reciprocal (``_reciprocal``), and a table entry is the value the
host path passes.  So for f32 parameters the gated update is bitwise
the ungated one when ``ok`` holds (a bf16 parameter list would see the
scalar rounded to bf16 instead).  The new moments are computed out of
place, by the same ops in the same order, and written with one
``torch.where`` per tensor (``select_``): a skipped step leaves every
state tensor bitwise as it was.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

Schedule = Callable[[int], float]


@dataclasses.dataclass
class Transform:
    """optax.GradientTransformation: ``init`` and ``update``.
    ``update(updates, state, params, ok=None, groups=None)``: ``ok``, a
    0-dim bool device tensor, gates the state's advance (module
    docstring); ``groups`` are the tensors' shard groups, for the global
    norm (``global_norm``)."""

    init: Callable[[list], Any]
    update: Callable[..., tuple[list, Any]]


def _no_state(params):
    return ()


def select_(ok: torch.Tensor, new: list, old: list) -> None:
    """``old`` becomes ``new`` where ``ok`` holds and stays as it is
    otherwise, bit for bit: one ``torch.where`` per tensor, in place."""
    for n, o in zip(new, old):
        torch.where(ok, n, o, out=o)


def _device_count(count, device) -> torch.Tensor:
    """A count as the gated update keeps it: a 0-dim int64 tensor on
    ``device`` (a host int is uploaded once)."""
    if isinstance(count, torch.Tensor):
        return count
    return torch.tensor(count, dtype=torch.int64, device=device)


def _lookup(tables: dict, key, values: Callable[[], list],
            index: torch.Tensor) -> torch.Tensor:
    """``values()[index]`` as a 0-dim f32 tensor on ``index``'s device,
    clamped to the last entry; the table is built and uploaded once into
    ``tables`` (the transform's own).  ``index_select``, not
    ``table[index]``: a 0-dim index tensor as a subscript is read back to
    the host, a sync every step."""
    key = (key, index.device)
    if key not in tables:
        tables[key] = torch.tensor(values(), dtype=torch.float32,
                                   device=index.device)
    table = tables[key]
    return torch.index_select(
        table, 0, index.clamp(max=table.numel() - 1).view(1)).view(())


def _reciprocal(c: float) -> float:
    """``1 / c`` as a CUDA kernel divides by a Python scalar: both rounded
    to f32 (exact as a Python float)."""
    return float(np.float32(1.0) / np.float32(c))


def _bias_corrections(b: float) -> list:
    """``_reciprocal(1 - b**k)`` for k = 1, 2, ... (k = 0 unused) until
    it rounds to 1, after which every later entry would too."""
    values, k = [0.0], 1
    while True:
        values.append(_reciprocal(1.0 - b ** k))
        if values[-1] == 1.0:
            return values
        k += 1


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params, ok=None, groups=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params, ok=ok, groups=groups)
            new_state.append(s)
        return updates, tuple(new_state)

    return Transform(init, update)


def global_norm(tensors: list, groups: list | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32, on the device:
    the tensors' own norms in a few multi-tensor launches, then the norm
    of those.  ``groups`` (one per tensor, None where the tensor is
    whole on every rank) names the process group a sharded tensor is
    split over: its squares are summed over that group, so the result is
    the norm of the whole gradient on every rank, never a rank's local
    one (which would clip, and gate, differently on each rank)."""
    norms = torch._foreach_norm(tensors, dtype=torch.float32)
    if groups is None or all(g is None for g in groups):
        return torch.linalg.vector_norm(torch.stack(norms))
    from ..comm.collectives import psum

    by_group: dict = {}
    for n, g in zip(norms, groups):
        by_group.setdefault(g, []).append(n)
    total = None
    for g, ns in by_group.items():
        sq = torch.stack(ns).square().sum()
        if g is not None:
            sq = psum(sq, g)
        total = sq if total is None else total + sq
    return total.sqrt()


def clip_by_global_norm(max_norm: float) -> Transform:
    """optax's rule: below ``max_norm`` the updates pass unchanged, else
    each becomes ``(u / norm) * max_norm``.  The norm stays on the device;
    the choice is a ``where``, not a host branch."""
    def update(updates, state, params, ok=None, groups=None):
        norm = global_norm(updates, groups)
        keep = norm < max_norm
        return [torch.where(keep, u, (u / norm.to(u.dtype)) * max_norm)
                for u in updates], state

    return Transform(_no_state, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    """updates + weight_decay * params (coupled L2 when placed first)."""
    def update(updates, state, params, ok=None, groups=None):
        if weight_decay == 0.0:
            return updates, state
        return torch._foreach_add(updates, params, alpha=weight_decay), state

    return Transform(_no_state, update)


@dataclasses.dataclass
class AdamState:
    count: int | torch.Tensor    # a device tensor once gated
    mu: list
    nu: list


def scale_by_adam() -> Transform:
    """mu = (1-b1) g + b1 mu; nu = (1-b2) g² + b2 nu; the update is
    mu_hat / (sqrt(nu_hat) + eps) with bias corrections 1 - b^count
    (applied as products with their f32 reciprocals), at optax's b1 0.9,
    b2 0.999, eps 1e-8 (the JAX CLI keeps them)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    tables: dict = {}

    def init(params):
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(updates, state, params, ok=None, groups=None):
        if ok is None:
            torch._foreach_mul_(state.mu, b1)
            torch._foreach_add_(state.mu, updates, alpha=1.0 - b1)
            torch._foreach_mul_(state.nu, b2)
            torch._foreach_addcmul_(state.nu, updates, updates,
                                    value=1.0 - b2)
            state.count += 1
            mu, nu = state.mu, state.nu
            c1 = _reciprocal(1.0 - b1 ** state.count)
            c2 = _reciprocal(1.0 - b2 ** state.count)
        else:
            # The same ops out of place; the moments and the count are
            # written only where ``ok``.
            count = _device_count(state.count, updates[0].device)
            k = count + 1
            mu = torch._foreach_mul(state.mu, b1)
            torch._foreach_add_(mu, updates, alpha=1.0 - b1)
            nu = torch._foreach_mul(state.nu, b2)
            torch._foreach_addcmul_(nu, updates, updates, value=1.0 - b2)
            c1 = _lookup(tables, b1, lambda: _bias_corrections(b1), k)
            c2 = _lookup(tables, b2, lambda: _bias_corrections(b2), k)
        mu_hat = torch._foreach_mul(mu, c1)
        denom = torch._foreach_mul(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(mu_hat, denom)
        if ok is not None:
            select_(ok, mu, state.mu)
            select_(ok, nu, state.nu)
            state.count = torch.where(ok, k, count)
        return mu_hat, state

    return Transform(init, update)


def trace(decay: float) -> Transform:
    """Momentum as optax.trace: t = g + decay * t; the update is t."""
    def init(params):
        return [torch.zeros_like(p) for p in params]

    def update(updates, state, params, ok=None, groups=None):
        if ok is not None:
            trace_ = torch._foreach_mul(state, decay)
            torch._foreach_add_(trace_, updates)
            select_(ok, trace_, state)
            return trace_, state
        torch._foreach_mul_(state, decay)
        torch._foreach_add_(state, updates)
        # The update aliases the trace: every later transform here is
        # out of place.
        return list(state), state

    return Transform(init, update)


@dataclasses.dataclass
class CountState:
    count: int | torch.Tensor    # a device tensor once gated


def scale_by_learning_rate(lr: float | Schedule) -> Transform:
    """updates * -lr(count), the count advancing once per update.  A
    gated update reads a schedule's value from its table, which needs the
    ``horizon`` the schedules here carry: the count from which the value
    stays constant."""
    schedule = lr if callable(lr) else (lambda count: lr)
    tables: dict = {}

    def update(updates, state, params, ok=None, groups=None):
        if ok is None:
            step = -float(schedule(state.count))
            state.count += 1
            return torch._foreach_mul(updates, step), state
        count = _device_count(state.count, updates[0].device)
        if callable(lr):
            horizon = getattr(lr, "horizon", None)
            if horizon is None:
                raise ValueError(
                    "a gated update needs a schedule with a horizon "
                    "(train/optim.py's schedules carry one)")
            step = _lookup(tables, "lr", lambda: [
                -float(lr(c)) for c in range(horizon + 1)], count)
        else:
            step = -float(lr)
        state.count = torch.where(ok, count + 1, count)
        return torch._foreach_mul(updates, step), state

    return Transform(lambda params: CountState(0), update)


def adamw(lr: float | Schedule, weight_decay: float) -> Transform:
    """optax.adamw: adam's update plus the decoupled weight decay, scaled
    by the learning rate together."""
    return chain(scale_by_adam(), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(lr))


def sgd(lr: float | Schedule, momentum: float | None = None) -> Transform:
    """optax.sgd: momentum (when given) then the learning rate."""
    parts = [trace(momentum)] if momentum else []
    return chain(*parts, scale_by_learning_rate(lr))


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    def schedule(count):
        if transition_steps <= 0:
            return init_value
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    schedule.horizon = max(transition_steps, 0)
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """init_value * (1 + cos(pi * count / decay_steps)) / 2, held at 0 past
    decay_steps."""
    if decay_steps <= 0:
        raise ValueError(
            f"cosine_decay_schedule needs positive decay_steps, got "
            f"{decay_steps}"
        )

    def schedule(count):
        count = min(count, decay_steps)
        return init_value * 0.5 * (1.0 + math.cos(math.pi * count
                                                   / decay_steps))

    schedule.horizon = decay_steps
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """Linear warmup to ``peak_value`` over ``warmup_steps``, then cosine
    decay to 0 by ``decay_steps`` (warmup included)."""
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps)

    def schedule(count):
        return warmup(count) if count < warmup_steps \
            else decay(count - warmup_steps)

    schedule.horizon = max(warmup_steps, decay_steps)
    return schedule
