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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Schedule = Callable[[int], float]


@dataclasses.dataclass
class Transform:
    """optax.GradientTransformation: ``init`` and ``update``."""

    init: Callable[[list], Any]
    update: Callable[[list, Any, list], tuple[list, Any]]


def _no_state(params):
    return ()


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return Transform(init, update)


def global_norm(tensors: list) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32, on the device."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def clip_by_global_norm(max_norm: float) -> Transform:
    """optax's rule: below ``max_norm`` the updates pass unchanged, else
    each becomes ``(u / norm) * max_norm``.  The norm stays on the device;
    the choice is a ``where``, not a host branch."""
    def update(updates, state, params):
        norm = global_norm(updates)
        keep = norm < max_norm
        return [torch.where(keep, u, (u / norm.to(u.dtype)) * max_norm)
                for u in updates], state

    return Transform(_no_state, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    """updates + weight_decay * params (coupled L2 when placed first)."""
    def update(updates, state, params):
        if weight_decay == 0.0:
            return updates, state
        return torch._foreach_add(updates, params, alpha=weight_decay), state

    return Transform(_no_state, update)


@dataclasses.dataclass
class AdamState:
    count: int
    mu: list
    nu: list


def scale_by_adam() -> Transform:
    """mu = (1-b1) g + b1 mu; nu = (1-b2) g² + b2 nu; the update is
    mu_hat / (sqrt(nu_hat) + eps) with bias corrections 1 - b^count, at
    optax's b1 0.9, b2 0.999, eps 1e-8 (the JAX CLI keeps them)."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def init(params):
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(updates, state, params):
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, updates, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, updates, updates, value=1.0 - b2)
        state.count += 1
        mu_hat = torch._foreach_div(state.mu, 1.0 - b1 ** state.count)
        denom = torch._foreach_div(state.nu, 1.0 - b2 ** state.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(mu_hat, denom)
        return mu_hat, state

    return Transform(init, update)


def trace(decay: float) -> Transform:
    """Momentum as optax.trace: t = g + decay * t; the update is t."""
    def init(params):
        return [torch.zeros_like(p) for p in params]

    def update(updates, state, params):
        torch._foreach_mul_(state, decay)
        torch._foreach_add_(state, updates)
        # The update aliases the trace: every later transform here is
        # out of place.
        return list(state), state

    return Transform(init, update)


@dataclasses.dataclass
class CountState:
    count: int


def scale_by_learning_rate(lr: float | Schedule) -> Transform:
    """updates * -lr(count), the count advancing once per update."""
    schedule = lr if callable(lr) else (lambda count: lr)

    def update(updates, state, params):
        step = -float(schedule(state.count))
        state.count += 1
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

    return schedule
