"""The skip-step gate: a bad update becomes a no-op on the device, with no
host sync.  The counterpart of the JAX package's ``resilience/anomaly.py``.

The rule is JAX's:

- ``bad = ~isfinite(loss) | ~isfinite(|g|) [| |g| > threshold]``, where
  ``|g|`` is the global norm of the raw (pre-clip) gradients: one scalar
  that any non-finite gradient poisons;
- on a bad step the parameters, the optimizer state (its counts
  included), ``batch_stats`` and the two-tier sync's error-feedback
  residual keep their old values bit for bit, while
  ``state.step`` still advances (the data order and the checkpoint
  cadence stay step-indexed);
- a device-side :class:`ResilienceState` (the bad streak and the
  run's total of skips) rides the ``TrainState``, so the host reads it
  only where it waits for the device anyway, at the trainer's log
  points, and hands it to ``recovery.RecoveryManager``.

JAX takes both branches of a ``lax.cond``.  Eager PyTorch cannot branch
on a device value without waiting for it, so the update always runs and
its writes are selected (``TrainState.apply_gradients(..., ok=...)``:
the new values computed out of place, then one ``torch.where`` a tensor).
The optimizer's counts, host ints in the port, become device tensors that
only the gate advances (``train/optim.py``), so a skipped step moves
neither the learning rate nor Adam's bias correction, as in JAX.  With
nothing firing the gated update is bitwise the ungated one.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AnomalyPolicy:
    """The gate's configuration.  ``grad_norm_threshold=None`` skips
    non-finite steps only; a float also skips finite steps whose gradient
    norm exceeds it (clipping rescales a spike; this rejects it)."""

    grad_norm_threshold: float | None = None


@dataclasses.dataclass
class ResilienceState:
    bad_streak: torch.Tensor     # consecutive skipped steps (int32, 0-dim)
    skipped_total: torch.Tensor  # skipped steps of the run (int32, 0-dim)


def init_resilience_state(device=None) -> ResilienceState:
    """Zero counters on ``device`` (default: the CUDA device)."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    return ResilienceState(
        bad_streak=torch.zeros((), dtype=torch.int32, device=device),
        skipped_total=torch.zeros((), dtype=torch.int32, device=device),
    )


def guarded_apply(state, loss: torch.Tensor, grads: dict,
                  policy: AnomalyPolicy, batch_stats: dict | None = None,
                  grad_sync_residual=None):
    """``state.apply_gradients(grads, batch_stats, grad_sync_residual)``
    behind the gate.
    Returns ``(new_state, metrics)`` with the gate's metrics
    (``grad_norm``, ``skipped``, ``bad_streak``, ``skipped_total``), all
    device tensors."""
    if not isinstance(state.resilience, ResilienceState):
        raise ValueError(
            "anomaly policy needs state.resilience initialized — "
            "dataclasses.replace(state, resilience=init_resilience_state("
            "device))")
    from ..train.optim import global_norm   # (train imports this module)

    names = list(grads)
    groups = (state.shardings.norm_groups(names)
              if state.shardings is not None else None)
    # The norm of the whole gradient on every rank (sharded leaves'
    # squares summed over their groups), so every rank takes one decision.
    grad_norm = global_norm([grads[n] for n in names], groups)
    bad = ~torch.isfinite(loss) | ~torch.isfinite(grad_norm)
    if policy.grad_norm_threshold is not None:
        bad = bad | (grad_norm > policy.grad_norm_threshold)
    new = state.apply_gradients(grads, batch_stats=batch_stats, ok=~bad,
                                grad_sync_residual=grad_sync_residual)
    skipped = bad.to(torch.int32)
    resilience = ResilienceState(
        bad_streak=(state.resilience.bad_streak + 1) * skipped,
        skipped_total=state.resilience.skipped_total + skipped,
    )
    metrics = {"grad_norm": grad_norm, "skipped": skipped,
               "bad_streak": resilience.bad_streak,
               "skipped_total": resilience.skipped_total}
    return dataclasses.replace(new, resilience=resilience), metrics
