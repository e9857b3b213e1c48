"""The train and eval steps: the counterpart of the JAX package's
``train/step.py`` for language models (``kind="lm"``).

One call of the train step runs the microbatches' forward and backward
passes (``parallel/grad_accum.py``) and the optimizer update.  As in the
JAX step, every float parameter is cast to the compute dtype inside the
graph (``Policy.cast_to_compute``) and the model runs on those copies
through ``torch.func.functional_call``, so the master parameters receive
their gradients through the cast.  Nothing in the step reads a value back
to the host: the returned loss is a device tensor.

Not yet ported: ``kind="image_classifier"``, ``grad_fn`` (pipeline
schedules), ``grad_sync`` (the explicit two-tier sync), ``anomaly_policy``
and ``state_shardings``; they raise.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..ops.losses import chunked_lm_cross_entropy, cross_entropy_loss
from ..parallel.grad_accum import accumulate_gradients
from .policy import Policy
from .state import TrainState


def _not_ported(**options) -> None:
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(f"{name} is not yet ported")


def _check_kind(kind: str) -> None:
    if kind == "image_classifier":
        raise NotImplementedError(
            "kind='image_classifier' is not yet ported (the ResNet/ViT slices)"
        )
    if kind != "lm":
        raise ValueError(f"Unknown step kind {kind!r}")


def _lm_head_matrix(params: dict, policy: Policy) -> torch.Tensor:
    """The (V, D) LM-head matrix in compute dtype: the untied head's weight
    when present, else the tied token embedding.  ``lm_head`` must win the
    check: ``wte`` exists in both configurations.  A cast of its own, as in
    the JAX step."""
    if "lm_head.weight" in params:
        return params["lm_head.weight"].to(policy.compute_dtype)
    return params["wte"].to(policy.compute_dtype)


def dropout_generator(seed: int, step: int, microbatch: int) -> torch.Generator:
    """The host generator a microbatch's dropout draws from, seeded by
    (seed, step, microbatch): fresh noise every step, distinct masks per
    accumulation slice, the same draws on a rerun."""
    mixed = np.random.SeedSequence([seed, step, microbatch]).generate_state(
        1, np.uint64
    )[0]
    return torch.Generator().manual_seed(int(mixed))


def _lm_loss(model, params, tokens, *, policy, generator, lm_loss_chunk,
             label_smoothing):
    cparams = policy.cast_to_compute(params)
    if lm_loss_chunk:
        # The head matmul runs inside the chunked, checkpointed loss, so
        # the (B, L, vocab) logits are never resident.
        hidden = torch.func.functional_call(
            model, cparams, (tokens,),
            {"return_hidden": True, "generator": generator},
        )
        return chunked_lm_cross_entropy(
            hidden[:, :-1], _lm_head_matrix(params, policy), tokens[:, 1:],
            chunk_size=lm_loss_chunk, label_smoothing=label_smoothing,
        )
    logits = torch.func.functional_call(
        model, cparams, (tokens,), {"generator": generator}
    )
    return cross_entropy_loss(logits[:, :-1], tokens[:, 1:],
                              label_smoothing=label_smoothing)


def make_train_step(
    *,
    kind: str = "lm",
    policy: Policy | None = None,
    num_microbatches: int = 1,
    seed: int | None = None,
    label_smoothing: float = 0.0,
    lm_loss_chunk: int | None = None,
    grad_fn: Any = None,
    grad_sync: Any = None,
    anomaly_policy: Any = None,
    state_shardings: Any = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``(state, batch) → (state, metrics)`` for ``batch = {"tokens": (B,
    L)}``, next-token CE.  ``num_microbatches > 1`` accumulates over that
    many splits of the batch.  ``seed`` (the JAX step's ``base_rng``)
    seeds dropout per (seed, step, microbatch); without it a model with
    dropout raises."""
    _check_kind(kind)
    _not_ported(grad_fn=grad_fn, grad_sync=grad_sync,
                anomaly_policy=anomaly_policy,
                state_shardings=state_shardings)
    policy = policy or Policy()

    def train_step(state: TrainState, batch: dict):
        model = state.model.train()
        drop = model.cfg.dropout_rate > 0.0

        def fn(params, mb, i):
            gen = (dropout_generator(seed, state.step, i)
                   if drop and seed is not None else None)
            return _lm_loss(model, params, mb["tokens"], policy=policy,
                            generator=gen, lm_loss_chunk=lm_loss_chunk,
                            label_smoothing=label_smoothing)

        loss, grads = accumulate_gradients(
            fn, state.params, batch, num_microbatches,
            pass_microbatch_index=True,
        )
        state = state.apply_gradients(grads)
        return state, {"loss": loss}

    return train_step


def make_eval_step(
    *,
    kind: str = "lm",
    policy: Policy | None = None,
    lm_loss_chunk: int | None = None,
) -> Callable[[TrainState, dict], dict]:
    """``(state, batch) → {"loss"}``: no dropout, no gradients."""
    _check_kind(kind)
    policy = policy or Policy()

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        model = state.model.eval()
        loss = _lm_loss(model, state.params, batch["tokens"], policy=policy,
                        generator=None, lm_loss_chunk=lm_loss_chunk,
                        label_smoothing=0.0)
        return {"loss": loss}

    return eval_step
