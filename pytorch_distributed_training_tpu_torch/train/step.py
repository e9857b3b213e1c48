"""The train and eval steps: the counterpart of the JAX package's
``train/step.py`` for language models (``kind="lm"``) and image
classifiers (``kind="image_classifier"``).

One call of the train step runs the microbatches' forward and backward
passes (``parallel/grad_accum.py``) and the optimizer update.  As in the
JAX step, every float parameter is cast to the compute dtype inside the
graph (``Policy.cast_to_compute``) and the model runs on those copies
through ``torch.func.functional_call``, so the master parameters receive
their gradients through the cast.  Nothing in the step reads a value back
to the host: the returned metrics are device tensors.

Image batches are ``{"image": (B, H, W, C), "label": (B,)}``, NHWC as the
loader yields them (f32, or uint8 scaled on the device by
``prepare_image_input``); the model takes the NCHW view of the same
memory.  The ResNet's running statistics go into the functional call as
buffers and its new ones come back in a dict: each microbatch computes
them from the same old statistics, and the step stores their mean, as
the JAX step's scan does.  The eval step uses the running statistics.
The fused BatchNorms' ``scale``/``bias`` (``TrainState.keep``) skip the
policy's cast (they round themselves, ``ops/fused_norm.py``).  A model
with neither running statistics nor fused norms (the ViT) takes the same
step with both empty; one whose ``dropout_rate`` is above 0 gets the
dropout generator of ``dropout_generator``.

Data parallelism (``process_group``): each rank runs the step on its
rows of the global batch; the f32 gradient sums, the loss and the
metrics are averaged over the group by one all-reduce after the
microbatch loop (``comm.collectives.pmean`` as accumulation's
``sync_fn``), so the optimizer, its clip included, sees the global
gradients and the returned metrics are global means.  The ResNet's
BatchNorms take their statistics over the group (sync-BN), so the new
running statistics are the same on every rank.

``anomaly_policy`` (a ``resilience.AnomalyPolicy``) puts every path's
update behind the skip gate (``resilience/anomaly.py``): a non-finite
loss or gradient norm (or a norm over the threshold) keeps the old
parameters, optimizer state and statistics while the step advances; the
state must carry ``resilience=init_resilience_state(device)``.  Under
data parallelism the gradients are averaged before the gate, so every
rank takes the same decision without another collective.

Not yet ported: ``grad_fn`` (pipeline schedules), ``grad_sync`` (the
explicit two-tier sync) and ``state_shardings``; they raise.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..comm import collectives
from ..ops.losses import chunked_lm_cross_entropy, cross_entropy_loss
from ..parallel.grad_accum import accumulate_gradients
from ..resilience.anomaly import guarded_apply
from .policy import Policy
from .state import TrainState


def _not_ported(**options) -> None:
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(f"{name} is not yet ported")


def _check_kind(kind: str) -> None:
    if kind not in ("lm", "image_classifier"):
        raise ValueError(f"Unknown step kind {kind!r}")


def prepare_image_input(x: torch.Tensor, policy: Policy,
                        normalize: tuple | None) -> torch.Tensor:
    """Device-side ToTensor(+Normalize) of an NHWC batch, returned as the
    NCHW view of the same memory (``channels_last``).  uint8 input is
    scaled by 1/255 in the compute dtype and, with ``normalize = (mean,
    std)``, normalized per channel; float input passes through (the host
    pipeline already scaled it).  The steps pass ``normalize`` as tensors
    already on the batch's device (``_normalize_on``), so no call copies
    from the host."""
    if x.dtype == torch.uint8:
        dt = policy.compute_dtype
        x = x.to(dt) / torch.tensor(255.0, dtype=dt)
        if normalize is not None:
            mean, std = (torch.as_tensor(v, dtype=dt, device=x.device)
                         for v in normalize)
            x = (x - mean) / std
    return x.permute(0, 3, 1, 2)


def _normalize_on(normalize: tuple | None, policy: Policy):
    """``device -> (mean, std)``: ``input_normalize`` as compute-dtype
    tensors on that device, uploaded once per device rather than once a
    step (None without ``normalize``)."""
    by_device: dict = {}

    def on(device) -> tuple | None:
        if normalize is None:
            return None
        if device not in by_device:
            by_device[device] = tuple(
                torch.as_tensor(v, dtype=policy.compute_dtype, device=device)
                for v in normalize)
        return by_device[device]

    return on


def _image_forward(model, params, batch_stats, image, *, policy, keep,
                   new_stats: dict | None, group=None, generator=None):
    """The model on the compute-dtype parameters (those named in ``keep``
    as given) and the running statistics; in training its new statistics
    go into ``new_stats``, over ``group``'s ranks when one is given.  A
    dropout ``generator``, when there is one, goes in as well."""
    tensors = {**policy.cast_to_compute(params, keep), **batch_stats}
    kwargs = {"new_stats": new_stats, "group": group}
    if generator is not None:
        kwargs["generator"] = generator
    return torch.func.functional_call(model, tensors, (image,), kwargs)


def _accuracy(logits, labels):
    return (logits.argmax(-1) == labels).float().mean()


def _lm_head_matrix(params: dict, policy: Policy) -> torch.Tensor:
    """The (V, D) LM-head matrix in compute dtype: the untied head's weight
    when present, else the tied token embedding.  ``lm_head`` must win the
    check: ``wte`` exists in both configurations.  A cast of its own, as in
    the JAX step."""
    if "lm_head.weight" in params:
        return params["lm_head.weight"].to(policy.compute_dtype)
    return params["wte"].to(policy.compute_dtype)


def dropout_generator(seed: int, step: int, microbatch: int,
                      rank: int = 0) -> torch.Generator:
    """The host generator a microbatch's dropout draws from, seeded by
    (seed, step, microbatch, rank): fresh noise every step, distinct
    masks per accumulation slice and per data-parallel rank (whose rows
    differ), the same draws on a rerun.  JAX draws one mask over the
    global batch, which no choice of seeds here reproduces bit for bit."""
    mixed = np.random.SeedSequence(
        [seed, step, microbatch, rank]).generate_state(1, np.uint64)[0]
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
    input_normalize: tuple | None = None,
    process_group: Any = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``(state, batch) → (state, metrics)``.  ``kind="lm"``: ``batch =
    {"tokens": (B, L)}``, next-token CE, metrics ``{"loss"}``.
    ``kind="image_classifier"``: ``batch = {"image", "label"}``, CE with
    ``label_smoothing``, metrics ``{"loss", "accuracy"}``, and the model's
    running statistics updated; ``input_normalize`` is the per-channel
    (mean, std) applied to uint8 images on the device.
    ``num_microbatches > 1`` accumulates over that many splits of the
    batch.  ``seed`` (the JAX step's ``base_rng``) seeds dropout per
    (seed, step, microbatch, rank); without it a model with dropout
    raises.  ``process_group`` (a ``torch.distributed`` group) makes the
    step data-parallel over its ranks: ``batch`` is this rank's rows
    (``data.DataLoader`` with ``num_microbatches`` hands out JAX's
    microbatches), the result the global batch's.  ``anomaly_policy``
    gates the update (module docstring) and adds the gate's metrics."""
    _check_kind(kind)
    _not_ported(grad_fn=grad_fn, grad_sync=grad_sync,
                state_shardings=state_shardings)
    policy = policy or Policy()

    def apply_update(state, loss, grads, batch_stats=None):
        """The one update gate every path exits through."""
        if anomaly_policy is None:
            return state.apply_gradients(grads, batch_stats=batch_stats), {}
        return guarded_apply(state, loss, grads, anomaly_policy,
                             batch_stats=batch_stats)

    sync = None
    if process_group is not None:
        def sync(tensors):
            return collectives.pmean(tensors, process_group)
    rank = (torch.distributed.get_rank(process_group)
            if process_group is not None else 0)
    if kind == "image_classifier":
        return _image_train_step(policy, num_microbatches,
                                 _normalize_on(input_normalize, policy),
                                 label_smoothing, process_group, sync, seed,
                                 rank, apply_update)

    def train_step(state: TrainState, batch: dict):
        model = state.model.train()
        drop = model.cfg.dropout_rate > 0.0

        def fn(params, mb, i):
            gen = (dropout_generator(seed, state.step, i, rank)
                   if drop and seed is not None else None)
            return _lm_loss(model, params, mb["tokens"], policy=policy,
                            generator=gen, lm_loss_chunk=lm_loss_chunk,
                            label_smoothing=label_smoothing)

        loss, grads = accumulate_gradients(
            fn, state.params, batch, num_microbatches,
            pass_microbatch_index=True, sync_fn=sync,
        )
        state, gate = apply_update(state, loss, grads)
        return state, {"loss": loss, **gate}

    return train_step


def _image_train_step(policy, num_microbatches, normalize_on,
                      label_smoothing, group, sync, seed, rank, apply_update):
    def train_step(state: TrainState, batch: dict):
        model = state.model.train()
        drop = getattr(model, "dropout_rate", 0.0) > 0.0

        def fn(params, mb, i):
            gen = (dropout_generator(seed, state.step, i, rank)
                   if drop and seed is not None else None)
            image = prepare_image_input(mb["image"], policy,
                                        normalize_on(mb["image"].device))
            new_stats: dict = {}
            logits = _image_forward(model, params, state.batch_stats, image,
                                    policy=policy, keep=state.keep,
                                    new_stats=new_stats, group=group,
                                    generator=gen)
            loss = cross_entropy_loss(logits, mb["label"],
                                      label_smoothing=label_smoothing)
            return loss, {"accuracy": _accuracy(logits, mb["label"]),
                          "batch_stats": new_stats}

        (loss, aux), grads = accumulate_gradients(
            fn, state.params, batch, num_microbatches, has_aux=True,
            pass_microbatch_index=True, sync_fn=sync,
        )
        new_stats = aux.pop("batch_stats")
        state, gate = apply_update(state, loss, grads, batch_stats=new_stats)
        return state, {"loss": loss, **aux, **gate}

    return train_step


def make_eval_step(
    *,
    kind: str = "lm",
    policy: Policy | None = None,
    lm_loss_chunk: int | None = None,
    input_normalize: tuple | None = None,
) -> Callable[[TrainState, dict], dict]:
    """``(state, batch) → {"loss"}`` (image classifiers: ``{"loss",
    "accuracy"}``, on the running statistics): no dropout, no
    gradients."""
    _check_kind(kind)
    policy = policy or Policy()
    normalize_on = _normalize_on(input_normalize, policy)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        model = state.model.eval()
        if kind == "image_classifier":
            image = prepare_image_input(batch["image"], policy,
                                        normalize_on(batch["image"].device))
            logits = _image_forward(model, state.params, state.batch_stats,
                                    image, policy=policy,
                                    keep=state.keep, new_stats=None)
            return {"loss": cross_entropy_loss(logits, batch["label"]),
                    "accuracy": _accuracy(logits, batch["label"])}
        loss = _lm_loss(model, state.params, batch["tokens"], policy=policy,
                        generator=None, lm_loss_chunk=lm_loss_chunk,
                        label_smoothing=0.0)
        return {"loss": loss}

    return eval_step
