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

``grad_sync`` (a ``comm.hierarchical.GradSync``, with the
``process_group`` it syncs over) replaces that all-reduce with the
explicit two-tier sync: the gradients go through its buckets, once per
microbatch or once a step, the loss and metrics are averaged over the
group, and its error-feedback residual threads through
``state.grad_sync_residual`` (gated like the parameters).  As in JAX's
per-device ``shard_map``, the ResNet's BatchNorms then take their
statistics on each rank's own rows, and the new running statistics are
averaged over the group with the metrics.

``state_shardings`` (the layout of a sharded state,
``train.state.infer_state_shardings``; ``state.shardings``) runs the
sharded step of ``parallel/sharded.py``: ``batch`` is this rank's rows
(``BATCH_AXES``: the ranks of one tensor or sequence group take the
same rows, whole), the model gathers its sharded leaves where it uses
them, the gradients come back reduce-scattered to the shards and are
then summed over the data, fsdp and sequence ranks (one flat collective
per reduce group), and the update keeps the state in its layout.  Under
a ``sequence`` axis each rank feeds the model its L/n positions of the
rows and its loss is the sum over those positions of the next-token CE
divided by the rows' B·(L-1) targets, so the sequence ranks' losses sum
to the rows' mean (``--ce-chunk`` included).  Dropout masks are seeded
by the batch and sequence index, never the tensor index, so a tensor
group's replicated activations draw the same masks.  The ResNet's
sync-BN group is the batch group.  ZeRO-1 under the two-tier sync
(``grad_sync`` with ``zero1``) takes the sync's whole mean and keeps
each rank's slot slices of it.

The MoE GPT-2 (``models/moe.py``) adds ``aux_loss_weight`` (0.01, as
in JAX) times its layers' summed load-balancing loss to each
microbatch's objective, and its ``moe_drop_rate`` to the metrics; both
are averaged over the microbatches and the group like the loss (the
reported loss includes the aux term, as JAX's does).  Its routing spans
the ranks JAX's global batch spans: the data-parallel group, or the
sharded mesh's batch group; under the two-tier sync each rank routes
its own rows, as JAX's per-device ``shard_map`` does.  The eval step,
whose batch every rank holds whole, routes it on each rank alone.

``grad_fn`` (``(state, batch, rng) -> (loss, aux, grads)``) replaces the
loss and backward for a path that owns its own schedule: the pipelined
GPT-2 (``parallel/gpt2_pipeline.py::make_pipeline_grad_fn``), whose
gradients come back already combined over its mesh.  ``rng`` is the
step's ``(seed, step)`` (None without ``seed``); microbatching belongs to
the schedule, not ``num_microbatches``.  The gate, the clip and the
optimizer stay the step's.
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


def _lm_head_matrix(params: dict, policy: Policy,
                    layout=None) -> torch.Tensor:
    """The (V, D) LM-head matrix in compute dtype: the untied head's weight
    when present, else the tied token embedding.  ``lm_head`` must win the
    check: ``wte`` exists in both configurations.  A cast of its own, as in
    the JAX step; under a sharded ``layout``, gathered whole."""
    name = "lm_head.weight" if "lm_head.weight" in params else "wte"
    w = params[name].to(policy.compute_dtype)
    return w if layout is None else layout.gather(name, w)


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
             label_smoothing, layout=None, aux_loss_weight=None):
    """Next-token CE of ``tokens``' rows.  Under a sharded ``layout`` with
    a sequence axis the model sees this rank's L/n positions and the
    loss is their share of the rows' mean (module docstring).  With
    ``aux_loss_weight`` (training an MoE model) it returns ``(loss +
    weight * aux, {"moe_drop_rate"})``."""
    cparams = policy.cast_to_compute(params)
    inputs, targets = tokens, tokens[:, 1:]
    n_valid = length = tokens.shape[1]
    share = None
    if layout is not None and layout.sp_size > 1:
        ll = length // layout.sp_size
        off = layout.sp_index * ll
        inputs = tokens[:, off:off + ll]
        targets = tokens[:, off + 1:off + ll + 1]
        share = targets.shape[1] / (length - 1)
    n_valid = targets.shape[1]
    moe = aux_loss_weight is not None and model.cfg.num_experts > 0
    extra = {"return_moe": True} if moe else {}
    if lm_loss_chunk:
        # The head matmul runs inside the chunked, checkpointed loss, so
        # the (B, L, vocab) logits are never resident.
        hidden = torch.func.functional_call(
            model, cparams, (inputs,),
            {"return_hidden": True, "generator": generator, **extra},
        )
        if moe:
            hidden, stats = hidden
        loss = chunked_lm_cross_entropy(
            hidden[:, :n_valid], _lm_head_matrix(params, policy, layout),
            targets, chunk_size=lm_loss_chunk,
            label_smoothing=label_smoothing,
        )
    else:
        logits = torch.func.functional_call(
            model, cparams, (inputs,), {"generator": generator, **extra}
        )
        if moe:
            logits, stats = logits
        loss = cross_entropy_loss(logits[:, :n_valid], targets,
                                  label_smoothing=label_smoothing)
    loss = loss if share is None else loss * share
    if moe:
        return (loss + aux_loss_weight * stats["moe_aux_loss"],
                {"moe_drop_rate": stats["moe_drop_rate"]})
    return loss


def _lm_fn(model, state, *, seed, rank, policy, lm_loss_chunk,
           label_smoothing, aux_loss_weight, route_group, layout=None):
    """``(fn, has_aux)``: the LM loss of one microbatch as accumulation
    calls it, the MoE model's routed over ``route_group`` (module
    docstring)."""
    drop = model.cfg.dropout_rate > 0.0
    moe = model.cfg.num_experts > 0
    if moe:
        from ..models.moe import set_moe_routing

        set_moe_routing(model, route_group)

    def fn(params, mb, i):
        gen = (dropout_generator(seed, state.step, i, rank)
               if drop and seed is not None else None)
        return _lm_loss(model, params, mb["tokens"], policy=policy,
                        generator=gen, lm_loss_chunk=lm_loss_chunk,
                        label_smoothing=label_smoothing, layout=layout,
                        aux_loss_weight=aux_loss_weight if moe else None)

    return fn, moe


def _lm_step_result(value, has_aux):
    """``(loss, extra metrics)`` of an accumulated LM value."""
    return value if has_aux else (value, {})


def _updater(anomaly_policy):
    """The one update gate every path exits through: ``(state, loss,
    grads, batch_stats, residual) -> (state, gate metrics)``."""
    def apply_update(state, loss, grads, batch_stats=None, residual=None):
        if anomaly_policy is None:
            return state.apply_gradients(
                grads, batch_stats=batch_stats,
                grad_sync_residual=residual), {}
        return guarded_apply(state, loss, grads, anomaly_policy,
                             batch_stats=batch_stats,
                             grad_sync_residual=residual)

    return apply_update


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
    aux_loss_weight: float = 0.01,
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
    microbatches), the result the global batch's; ``grad_sync`` syncs
    the gradients in two tiers instead (module docstring).  ``anomaly_policy``
    gates the update (module docstring) and adds the gate's metrics.
    ``grad_fn`` overrides the loss and backward (module docstring).
    ``aux_loss_weight`` scales an MoE model's load-balancing loss."""
    _check_kind(kind)
    if grad_fn is not None:
        return _grad_fn_step(grad_fn, seed, _updater(anomaly_policy))
    if state_shardings is not None:
        return _sharded_train_step(
            state_shardings, kind=kind, policy=policy or Policy(),
            num_microbatches=num_microbatches, seed=seed,
            label_smoothing=label_smoothing, lm_loss_chunk=lm_loss_chunk,
            grad_sync=grad_sync, anomaly_policy=anomaly_policy,
            input_normalize=input_normalize, aux_loss_weight=aux_loss_weight)
    if grad_sync is not None and process_group is None:
        raise ValueError("grad_sync syncs over a process group: pass the "
                         "group it was built on as process_group")
    policy = policy or Policy()
    apply_update = _updater(anomaly_policy)

    sync = None
    if process_group is not None and grad_sync is None:
        def sync(tensors, carry):
            return collectives.pmean(tensors, process_group), carry

    def accumulate(fn, state, batch, has_aux=False):
        """``(value, grads, residual)`` of ``fn`` over the microbatches,
        synced over the group by ``grad_sync`` or by the one all-reduce
        (residual ``None``)."""
        if grad_sync is not None:
            return grad_sync.accumulate_and_sync(
                fn, state.params, batch, num_microbatches,
                residual=state.grad_sync_residual, has_aux=has_aux)
        value, grads = accumulate_gradients(
            fn, state.params, batch, num_microbatches, has_aux=has_aux,
            pass_microbatch_index=True, sync_fn=sync)
        return value, grads, None

    rank = (torch.distributed.get_rank(process_group)
            if process_group is not None else 0)
    if kind == "image_classifier":
        # Sync-BN over the group, except under the two-tier sync, whose
        # ranks each normalize their own rows (JAX's per-device path).
        bn_group = process_group if grad_sync is None else None
        return _image_train_step(policy, _normalize_on(input_normalize,
                                                       policy),
                                 label_smoothing, bn_group, accumulate, seed,
                                 rank, apply_update)

    route_group = process_group if grad_sync is None else None

    def train_step(state: TrainState, batch: dict):
        fn, has_aux = _lm_fn(
            state.model.train(), state, seed=seed, rank=rank, policy=policy,
            lm_loss_chunk=lm_loss_chunk, label_smoothing=label_smoothing,
            aux_loss_weight=aux_loss_weight, route_group=route_group)
        value, grads, residual = accumulate(fn, state, batch, has_aux)
        loss, extra = _lm_step_result(value, has_aux)
        state, gate = apply_update(state, loss, grads, residual=residual)
        return state, {"loss": loss, **extra, **gate}

    return train_step


def _grad_fn_step(grad_fn, seed, apply_update):
    """The step of a path that owns its loss and backward (``grad_fn``)."""
    def train_step(state: TrainState, batch: dict):
        rng = None if seed is None else (seed, state.step)
        loss, aux, grads = grad_fn(state, batch, rng)
        state, gate = apply_update(state, loss, grads)
        return state, {"loss": loss, **aux, **gate}

    return train_step


def _image_train_step(policy, normalize_on, label_smoothing, group,
                      accumulate, seed, rank, apply_update):
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

        (loss, aux), grads, residual = accumulate(fn, state, batch,
                                                  has_aux=True)
        new_stats = aux.pop("batch_stats")
        state, gate = apply_update(state, loss, grads, batch_stats=new_stats,
                                   residual=residual)
        return state, {"loss": loss, **aux, **gate}

    return train_step


def _sharded_train_step(layout, *, kind, policy, num_microbatches, seed,
                        label_smoothing, lm_loss_chunk, grad_sync,
                        anomaly_policy, input_normalize, aux_loss_weight):
    """The train step of a sharded state (module docstring)."""
    from ..comm.mesh import BATCH_AXES

    mesh = layout.mesh
    drop_rank = layout.dropout_rank
    if layout.sp_size > 1 and kind != "lm":
        raise ValueError("sequence parallelism shards a token sequence: "
                         "kind='lm' only")
    zero1 = grad_sync is not None and grad_sync.config.zero1
    if grad_sync is not None and not zero1:
        raise ValueError("a sharded state syncs its own gradients; the "
                         "two-tier sync joins it only as ZeRO-1 "
                         "(GradSyncConfig(zero1=True))")

    apply_update = _updater(anomaly_policy)

    def accumulate(fn, state, batch, has_aux=False):
        names = list(state.params)
        if zero1:
            value, grads, residual = grad_sync.accumulate_and_sync(
                fn, state.params, batch, num_microbatches,
                residual=state.grad_sync_residual, has_aux=has_aux)
            return value, layout.scatter_grads(names, grads), residual
        value, grads = accumulate_gradients(
            fn, state.params, batch, num_microbatches, has_aux=has_aux,
            pass_microbatch_index=True, sync_fn=layout.sync_fn(names))
        return value, grads, None

    if kind == "image_classifier":
        normalize_on = _normalize_on(input_normalize, policy)
        bn_group = mesh.group(BATCH_AXES)
        return _image_train_step(policy, normalize_on, label_smoothing,
                                 bn_group, accumulate, seed, drop_rank,
                                 apply_update)

    route_group = None if zero1 else mesh.group(BATCH_AXES)

    def train_step(state: TrainState, batch: dict):
        fn, has_aux = _lm_fn(
            state.model.train(), state, seed=seed, rank=drop_rank,
            policy=policy, lm_loss_chunk=lm_loss_chunk,
            label_smoothing=label_smoothing, aux_loss_weight=aux_loss_weight,
            route_group=route_group, layout=layout)
        value, grads, residual = accumulate(fn, state, batch, has_aux)
        loss, extra = _lm_step_result(value, has_aux)
        state, gate = apply_update(state, loss, grads, residual=residual)
        return state, {"loss": loss, **extra, **gate}

    return train_step


def step_objective(state: TrainState, *, kind: str = "lm",
                   policy: Policy | None = None,
                   lm_loss_chunk: int | None = None,
                   label_smoothing: float = 0.0,
                   input_normalize: tuple | None = None,
                   aux_loss_weight: float = 0.01):
    """``(params, batch) -> loss``: the objective a train step
    differentiates, on ``state``'s model over the whole ``batch``, with
    no collective (an MoE model routes the batch alone, BatchNorm takes
    its statistics on it).  The flop probe of ``obs/cost.py`` runs it on
    ``meta`` tensors; the forward and backward FLOPs of a step are those
    of its rows, whatever its microbatches.  A sharded state's model
    gathers its leaves with collectives and cannot run there: raises."""
    _check_kind(kind)
    if state.shardings is not None:
        raise NotImplementedError(
            "the flop probe runs one process's model on meta tensors; a "
            "sharded or pipelined state gathers its leaves with "
            "collectives, which cannot run there")
    policy = policy or Policy()
    model = state.model.train()
    if kind == "image_classifier":
        normalize_on = _normalize_on(input_normalize, policy)

        def image_loss(params, batch):
            image = prepare_image_input(batch["image"], policy,
                                        normalize_on(batch["image"].device))
            stats = {n: torch.empty_like(t, device=image.device)
                     for n, t in state.batch_stats.items()}
            logits = _image_forward(model, params, stats, image,
                                    policy=policy, keep=state.keep,
                                    new_stats={})
            return cross_entropy_loss(logits, batch["label"],
                                      label_smoothing=label_smoothing)

        return image_loss
    moe = model.cfg.num_experts > 0
    if moe:
        from ..models.moe import set_moe_routing

        set_moe_routing(model, None)

    def lm_loss(params, batch):
        out = _lm_loss(model, params, batch["tokens"], policy=policy,
                       generator=None, lm_loss_chunk=lm_loss_chunk,
                       label_smoothing=label_smoothing,
                       aux_loss_weight=aux_loss_weight if moe else None)
        return out[0] if moe else out

    return lm_loss


def make_eval_step(
    *,
    kind: str = "lm",
    policy: Policy | None = None,
    lm_loss_chunk: int | None = None,
    input_normalize: tuple | None = None,
    state_shardings: Any = None,
) -> Callable[[TrainState, dict], dict]:
    """``(state, batch) → {"loss"}`` (image classifiers: ``{"loss",
    "accuracy"}``, on the running statistics): no dropout, no
    gradients.  Under ``state_shardings`` every rank evaluates the whole
    batch; a sequence axis splits the positions and sums the shares."""
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
        if model.cfg.num_experts > 0:
            from ..models.moe import set_moe_routing

            # Every rank holds the whole eval batch: it routes it alone,
            # not over the batch group the train step set.
            set_moe_routing(model, None)
        loss = _lm_loss(model, state.params, batch["tokens"], policy=policy,
                        generator=None, lm_loss_chunk=lm_loss_chunk,
                        label_smoothing=0.0, layout=state_shardings)
        if state_shardings is not None and state_shardings.sp_size > 1:
            from ..comm.mesh import AXIS_SEQUENCE

            loss = collectives.psum(
                loss.float(), state_shardings.mesh.group(AXIS_SEQUENCE))
        return {"loss": loss}

    return eval_step
