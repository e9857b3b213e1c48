"""Pipeline-parallel GPT-2: the JAX package's ``parallel/gpt2_pipeline.py``
over the port's engines (``parallel/pipeline.py``).

GPT-2's block stack is split into S stages (S·V virtual stages under the
interleaved schedule) whose parameters are stacked on a leading stage
axis: ``stages.layer_j.<block parameter>`` of shape ``(S, ...)`` (or
``(S, V, ...)``), stage ``s`` holding blocks ``s*L .. s*L+L-1`` (L =
layers / stages; interleaved, virtual stage ``vs = v*S + s`` holds blocks
``vs*L ..``).  The embeddings and the final LayerNorm (``wte``, ``wpe``,
``ln_final.*``: JAX's ``outer``) keep the plain model's names and are
replicated.  :func:`pipelined_rules` shards the stage leaves' stage axis
over ``pipeline``, so once ``create_train_state(mesh=..., rules=
pipelined_rules())`` has laid the state out (``parallel/sharded.py``) each
rank keeps its own stage, ``(1, ...)``; the clip's and the anomaly gate's
global norm sum the stage leaves over the pipeline group and count the
replicated outer leaves once, and a checkpoint stores the stacked
tensors whole.  :func:`split_gpt2_params` / :func:`merge_gpt2_params`
(and the interleaved pair) convert to and from the plain model's names;
``checkpoint/manager.py`` uses them to restore a checkpoint into another
layout.

A stage body runs the port's own ``models/gpt2.py`` blocks (each
``stages.layer_j`` module is a ``Block`` whose parameters carry the
stage axis; the body calls it on the rank's slices through
``torch.func.functional_call``).  Dropout masks come from the blocks'
per-site generators, seeded by (seed, step, data rank, microbatch,
virtual stage, layer): a recompute draws the masks its forward drew.

:class:`PipelinedGPT2` trains through :meth:`PipelinedGPT2.value_and_grad`
under every schedule (``make_train_step(grad_fn=make_pipeline_grad_fn(
model))``): GPipe by autograd through ``pipeline_forward``, 1F1B and
interleaved by their manual engines.  Its ``forward`` is the
evaluation path (no gradient): every rank gets the logits.

Compositions (JAX's ``gpt2_pipeline.py:135-405``), chosen by the mesh's
axes (:meth:`PipelinedGPT2.rules`): **PP x data** (each data row pipelines
its own rows); **PP x FSDP** under all three schedules (:func:`pp_fsdp_rules`:
a stage leaf's largest dim also over ``fsdp``, gathered per tick inside
GPipe's stage body and once before the manual engines' loops);
**PP x TP** (:func:`pp_tp_rules`: Megatron's splits of the block dims, the
qkv by head as ``parallel/sharded.py`` lays it out, where JAX permutes
its columns, ``_permute_qkv_cols``; the stage body is the port's tensor-
parallel block); **PP x ring SP** under GPipe (each rank its L/n
positions, ring attention in the stage body).  A leaf split over
``pipeline`` and another axis is ``Placement.stage``'s two-dim layout.

**PP x MoE** (JAX's ``gpt2_pipeline.py:559-664``), under GPipe only: a
stage's odd layers are MoE blocks (each stage holds an even number of
layers, so local parity is global parity), the stage body returns its
MoE layers' aux loss and drop-rate sum, and ``pipeline_forward`` sums
them over valid ticks.  Each data rank routes its own microbatch rows,
as JAX's ``shard_map`` over the batch-sharded microbatches does.  The
objective gains ``aux_loss_weight`` times the aux loss summed over the
MoE layers and averaged over the microbatches; the drop rate is the mean
over (layer, microbatch).  JAX's refusals are kept: another schedule,
an odd number of layers a stage, and tensor, sequence or fsdp axes (and
an expert axis here).
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from ..comm.compress import PP_COMPRESS_MODES
from ..comm.mesh import (
    AXIS_EXPERT, AXIS_FSDP, AXIS_PIPELINE, AXIS_SEQUENCE, AXIS_TENSOR,
)
from ..models.gpt2 import (
    LN_EPS, Block, GPT2Config, _moe_block, _site_generator, dropout,
    is_moe_layer,
)
from ..ops.losses import cross_entropy_loss
from .pipeline import (
    _combine_accumulators, _Ring, fold_seed, pipeline_forward,
    pipeline_train_1f1b, pipeline_train_interleaved, stack_stage_params,
    stack_virtual_stage_params,
)
from .sharding import P, ShardingRules

SCHEDULES = ("gpipe", "1f1b", "interleaved")
_BLOCK = re.compile(r"^blocks\.(\d+)\.(.+)$")
_STAGE = re.compile(r"^stages\.layer_(\d+)\.(.+)$")


def _num_blocks(params: dict) -> int:
    return len({int(m.group(1)) for n in params
                if (m := _BLOCK.match(n))})


def _layer_trees(params: dict, n: int) -> list[dict]:
    return [{m.group(2): t for name, t in params.items()
             if (m := _BLOCK.match(name)) and int(m.group(1)) == i}
            for i in range(n)]


def _outer(params: dict) -> dict:
    return {n: t for n, t in params.items()
            if not _BLOCK.match(n) and not _STAGE.match(n)}


def _stage_leaves(stacked_by_layer: list[dict]) -> dict:
    return {f"stages.layer_{j}.{k}": t
            for j, tree in enumerate(stacked_by_layer)
            for k, t in tree.items()}


def split_gpt2_params(params: dict, num_stages: int) -> dict:
    """Plain GPT-2 names → the pipelined names: stage ``s`` holds blocks
    ``s*L .. s*L+L-1`` (L = layers / stages) as ``layer_0..layer_{L-1}``,
    stacked over the stages on each leaf's axis 0."""
    n = _num_blocks(params)
    if n % num_stages:
        raise ValueError(f"{n} blocks not divisible by {num_stages} stages")
    per = n // num_stages
    layers = _layer_trees(params, n)
    stacked = [stack_stage_params([layers[s * per + j]
                                   for s in range(num_stages)])
               for j in range(per)]
    return {**_outer(params), **_stage_leaves(stacked)}


def _stage_layers(pp_params: dict) -> dict:
    out: dict = {}
    for name, t in pp_params.items():
        if (m := _STAGE.match(name)):
            out.setdefault(int(m.group(1)), {})[m.group(2)] = t
    return out


def merge_gpt2_params(pp_params: dict, num_stages: int) -> dict:
    """Inverse of :func:`split_gpt2_params`."""
    layers = _stage_layers(pp_params)
    per = len(layers)
    merged = dict(_outer(pp_params))
    for s in range(num_stages):
        for j in range(per):
            for k, t in layers[j].items():
                merged[f"blocks.{s * per + j}.{k}"] = t[s]
    return _ordered(merged)


def split_gpt2_params_interleaved(params: dict, num_stages: int,
                                  num_chunks: int) -> dict:
    """Plain GPT-2 names → the interleaved layout, leaves ``(S, V, ...)``:
    virtual stage vs = chunk * S + rank holds blocks ``vs*L ..
    vs*L+L-1`` (L = layers / (S·V))."""
    n = _num_blocks(params)
    sv = num_stages * num_chunks
    if n % sv:
        raise ValueError(f"{n} blocks not divisible by {num_stages} stages "
                         f"x {num_chunks} chunks")
    per = n // sv
    layers = _layer_trees(params, n)
    stacked = [stack_virtual_stage_params(
        [layers[vs * per + j] for vs in range(sv)], num_stages)
        for j in range(per)]
    return {**_outer(params), **_stage_leaves(stacked)}


def merge_gpt2_params_interleaved(pp_params: dict, num_stages: int,
                                  num_chunks: int) -> dict:
    """Inverse of :func:`split_gpt2_params_interleaved`."""
    layers = _stage_layers(pp_params)
    per = len(layers)
    merged = dict(_outer(pp_params))
    for vs in range(num_stages * num_chunks):
        s, v = vs % num_stages, vs // num_stages
        for j in range(per):
            for k, t in layers[j].items():
                merged[f"blocks.{vs * per + j}.{k}"] = t[s, v]
    return _ordered(merged)


def _ordered(params: dict) -> dict:
    """The plain model's parameter order: embeddings, blocks, the rest."""
    def key(name):
        m = _BLOCK.match(name)
        if name in ("wte", "wpe"):
            return (0, ("wte", "wpe").index(name))
        return (1, int(m.group(1))) if m else (2, 0)
    return {n: params[n] for n in sorted(params, key=key)}


def pipelined_layout_of(shapes: dict):
    """The stage layout of a GPT-2 parameter set given by name → shape:
    ``(S, None)`` for leaves ``(S, ...)``, ``(S, V)`` for the interleaved
    ``(S, V, ...)``, None for the plain model's names."""
    shape = shapes.get("stages.layer_0.ln1.weight")
    if shape is None:
        return None
    return (shape[0], shape[1]) if len(shape) == 3 else (shape[0], None)


def to_plain(params: dict) -> dict:
    """Any GPT-2 parameter set (plain or pipelined) under the plain names."""
    layout = pipelined_layout_of({n: tuple(t.shape)
                                  for n, t in params.items()})
    if layout is None:
        return params
    S, V = layout
    if V is None:
        return merge_gpt2_params(params, S)
    return merge_gpt2_params_interleaved(params, S, V)


def from_plain(params: dict, layout) -> dict:
    """The plain names → ``layout`` (``pipelined_layout_of``'s form; None
    keeps them plain)."""
    if layout is None:
        return params
    S, V = layout
    if V is None:
        return split_gpt2_params(params, S)
    return split_gpt2_params_interleaved(params, S, V)


def pipelined_rules() -> ShardingRules:
    """Stage-stacked block leaves shard their leading (stage) axis over
    ``pipeline``; everything else replicates (DDP-style)."""
    return ShardingRules(rules=((r"stages/", P(AXIS_PIPELINE)),),
                         fallback="replicate")


def _pp_fsdp_stage_spec(shape, mesh) -> P:
    """Stage-leaf spec for PP x FSDP: ``pipeline`` on the stage axis plus
    the largest divisible remaining dim over ``fsdp`` (leaves under
    ``MIN_FSDP_SIZE``, biases and LN scales, stay pipeline-only)."""
    from .sharding import MIN_FSDP_SIZE, _fsdp_spec, _sizes

    rest = _fsdp_spec(tuple(shape[1:]), _sizes(mesh)[AXIS_FSDP],
                      MIN_FSDP_SIZE)
    return P(AXIS_PIPELINE, *rest)


def pp_fsdp_rules() -> ShardingRules:
    """PP x FSDP: stage leaves by ``_pp_fsdp_stage_spec``, the outer
    leaves replicated."""
    return ShardingRules(rules=((r"stages/", _pp_fsdp_stage_spec),),
                         fallback="replicate")


def pp_tp_rules(num_chunks: int = 0) -> ShardingRules:
    """PP x TP: the stage axis over ``pipeline`` and Megatron's splits on
    the block dims (column-parallel qkv and mlp_up on their output dim
    and bias, row-parallel proj and mlp_down on their input dim;
    ``models/layers.py`` takes the qkv by head), everything else
    replicated.  ``num_chunks > 0``: the interleaved (S, V, ...) layout,
    each split one dim further right."""
    PP, T = AXIS_PIPELINE, AXIS_TENSOR
    v = (None,) if num_chunks else ()
    return ShardingRules(
        rules=(
            (r"stages/.*attn/qkv/kernel", P(PP, *v, None, T)),
            (r"stages/.*attn/qkv/bias", P(PP, *v, T)),
            (r"stages/.*attn/proj/kernel", P(PP, *v, T, None)),
            (r"stages/.*mlp_up/kernel", P(PP, *v, None, T)),
            (r"stages/.*mlp_up/bias", P(PP, *v, T)),
            (r"stages/.*mlp_down/kernel", P(PP, *v, T, None)),
            (r"stages/", P(PP)),
        ),
        fallback="replicate",
    )


def make_pipeline_grad_fn(model: "PipelinedGPT2",
                          label_smoothing: float = 0.0,
                          accum_steps: int = 1,
                          aux_loss_weight: float = 0.01):
    """The adapter for ``make_train_step(grad_fn=...)``: ``(state, batch,
    rng) -> (loss, aux, grads)`` with ``rng`` the step's ``(seed, step)``
    (None: no dropout).  ``accum_steps > 1`` (GPipe only, as the JAX CLI
    allows it there) runs that many pipeline passes over row slices of
    the batch and averages their losses, gradients and ``aux`` (the MoE
    model's ``moe_drop_rate``; its aux loss, weighted by
    ``aux_loss_weight``, is in the loss)."""
    if accum_steps > 1 and model.schedule != "gpipe":
        raise ValueError("--accum-steps does not compose with "
                         f"--pipeline-schedule {model.schedule}")

    def grad_fn(state, batch, rng):
        loss = grads = stats = None
        for i, part in enumerate(batch["tokens"].chunk(accum_steps)):
            rng_i = None if rng is None or accum_steps == 1 else (*rng, i)
            li, gi, si = model.value_grad_and_stats(
                state.params, part, rng=rng_i,
                label_smoothing=label_smoothing,
                aux_loss_weight=aux_loss_weight)
            if grads is None:
                loss, grads, stats = li, {n: g.float() for n, g in
                                          gi.items()}, si
            else:
                loss = loss + li
                stats = {k: v + si[k] for k, v in stats.items()}
                for n, g in gi.items():
                    grads[n].add_(g)
        inv = 1.0 / accum_steps
        return (loss * inv, {k: v * inv for k, v in stats.items()},
                {n: (g * inv).to(state.params[n].dtype)
                 for n, g in grads.items()})

    return grad_fn


def _stacked_block(cfg: GPT2Config, lead: tuple, device, moe: bool):
    """A ``Block`` (an ``MoeBlock`` with ``moe``) whose every parameter
    carries the stage axes ``lead`` in front (the stage body calls it on
    slices)."""
    block = _moe_block(cfg, device="meta") if moe else Block(cfg,
                                                             device="meta")
    for mod in block.modules():
        for leaf, p in list(mod._parameters.items()):
            mod._parameters[leaf] = nn.Parameter(
                torch.empty((*lead, *p.shape), device=device))
    return block


class PipelinedGPT2(nn.Module):
    """GPT-2 with its block stack run as a pipeline over ``mesh``'s
    ``pipeline`` axis (module docstring).  Built with the whole stacked
    parameters (fill them with :meth:`load_plain`); the sharded train
    state then keeps each rank's stage.

    ``schedule``: ``gpipe`` | ``1f1b`` | ``interleaved`` (``num_chunks``
    model chunks a rank); ``num_microbatches`` M splits each rank's rows;
    ``remat_ticks`` (GPipe) checkpoints each tick's stage call;
    ``pp_compress`` and ``pp_stripe`` compress and stripe the hops;
    ``compute_dtype`` is the policy's."""

    def __init__(self, cfg: GPT2Config, mesh, *, num_microbatches: int = 4,
                 compute_dtype: torch.dtype = torch.float32,
                 axis_name: str = AXIS_PIPELINE, remat_ticks: bool = False,
                 schedule: str = "gpipe", num_chunks: int = 2,
                 pp_compress: str = "none", pp_stripe: int = 1,
                 device=None):
        super().__init__()
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        if pp_compress not in PP_COMPRESS_MODES:
            raise ValueError(
                f"pp_compress {pp_compress!r} not in {PP_COMPRESS_MODES}")
        if cfg.num_experts and schedule != "gpipe":
            # The MoE stage's aux values are summed per tick; only GPipe's
            # tick loop hosts that (JAX's refusal).
            raise ValueError(
                "MoE blocks compose with --pipeline-schedule gpipe only")
        if not cfg.tie_embeddings:
            raise ValueError("pipelined GPT-2 requires tied embeddings")
        self.cfg = cfg
        self.mesh = mesh
        self.num_stages = mesh.shape[axis_name]
        # V model chunks a rank: the interleaved schedule only.
        self.num_chunks = num_chunks if schedule == "interleaved" else 1
        if cfg.num_layers % (self.num_stages * self.num_chunks):
            raise ValueError(
                f"{cfg.num_layers} layers not divisible by "
                f"{self.num_stages} pipeline stages"
                + (f" x {self.num_chunks} chunks"
                   if self.num_chunks > 1 else ""))
        self.tp = mesh.shape[AXIS_TENSOR]
        self.sp = mesh.shape[AXIS_SEQUENCE]
        self.fsdp = mesh.shape[AXIS_FSDP]
        if self.fsdp > 1 and self.tp > 1:
            raise ValueError(
                "pipelined FSDP does not combine with tensor parallelism "
                "(the Megatron kernel splits and the fsdp largest-axis "
                "split contend for the same matmul dims)")
        if self.sp > 1 and schedule != "gpipe":
            raise ValueError(
                "sequence parallelism composes with --pipeline-schedule "
                "gpipe only (collectives inside the manual schedules' "
                "cond-gated stage bodies are unsound)")
        if self.tp > 1:
            if cfg.num_heads % self.tp:
                raise ValueError(
                    f"heads ({cfg.num_heads}) not divisible by the tensor "
                    f"axis ({self.tp})")
            if (cfg.hidden_dim * cfg.mlp_ratio) % self.tp:
                raise ValueError(
                    f"mlp dim ({cfg.hidden_dim * cfg.mlp_ratio}) not "
                    f"divisible by the tensor axis ({self.tp})")
        if cfg.num_experts:
            per_stage = cfg.num_layers // self.num_stages
            if per_stage % 2:
                raise ValueError(
                    f"MoE x PP needs an even number of layers per stage "
                    f"(got {per_stage}: {cfg.num_layers} layers / "
                    f"{self.num_stages} stages) so every stage has the "
                    "same dense/MoE alternation")
            if (self.tp > 1 or self.sp > 1 or self.fsdp > 1
                    or mesh.shape[AXIS_EXPERT] > 1):
                raise ValueError(
                    "MoE x PP composes with plain GPipe only (no "
                    "tensor/sequence/fsdp/expert axes: the stage body runs "
                    "the MoE layer on its rank's rows alone)")
        self.num_microbatches = num_microbatches
        self.compute_dtype = compute_dtype
        self.axis_name = axis_name
        self.remat_ticks = remat_ticks
        self.schedule = schedule
        self.pp_compress = pp_compress
        self.pp_stripe = max(int(pp_stripe), 1)
        self.per = cfg.num_layers // (self.num_stages * self.num_chunks)
        lead = tuple(n for n in self.stage_layout if n is not None)
        d = cfg.hidden_dim
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, d, device=device))
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, d,
                                            device=device))
        self.stages = nn.ModuleDict({f"layer_{j}": _stacked_block(
            cfg, lead, device, is_moe_layer(cfg, j))
            for j in range(self.per)})
        self.ln_final = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self._lead = len(lead)
        # The stage leaves ``fsdp`` splits, by the dim it splits.
        self.fsdp_dims = {}
        if self.fsdp > 1:
            from .sharding import infer_params_sharding

            specs = infer_params_sharding(
                {n: tuple(p.shape) for n, p in self.named_parameters()},
                mesh, self.rules())
            self.fsdp_dims = {n: list(spec).index(AXIS_FSDP)
                              for n, spec in specs.items()
                              if AXIS_FSDP in spec}

    def rules(self) -> ShardingRules:
        """The placement of this model's state on its mesh (the JAX
        CLI's choice): PP x FSDP, PP x TP, or the stage axis alone."""
        if self.fsdp > 1:
            return pp_fsdp_rules()
        if self.tp > 1:
            return pp_tp_rules(self.num_chunks
                               if self.schedule == "interleaved" else 0)
        return pipelined_rules()

    # ---- weights ---------------------------------------------------------

    @property
    def stage_layout(self) -> tuple:
        """``(S, V)`` as ``pipelined_layout_of`` gives it."""
        return (self.num_stages,
                self.num_chunks if self.schedule == "interleaved" else None)

    @torch.no_grad()
    def load_plain(self, params: dict) -> "PipelinedGPT2":
        """Fill the (whole, stacked) parameters from the plain GPT-2's
        (``GPT2.named_parameters()`` names); returns self."""
        split = from_plain(params, self.stage_layout)
        own = dict(self.named_parameters())
        if set(split) != set(own):
            diff = sorted(set(split) ^ set(own))
            raise ValueError(f"plain GPT-2 parameters do not fit: "
                             f"{diff[:3]}")
        for n, p in own.items():
            p.copy_(split[n])
        return self

    # ---- the three functions of a schedule -------------------------------

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.compute_dtype)

    def _offset(self, local_len: int) -> int:
        """The first global position of this rank's ``local_len``
        positions (its sequence shard; 0 without a ``sequence`` axis)."""
        return self.mesh.coords[AXIS_SEQUENCE] * local_len

    def _first_fn(self):
        cfg = self.cfg

        def first_fn(outer, toks, seed=None):
            off = self._offset(toks.shape[-1])
            x = self._cast(outer["wte"][toks]) + \
                self._cast(outer["wpe"][off:off + toks.shape[-1]])[None]
            return dropout(x, cfg.dropout_rate,
                           _site_generator(seed, toks.device))

        return first_fn

    def _stage_fn(self, gather: bool = True):
        """The stage body: the ``per`` blocks of a (virtual) stage on the
        rank's slices, keyed by the model's parameter names, under the
        tensor and sequence axes' layers (``parallel`` set by
        ``parallel/sharded.py::configure_model``).  With ``gather`` each
        call all-gathers the ``fsdp`` shards it uses (GPipe's per-tick
        gather, whose backward reduce-scatters the gradient); the manual
        engines gather once before their loop instead."""
        from ..comm.collectives import gather_sum

        names = [[(f"stages.layer_{j}.{k}", k)
                  for k, _ in self.stages[f"layer_{j}"].named_parameters()]
                 for j in range(self.per)]
        group = (self.mesh.group(AXIS_FSDP) if gather and self.fsdp_dims
                 else None)

        def leaf(n, t):
            t = self._cast(t)
            if group is not None and n in self.fsdp_dims:
                t = gather_sum(t, group, self.fsdp_dims[n] - self._lead)
            return t

        moe = self.cfg.num_experts > 0

        def stage_fn(params, x, seed=None):
            stats = []
            for j in range(self.per):
                block = self.stages[f"layer_{j}"]
                p = {k: leaf(n, params[n]) for n, k in names[j]}
                x = torch.func.functional_call(
                    block, p, (x,), {"dropout_seed": fold_seed(seed, j)})
                if is_moe_layer(self.cfg, j):
                    x, aux, drop_rate = x
                    stats.append(torch.stack([aux, drop_rate]))
            # The MoE stage's (aux loss, drop-rate sum) over its layers.
            return (x, sum(stats[1:], stats[0])) if moe else x

        return stage_fn

    def _hidden(self, outer, y):
        return F.layer_norm(y, (y.shape[-1],),
                            self._cast(outer["ln_final.weight"]),
                            self._cast(outer["ln_final.bias"]), LN_EPS)

    def _logits(self, outer, y):
        return (self._hidden(outer, y) @ self._cast(outer["wte"]).t()).float()

    def _last_fn(self, label_smoothing: float):
        m = self.num_microbatches

        def last_fn(outer, y, toks):
            logits = self._logits(outer, y)
            return cross_entropy_loss(logits[:, :-1], toks[:, 1:],
                                      label_smoothing=label_smoothing) / m

        return last_fn

    # ---- training --------------------------------------------------------

    def _split(self, params: dict) -> tuple[dict, dict]:
        stage = {n: t for n, t in params.items() if _STAGE.match(n)}
        return {n: t for n, t in params.items() if n not in stage}, stage

    def _micro(self, tokens: torch.Tensor) -> torch.Tensor:
        b = tokens.shape[0]
        m = self.num_microbatches
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        return tokens.reshape(m, b // m, *tokens.shape[1:])

    def _base_seed(self, rng):
        """The step's dropout seed for this rank's rows and positions (a
        tensor group's replicated activations draw the same masks)."""
        if rng is None or self.cfg.dropout_rate <= 0.0:
            return None
        return fold_seed(*rng, self.mesh.batch_index,
                         self.mesh.coords[AXIS_SEQUENCE])

    def value_and_grad(self, params: dict, tokens: torch.Tensor, *,
                       rng=None, label_smoothing: float = 0.0):
        """``(loss, grads)`` of one step on this rank's rows ``tokens``
        (B, L), under the model's schedule; ``params`` is the train
        state's (this rank's stage, the replicated outer leaves).  The
        loss is the global batch's mean next-token CE on every rank; the
        gradients are averaged over the batch axes, the outer ones summed
        over the pipeline group, each in its parameter's dtype.  ``rng``:
        the step's ``(seed, step)`` for dropout."""
        return self.value_grad_and_stats(
            params, tokens, rng=rng, label_smoothing=label_smoothing)[:2]

    def value_grad_and_stats(self, params: dict, tokens: torch.Tensor, *,
                             rng=None, label_smoothing: float = 0.0,
                             aux_loss_weight: float = 0.01):
        """``value_and_grad`` and the step's extra metrics: the MoE
        model's ``moe_drop_rate`` (its loss then includes
        ``aux_loss_weight`` times the aux loss, module docstring), none
        for the dense one."""
        micro = self._micro(tokens)
        seed = self._base_seed(rng)
        outer, stage = self._split(params)
        first_fn = self._first_fn()
        stats: dict = {}
        if self.schedule == "gpipe":
            loss, (sgrads, ograds), stats = self._gpipe(
                outer, stage, micro, first_fn, self._stage_fn(), seed,
                label_smoothing, aux_loss_weight)
        else:
            engine, kw = pipeline_train_1f1b, {}
            if self.schedule == "interleaved":
                engine = pipeline_train_interleaved
                kw = {"num_chunks": self.num_chunks}
            loss, (sgrads, ograds) = engine(
                first_fn, self._stage_fn(gather=False),
                self._last_fn(label_smoothing), outer, stage, micro, micro,
                self.mesh, axis_name=self.axis_name, seed=seed,
                boundary_compress=self.pp_compress,
                boundary_stripe=self.pp_stripe, fsdp_dims=self.fsdp_dims,
                **kw)
        grads = {**sgrads, **ograds}
        return loss, {n: grads[n].to(params[n].dtype) for n in params}, stats

    def _gpipe(self, outer, stage, micro, first_fn, stage_fn, seed,
               label_smoothing, aux_loss_weight):
        """GPipe: autograd through ``pipeline_forward``; the head and the
        CE run on the last stage over the whole batch (JAX's ``_forward``
        and the step's loss).  Under a ``sequence`` axis each rank runs
        its L/n positions (ring attention inside the stage body, sound in
        GPipe's ticks: the ranks of a sequence group hold one stage, so
        they run and skip the same ticks) and its loss is their share of
        the rows' mean next-token CE: the sequence ranks' losses sum to
        it."""
        ring = _Ring(self.mesh, self.axis_name)
        M, S = micro.shape[0], ring.S
        length = micro.shape[-1]
        ll = length // self.sp
        off = self._offset(ll)
        inputs = micro[..., off:off + ll]
        targets = micro[..., off + 1:off + ll + 1]
        names = list(outer) + list(stage)
        leaves = [outer[n] for n in outer] + [stage[n] for n in stage]
        with torch.enable_grad():
            if ring.first:
                x = torch.stack([first_fn(outer, inputs[m],
                                          fold_seed(seed, m, S))
                                 for m in range(M)])
            else:
                with torch.no_grad():
                    x = torch.zeros((M, *first_fn(outer, inputs[0]).shape),
                                    dtype=self.compute_dtype,
                                    device=micro.device)
            moe = self.cfg.num_experts > 0
            y, anchor, *aux = pipeline_forward(
                stage_fn, stage, x, self.mesh, axis_name=self.axis_name,
                remat_ticks=self.remat_ticks, seed=seed,
                boundary_compress=self.pp_compress,
                boundary_stripe=self.pp_stripe, with_aux=moe)
            objective = anchor
            loss = torch.zeros((), dtype=torch.float32, device=x.device)
            if moe:
                # This stage's share of the aux loss (summed over its MoE
                # layers, averaged over the microbatches).
                aux_share = aux_loss_weight * aux[0][0] / M
                objective = objective + aux_share
            if ring.last:
                logits = self._logits(outer, y.reshape(-1, *y.shape[2:]))
                n_valid = targets.shape[-1]
                loss = cross_entropy_loss(
                    logits[:, :n_valid], targets.reshape(-1, n_valid),
                    label_smoothing=label_smoothing) * (n_valid
                                                        / (length - 1))
                objective = objective + loss
            grads = torch.autograd.grad(objective, leaves, allow_unused=True)
        grads = {n: torch.zeros_like(p, dtype=torch.float32) if g is None
                 else g.float() for n, p, g in zip(names, leaves, grads)}
        if moe:
            loss = loss + aux_share.detach()
        sgrads, ograds, loss = _combine_accumulators(
            ring, {n: grads[n] for n in stage}, {n: grads[n] for n in outer},
            loss.detach(), fsdp_dims=self.fsdp_dims)
        stats = {}
        if moe:
            stats["moe_drop_rate"] = self._moe_drop_rate(ring, aux[0][1], M)
        return loss, (sgrads, ograds), stats

    def _moe_drop_rate(self, ring, drop_sum, M: int) -> torch.Tensor:
        """The mean drop rate over (MoE layer, microbatch) of the whole
        model and the batch axes, from this stage's sum."""
        axes = ring.reduce_axes + (self.axis_name,)
        total = drop_sum.detach().float().reshape(1)
        group = self.mesh.group(axes)
        if group is not None:
            from ..comm.collectives import psum

            total = psum(total.clone(), group)
        n_moe = self.cfg.num_layers // 2
        return (total / (ring.n_batch * n_moe * M)).reshape(())

    # ---- evaluation ------------------------------------------------------

    def forward(self, tokens, *, generator=None, return_hidden: bool = False):
        """(B, L) tokens → (B, L, vocab) f32 logits on every rank, without
        a gradient (evaluation; training goes through
        :meth:`value_and_grad`).  The interleaved layout runs V successive
        GPipe ramps, one per chunk; dropout is off.  Under a ``sequence``
        axis ``tokens`` are this rank's L/n positions, as the plain
        model takes them."""
        if torch.is_grad_enabled():
            raise ValueError(
                "PipelinedGPT2.forward is the evaluation path; train via "
                "make_pipeline_grad_fn / value_and_grad")
        params = dict(self.named_parameters())
        outer, stage = self._split(params)
        micro = self._micro(tokens)
        x = torch.stack([self._first_fn()(outer, mb) for mb in micro])
        stage_fn = self._stage_fn()
        chunks = ([{n: t[:, v] for n, t in stage.items()}
                   for v in range(self.num_chunks)]
                  if self.schedule == "interleaved" else [stage])
        for chunk in chunks:
            x = pipeline_forward(
                stage_fn, chunk, x, self.mesh, axis_name=self.axis_name,
                boundary_compress=self.pp_compress,
                boundary_stripe=self.pp_stripe, replicate=True,
                with_aux=self.cfg.num_experts > 0)[0]
        x = x.reshape(-1, *x.shape[2:])
        if return_hidden:
            return self._hidden(outer, x)
        return self._logits(outer, x)


def pipelined_gpt2(net, mesh, **kwargs) -> PipelinedGPT2:
    """A :class:`PipelinedGPT2` of the plain GPT-2 ``net``'s config and
    weights, on ``net``'s device (the CLI's ``--pipeline-parallel``)."""
    device = net.wte.device
    pp = PipelinedGPT2(net.cfg, mesh, device=device, **kwargs)
    return pp.load_plain(dict(net.named_parameters()))


__all__ = [
    "PipelinedGPT2", "pipelined_gpt2", "pipelined_rules",
    "make_pipeline_grad_fn", "split_gpt2_params", "merge_gpt2_params",
    "split_gpt2_params_interleaved", "merge_gpt2_params_interleaved",
    "to_plain", "from_plain", "pipelined_layout_of", "SCHEDULES",
    "pp_fsdp_rules", "pp_tp_rules", "relayout_checkpoint",
]


def relayout_checkpoint(tensors: dict, want_shapes: dict) -> dict:
    """Checkpoint entries (``params/<name>``, ``opt_state/<path>/<name>``:
    ``checkpoint/manager.py``'s names) of a GPT-2 saved under one stage
    layout, in the layout whose whole shapes ``want_shapes`` gives (the
    template's, same names): merged to the plain model's names and split
    again, for the parameters and each per-parameter slot alike.  Entries
    already in that layout, and every other entry, pass unchanged."""
    def params_of(d):
        return {k[len("params/"):]: tuple(v if isinstance(v, tuple)
                                          else v.shape)
                for k, v in d.items() if k.startswith("params/")}

    have, want = params_of(tensors), params_of(want_shapes)
    if have == want or "wte" not in have:
        return tensors
    dst = pipelined_layout_of(want)
    if dst is None and pipelined_layout_of(have) is None:
        return tensors
    groups: dict = {}
    out = {}
    for key, t in tensors.items():
        prefix, _, name = key.rpartition("/")
        if name in have:
            groups.setdefault(prefix, {})[name] = t
        else:
            out[key] = t
    for prefix, named in groups.items():
        for name, t in from_plain(to_plain(named), dst).items():
            out[f"{prefix}/{name}"] = t.contiguous()
    return out
