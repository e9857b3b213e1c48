"""Parallelism of the port: gradient accumulation, data-parallel
replication, the placement rules (``sharding``) and the sharded state
they lay out (``sharded``: FSDP, tensor parallelism, ZeRO-1, sequence
parallelism), ring attention and Ulysses, and pipeline parallelism
(``pipeline_schedule``'s tables, ``pipeline``'s GPipe, 1F1B and
interleaved engines, ``gpt2_pipeline``'s pipelined GPT-2), and the
tensor-parallel serving replica (``shard_for_serving``)."""

from .gpt2_pipeline import (
    PipelinedGPT2, make_pipeline_grad_fn, pipelined_rules, pp_fsdp_rules,
    pp_tp_rules,
)
from .grad_accum import accumulate_gradients
from .pipeline import (
    pipeline_forward, pipeline_train_1f1b, pipeline_train_interleaved,
)
from .pipeline_schedule import make_interleaved_schedule
# `ring_attention` is the JAX package's public name for the function; the
# module is reached by a from-import of its path
# (`from ..parallel.ring_attention import`).
# graftcheck: disable=init-shadows-submodule — the JAX package's public name
from .ring_attention import ring_attention, ring_self_attention
from .sharded import ShardedLayout, configure_model, shard_for_serving
from .sharding import (
    DDP_RULES, FSDP_RULES, MIN_FSDP_SIZE, ZERO1_OPT_RULES, P, ShardingRules,
    batch_sharding, infer_params_sharding, replicate_state, serve_tp_rules, shard_batch, shard_params, tp_rules_for,
)
from .ulysses import ulysses_attention

__all__ = [
    "accumulate_gradients", "replicate_state", "ShardingRules", "P",
    "DDP_RULES", "FSDP_RULES", "ZERO1_OPT_RULES", "MIN_FSDP_SIZE",
    "tp_rules_for", "serve_tp_rules", "shard_for_serving", "infer_params_sharding", "shard_params",
    "batch_sharding", "shard_batch", "ShardedLayout", "configure_model",
    "ring_attention", "ring_self_attention", "ulysses_attention",
    "PipelinedGPT2", "make_pipeline_grad_fn", "pipelined_rules",
    "pp_fsdp_rules", "pp_tp_rules", "pipeline_forward",
    "pipeline_train_1f1b", "pipeline_train_interleaved",
    "make_interleaved_schedule",
]
