"""Parallelism of the port: gradient accumulation, data-parallel
replication, the placement rules (``sharding``) and the sharded state
they lay out (``sharded``: FSDP, tensor parallelism, ZeRO-1, sequence
parallelism), ring attention and Ulysses (pipeline parallelism is a
later slice)."""

from .grad_accum import accumulate_gradients
from .ring_attention import ring_attention, ring_self_attention
from .sharded import ShardedLayout, configure_model
from .sharding import (
    DDP_RULES, FSDP_RULES, MIN_FSDP_SIZE, ZERO1_OPT_RULES, P, ShardingRules,
    batch_sharding, infer_params_sharding, replicate_state, shard_batch,
    shard_params, tp_rules_for,
)
from .ulysses import ulysses_attention

__all__ = [
    "accumulate_gradients", "replicate_state", "ShardingRules", "P",
    "DDP_RULES", "FSDP_RULES", "ZERO1_OPT_RULES", "MIN_FSDP_SIZE",
    "tp_rules_for", "infer_params_sharding", "shard_params",
    "batch_sharding", "shard_batch", "ShardedLayout", "configure_model",
    "ring_attention", "ring_self_attention", "ulysses_attention",
]
