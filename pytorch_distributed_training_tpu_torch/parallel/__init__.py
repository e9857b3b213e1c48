"""Parallelism of the port: gradient accumulation and data-parallel
replication (tensor, pipeline and sequence parallelism are later
slices)."""

from .grad_accum import accumulate_gradients
from .sharding import replicate_state

__all__ = ["accumulate_gradients", "replicate_state"]
