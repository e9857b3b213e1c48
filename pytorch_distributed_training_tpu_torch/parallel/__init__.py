"""Parallelism of the port: gradient accumulation so far (data, tensor,
pipeline and sequence parallelism are later slices)."""

from .grad_accum import accumulate_gradients

__all__ = ["accumulate_gradients"]
