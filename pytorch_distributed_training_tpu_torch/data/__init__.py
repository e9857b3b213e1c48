"""Data pipeline of the port: the LM datasets and the sharded loader with
pinned-memory prefetch to the device (the image datasets, transforms and
native gathers are later slices)."""

from .datasets import Subset, SyntheticTokens, TokenFile
from .loader import DataLoader, DataLoaderConfig, prefetch_to_device

__all__ = [
    "Subset", "SyntheticTokens", "TokenFile", "DataLoader",
    "DataLoaderConfig", "prefetch_to_device",
]
