"""Mixed-precision policy: the dtype map of the JAX package's
``train/policy.py``.

Master parameters keep ``param_dtype``; matmuls run in ``compute_dtype``.
bf16 shares f32's exponent range, so no loss scaling is needed.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """param_dtype: storage (master) dtype; compute_dtype: matmul dtype."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32


def make_policy(name: str) -> Policy:
    """"f32" | "bf16" (mixed: f32 master, bf16 compute) | "bf16_full"."""
    if name in ("f32", "float32", "fp32"):
        return Policy()
    if name in ("bf16", "bfloat16", "mixed"):
        return Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
    if name == "bf16_full":
        return Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    raise ValueError(f"Unknown precision policy {name!r}")
