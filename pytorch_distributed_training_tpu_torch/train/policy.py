"""Mixed-precision policy: the dtype map of the JAX package's
``train/policy.py``.

Master parameters keep ``param_dtype``; the model runs in
``compute_dtype``.  bf16 shares f32's exponent range, so no loss scaling
is needed.  This is not ``torch.autocast``: as in the JAX step, EVERY
float parameter (embeddings and LayerNorm included) is cast to the
compute dtype, and the cast stays in the autograd graph, so the gradient
that reaches a master parameter is the compute-dtype gradient cast back.
The exception is ``keep``: the fused BatchNorms' ``scale``/``bias`` go in
as the f32 masters and are rounded inside the norm
(``ops/fused_norm.py``), which is what JAX's ``custom_vjp`` makes of the
cast.

``f32`` on the card keeps PyTorch's defaults: matmuls in full f32
(``torch.backends.cuda.matmul.allow_tf32`` is False) and cuDNN
convolutions in TF32 (``torch.backends.cudnn.allow_tf32`` is True: inputs
rounded to a 10-bit mantissa, f32 accumulation), as the reference's own
PyTorch run on a GPU gets them.  A caller that needs f32 convolutions
turns that switch off (``chip_smoke.py``'s card-against-host check does).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """param_dtype: storage (master) dtype; compute_dtype: matmul dtype."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, params: dict, keep=frozenset()) -> dict:
        """Cast float tensors to the compute dtype (others, and the names
        in ``keep``, untouched)."""
        return {k: v if k in keep else _cast_one(v, self.compute_dtype)
                for k, v in params.items()}

    def cast_to_param(self, params: dict) -> dict:
        return _cast(params, self.param_dtype)


def _cast_one(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return v.to(dtype) if v.is_floating_point() else v


def _cast(params: dict, dtype: torch.dtype) -> dict:
    return {k: _cast_one(v, dtype) for k, v in params.items()}


def make_policy(name: str) -> Policy:
    """"f32" | "bf16" (mixed: f32 master, bf16 compute) | "bf16_full"."""
    if name in ("f32", "float32", "fp32"):
        return Policy()
    if name in ("bf16", "bfloat16", "mixed"):
        return Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
    if name == "bf16_full":
        return Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    raise ValueError(f"Unknown precision policy {name!r}")
