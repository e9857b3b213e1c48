"""KV-cache codec: the part of the JAX package's ``comm/compress.py`` that
the quantized paged block pool needs (``--serve-kv-dtype``).

A "row" is one position of one head: K/V are stored as int8, or as
two's-complement int4 nibbles packed two per byte, with one bf16 scale
per row, and dequantized at the attention read (inside the paged CUDA
kernels, or in the plain gather path).  The codec is bit-exact with the
JAX one, which is what lets a quantized pool's bytes mean the same thing
in both packages:

- the scale is ``max|x| / qmax`` in f32, clamped to f32 ``tiny``, then
  rounded to bf16;
- the division uses the bf16-rounded scale (the stored value);
- rounding is half-to-even (``torch.round``, as ``jnp.round``);
- int8 clips to [-127, 127], int4 to [-7, 7];
- int4 packs the low nibble from the even column, the high nibble from
  the odd one, into uint8 at Dh / 2.

The gradient-sync codecs of the JAX module wait for the communication
slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

# Storage dtypes the serving KV pool accepts.  "bf16" means no
# quantization: K/V stay in the model's compute dtype.
KV_DTYPES = ("bf16", "int8", "int4")

_TINY = float(np.finfo(np.float32).tiny)


def _row_scale(x: torch.Tensor, qmax: float,
               dtype=torch.float32) -> torch.Tensor:
    """Per-row ``max|x| / qmax`` scale (keepdim), clamped away from zero
    and stored in ``dtype``."""
    scale = x.abs().amax(dim=-1, keepdim=True) / qmax
    return scale.clamp_min(_TINY).to(dtype)


def encode_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., cols) f32 → (packed uint8 (..., cols // 2), scale bf16
    (..., 1)).  ``cols`` must be even."""
    scale = _row_scale(x, 7.0, dtype=torch.bfloat16)
    q = torch.clamp(torch.round(x / scale.float()), -7, 7).to(torch.int8)
    u = torch.where(q < 0, q + 16, q).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4), scale


def decode_int4(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_int4`: → (..., cols) f32."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    q = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    return q.float() * scale.float()


def quantize_kv(x: torch.Tensor, quant: str):
    """(..., Dh) float → (payload, scale (...,) bf16).

    int8: payload (..., Dh) int8.  int4: payload (..., Dh // 2) uint8;
    Dh must be even."""
    x = x.float()
    if quant == "int8":
        scale = _row_scale(x, 127.0, dtype=torch.bfloat16)
        q = torch.clamp(torch.round(x / scale.float()), -127, 127)
        return q.to(torch.int8), scale[..., 0]
    if quant == "int4":
        if x.shape[-1] % 2:
            raise ValueError(
                f"int4 KV packing needs an even head_dim, got {x.shape[-1]}"
            )
        packed, scale = encode_int4(x)
        return packed, scale[..., 0]
    raise ValueError(f"unknown kv quant {quant!r} (int8|int4)")


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  quant: str) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: payload (..., Dh') + scale (...,)
    → (..., Dh) f32."""
    if quant == "int8":
        return q.float() * scale.float()[..., None]
    if quant == "int4":
        return decode_int4(q, scale[..., None])
    raise ValueError(f"unknown kv quant {quant!r} (int8|int4)")
