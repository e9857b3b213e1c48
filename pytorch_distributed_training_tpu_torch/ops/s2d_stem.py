"""Space-to-depth ResNet stem: the counterpart of the JAX package's
``ops/s2d_stem.py``, an exact 7x7 stride-2 convolution computed as a 4x4
stride-1 convolution over the image's 2x2 space-to-depth (12 channels
instead of 3).

The parameter stays the (F, C, 7, 7) kernel of the plain stem, so a
checkpoint fits either stem; the 4x4 kernel is assembled from it by
zero-padding and a reshape.  Output row i covers input rows 2i-3..2i+3,
which sit in s2d blocks i-2..i+1; the (block i-2, parity 0) tap is input
row 2i-4, outside the 7-tap footprint, and stays zero.

The s2d channel order is (row parity, column parity, C), the JAX
version's NHWC order, in both the input and the assembled kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def space_to_depth_2x2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channel order (row parity,
    column parity, C); the result is channels_last in memory."""
    b, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    nhwc = nhwc.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    return nhwc.permute(0, 3, 1, 2)


def expand_kernel_7x7_to_s2d(k77: torch.Tensor) -> torch.Tensor:
    """(F, C, 7, 7) -> (F, 4C, 4, 4): the identical convolution on
    ``space_to_depth_2x2`` input."""
    f, c, kh, kw = k77.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 kernel, got {kh}x{kw}")
    # Tap p (offset p - 3 from row 2i) goes to (block (p - 3) // 2 + 2,
    # parity (p - 3) % 2): one leading zero row and column complete the
    # 8 x 8 grid of 4 blocks x 2 parities.
    k88 = F.pad(k77, (1, 0, 1, 0))
    k = k88.reshape(f, c, 4, 2, 4, 2)      # (F, C, blk_r, par_r, blk_c, par_c)
    k = k.permute(0, 3, 5, 1, 2, 4)        # (F, par_r, par_c, C, blk_r, blk_c)
    return k.reshape(f, 4 * c, 4, 4).contiguous(
        memory_format=torch.channels_last)


def s2d_conv(x: torch.Tensor, k77: torch.Tensor) -> torch.Tensor:
    """``conv2d(x, k77, stride=2, padding=3)`` computed on the s2d input;
    H and W must be even."""
    xs = space_to_depth_2x2(x)
    # Output i reads blocks i-2..i+1: 2 leading, 1 trailing, stride 1.
    return F.conv2d(F.pad(xs, (2, 1, 2, 1)), expand_kernel_7x7_to_s2d(k77))


class SpaceToDepthStem(nn.Module):
    """Drop-in for ``Conv2d(C, F, 7, stride=2, padding=3, bias=False)``
    with the same ``weight``.  An input with an odd H or W takes that
    plain convolution (the JAX model's choice for such an input)."""

    def __init__(self, in_channels: int = 3, features: int = 64, *,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, 7, 7, device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """He fan-out normal, as the JAX stem's ``kernel_init``."""
        f = self.weight.shape[0]
        self.weight.normal_(0.0, math.sqrt(2.0 / (f * 49)),
                            generator=generator)

    def forward(self, x):
        if x.shape[-2] % 2 or x.shape[-1] % 2:
            return F.conv2d(x, self.weight, stride=2, padding=3)
        return s2d_conv(x, self.weight)
