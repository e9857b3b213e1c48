"""The ResNet stem's 3x3 / stride-2 / pad-1 max pool with the slice-based
backward of the JAX package's ``ops/pooling.py``.

``max_pool_3x3_s2`` takes NCHW (any memory format).  Its backward routes
each output gradient to every input of the window equal to the window's
max, by parity-strided slices and shifted compares, with no
select-and-scatter.  It keeps JAX's tie rule: where several inputs of a
window equal its max, each receives the full gradient (the library pool
gives it to one), so it is opt-in and no stock model uses it.  Odd
spatial extents take the library pool's gradient, as JAX's falls back to
``jax.vjp`` of its forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pool(x):
    return F.max_pool2d(x, 3, 2, 1)


def _shift_down(t, fill):
    """t[a] <- t[a + 1] along H, the last row filled."""
    return torch.cat([t[:, :, 1:], torch.full_like(t[:, :, :1], fill)], 2)


def _shift_right(t, fill):
    """t[b] <- t[b + 1] along W, the last column filled."""
    return torch.cat([t[..., 1:], torch.full_like(t[..., :1], fill)], 3)


class _MaxPool3x3S2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _pool(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        h, w = x.shape[2:]
        if h % 2 or w % 2:
            with torch.enable_grad():
                xg = x.detach().requires_grad_()
                (dx,) = torch.autograd.grad(_pool(xg), xg, dy)
            return dx
        neg = float("-inf")
        # Window a covers input rows 2a-1..2a+1: an even row 2a belongs to
        # window a only, an odd row 2a+1 to windows a and a+1 (columns
        # alike).
        y_r, dy_r = _shift_right(y, neg), _shift_right(dy, 0.0)
        y_d, dy_d = _shift_down(y, neg), _shift_down(dy, 0.0)
        terms = {
            (0, 0): [(y, dy)],
            (0, 1): [(y, dy), (y_r, dy_r)],
            (1, 0): [(y, dy), (y_d, dy_d)],
            (1, 1): [(y, dy), (y_r, dy_r), (y_d, dy_d),
                     (_shift_right(y_d, neg), _shift_right(dy_d, 0.0))],
        }
        dx = torch.empty_like(x, dtype=dy.dtype)
        zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
        for (pi, pj), pairs in terms.items():
            xg = x[:, :, pi::2, pj::2]
            g = torch.zeros_like(xg, dtype=dy.dtype)
            for ys, dys in pairs:
                g = g + torch.where(xg == ys, dys, zero)
            dx[:, :, pi::2, pj::2] = g
        return dx


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-2 / pad-1 max pool over NCHW with every tied input
    taking the full gradient."""
    return _MaxPool3x3S2.apply(x)
