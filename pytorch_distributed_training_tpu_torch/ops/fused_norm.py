"""Output-saving BatchNorm: the BatchNorm part of the JAX package's
``ops/fused_norm.py``.

``batch_norm``, ``bn_relu`` and ``bn_add_relu`` are
``torch.autograd.Function``s whose saved activation is the normalized
output ``z``, not the input ``x``.  BN is affine and invertible, so the
backward rebuilds ``xhat = (z - beta) / gamma`` (with the JAX version's
clamped denominator) and the conv output that fed the BN is never kept
for the gradient.  The ReLU that follows needs only the sign of ``z``
(``bn_relu``); the block tail ``relu(bn(x) + r)`` recomputes its mask
from ``(z, r)`` (``bn_add_relu``).  The reconstruction divides by
``gamma``: a gamma initialized to exactly zero (zero-init residual) makes
``xhat`` unrecoverable, so the model takes the plain composition there.

The tensors are NCHW (any memory format); statistics reduce over every
dimension but 1.  Statistics are computed in f32 (f64 for an f64 input)
as ``E[x]`` and ``E[x^2] - E[x]^2`` (the biased variance); ``scale`` and
``bias`` are folded to the input's dtype before ``x * scale + bias``.

The modules keep flax's layout: parameters ``scale``/``bias`` and the
running ``mean``/``var`` buffers, all f32.  In training they update the
running statistics as ``m * old + (1 - m) * batch`` with ``m = 0.9`` and
the biased batch variance (``torch.nn.BatchNorm2d`` stores the unbiased
one).  ``BatchNorm`` is the plain composition's norm, flax
``nn.BatchNorm``'s math, differentiated by autograd: the reference the
fused functions are held against, and the model's norm when
``tpu_fused=False`` or ``zero_init_residual=True``.
"""

from __future__ import annotations

import torch
from torch import nn

F32 = torch.float32


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, F32)


def _reduce_dims(x: torch.Tensor) -> list[int]:
    return [0, *range(2, x.ndim)]


def _channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over ``x``'s channel dim 1."""
    return v.view(1, -1, *([1] * (x.ndim - 2)))


def _bn_core(x, gamma, beta, eps):
    """Forward math of the three functions: returns (z, mean, var)."""
    xf = x.to(_stat_dtype(x))
    dims = _reduce_dims(x)
    mean = xf.mean(dims)
    var = (xf * xf).mean(dims) - mean * mean
    rstd = torch.rsqrt(var + eps)
    scale = (gamma * rstd).to(x.dtype)
    bias = (beta - mean * gamma * rstd).to(x.dtype)
    return x * _channel(scale, x) + _channel(bias, x), mean, var


def _bn_bwd_core(z, gamma, beta, var, dz, eps):
    """The BN gradient with ``xhat`` rebuilt from the output ``z``:
    returns (dx, dgamma, dbeta).  A |gamma| below 1e-12 is replaced by
    1e-12 with gamma's sign, so a transiently tiny gamma still
    reconstructs without overflow and without flipping xhat's sign."""
    stat = _stat_dtype(z)
    rstd = torch.rsqrt(var + eps)
    g = gamma.to(stat)
    tiny = torch.full_like(g, 1e-12)
    safe_g = torch.where(g.abs() < tiny, torch.copysign(tiny, g), g)
    xhat = (z.to(stat) / _channel(safe_g, z)
            - _channel(beta.to(stat) / safe_g, z))
    dims = _reduce_dims(z)
    n = z.numel() // z.shape[1]
    dzf = dz.to(stat)
    sum_dz = dzf.sum(dims)
    sum_dz_xhat = (dzf * xhat).sum(dims)
    dx = _channel(g * rstd, z) * (dzf - _channel(sum_dz / n, z)
                                  - xhat * _channel(sum_dz_xhat / n, z))
    return dx.to(z.dtype), sum_dz_xhat, sum_dz


def _relu_grad(z, dy):
    """d max(z, 0) / dz as JAX's ``jnp.maximum`` gives it: 1 above 0, a
    half at a tie, 0 below."""
    return torch.where(z > 0, dy,
                       torch.where(z == 0, dy * 0.5, torch.zeros_like(dy)))


class _BatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        z, mean, var = _bn_core(x, gamma, beta, eps)
        ctx.save_for_backward(z, gamma, beta, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        z, gamma, beta, var = ctx.saved_tensors
        return (*_bn_bwd_core(z, gamma, beta, var, dz, ctx.eps), None)


class _BNRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        z, mean, var = _bn_core(x, gamma, beta, eps)
        ctx.save_for_backward(z, gamma, beta, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return z.clamp_min(0), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        z, gamma, beta, var = ctx.saved_tensors
        dz = _relu_grad(z, dy)
        return (*_bn_bwd_core(z, gamma, beta, var, dz, ctx.eps), None)


class _BNAddRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, gamma, beta, eps):
        z, mean, var = _bn_core(x, gamma, beta, eps)
        ctx.save_for_backward(z, r, gamma, beta, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return (z + r.to(z.dtype)).clamp_min(0), mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        z, r, gamma, beta, var = ctx.saved_tensors
        # The ReLU mask from the two saved tensors: no pre-ReLU sum kept.
        ds = torch.where(z + r.to(z.dtype) > 0, dout, torch.zeros_like(dout))
        dx, dgamma, dbeta = _bn_bwd_core(z, gamma, beta, var, ds, ctx.eps)
        return dx, ds.to(r.dtype), dgamma, dbeta, None


def batch_norm(x, gamma, beta, eps: float = 1e-5):
    """Train-mode BatchNorm ``(x, gamma, beta) -> (z, mean, var)``;
    ``mean``/``var`` are the batch statistics, outside the gradient."""
    return _BatchNorm.apply(x, gamma, beta, eps)


def bn_relu(x, gamma, beta, eps: float = 1e-5):
    """``relu(batch_norm(x))`` saving only ``z``: returns (y, mean, var)."""
    return _BNRelu.apply(x, gamma, beta, eps)


def bn_add_relu(x, r, gamma, beta, eps: float = 1e-5):
    """Residual-block tail ``relu(bn(x) + r)`` saving ``z`` and the
    residual input ``r``, which the graph keeps anyway: returns
    (out, mean, var)."""
    return _BNAddRelu.apply(x, r, gamma, beta, eps)


class _NormBase(nn.Module):
    """Parameters, running statistics and their update, shared by the
    fused variants and the plain ``BatchNorm``.

    In training a forward updates the running statistics.  They go into
    ``new_stats[self.stats_key + ".mean" / ".var"]`` when the caller
    passes that dict (the train step's functional call: the buffers stay
    as they were) and into this module's buffers otherwise.  The owning
    model sets ``stats_key`` to the module's name."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, scale_init: float = 1.0,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.stats_key = ""
        kw = dict(dtype=F32, device=device)
        self.scale = nn.Parameter(torch.full((features,), scale_init, **kw))
        self.bias = nn.Parameter(torch.zeros(features, **kw))
        self.register_buffer("mean", torch.zeros(features, **kw))
        self.register_buffer("var", torch.ones(features, **kw))

    def _eval_scale_bias(self, x):
        """The running statistics folded into a per-channel affine."""
        rstd = torch.rsqrt(self.var + self.epsilon)
        scale = (self.scale * rstd).to(x.dtype)
        bias = (self.bias - self.mean * self.scale * rstd).to(x.dtype)
        return _channel(scale, x), _channel(bias, x)

    @torch.no_grad()
    def _update_stats(self, mean, var, new_stats: dict | None) -> None:
        m = self.momentum
        new_mean = m * self.mean + (1 - m) * mean
        new_var = m * self.var + (1 - m) * var
        if new_stats is None:
            self.mean.copy_(new_mean)
            self.var.copy_(new_var)
        else:
            prefix = f"{self.stats_key}." if self.stats_key else ""
            new_stats[prefix + "mean"] = new_mean
            new_stats[prefix + "var"] = new_var


class BatchNorm(_NormBase):
    """flax ``nn.BatchNorm`` (``use_fast_variance``): f32 statistics with
    the variance clipped at 0, ``(x - mean) * (rsqrt(var + eps) * scale)
    + bias`` in f32, cast back to the input's dtype; autograd
    differentiates it.  ``scale_init`` 0 gives the zero-init residual
    tail."""

    def forward(self, x, new_stats: dict | None = None):
        if self.training:
            xf = x.to(_stat_dtype(x))
            dims = _reduce_dims(x)
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
            self._update_stats(mean.detach(), var.detach(), new_stats)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x - _channel(mean, x)) * _channel(mul, x) + _channel(self.bias, x)
        return y.to(x.dtype)


class FusedBNRelu(_NormBase):
    """``BatchNorm -> relu`` through :func:`bn_relu`."""

    def forward(self, x, new_stats: dict | None = None):
        if not self.training:
            scale, bias = self._eval_scale_bias(x)
            return (x * scale + bias).clamp_min(0)
        y, mean, var = bn_relu(x, self.scale, self.bias, self.epsilon)
        self._update_stats(mean, var, new_stats)
        return y


class FusedBN(_NormBase):
    """A bare BatchNorm through :func:`batch_norm` (the downsample
    branch's, whose output the block tail keeps anyway)."""

    def forward(self, x, new_stats: dict | None = None):
        if not self.training:
            scale, bias = self._eval_scale_bias(x)
            return x * scale + bias
        z, mean, var = batch_norm(x, self.scale, self.bias, self.epsilon)
        self._update_stats(mean, var, new_stats)
        return z


class FusedBNAddRelu(_NormBase):
    """The block tail ``BatchNorm -> + residual -> relu`` through
    :func:`bn_add_relu`."""

    def forward(self, x, residual, new_stats: dict | None = None):
        if not self.training:
            scale, bias = self._eval_scale_bias(x)
            return (x * scale + bias + residual.to(x.dtype)).clamp_min(0)
        y, mean, var = bn_add_relu(x, residual, self.scale, self.bias,
                                   self.epsilon)
        self._update_stats(mean, var, new_stats)
        return y
