"""Output-saving BatchNorm and a low-memory LayerNorm: the counterparts
of the JAX package's ``ops/fused_norm.py``.

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
The fused functions take ``gamma``/``beta`` as the f32 masters and round
them to the input's dtype themselves, so under the bf16 policy the
forward is JAX's and ``dgamma``/``dbeta`` reach the master as f32 sums,
as JAX's ``custom_vjp`` hands them on.

Sync-BN: given a ``torch.distributed`` process group, every function and
module takes its statistics over all ranks' batches (the JAX model's
statistics are over the global batch, XLA inserting the reductions):
one all-reduce of the stacked ``[sum x, sum x^2, n]`` in the forward
and, in the fused backward, one of ``[sum dz, sum dz * xhat]``.

The modules keep flax's layout: parameters ``scale``/``bias`` and the
running ``mean``/``var`` buffers, all f32.  In training they update the
running statistics as ``m * old + (1 - m) * batch`` with ``m = 0.9`` and
the biased batch variance (``torch.nn.BatchNorm2d`` stores the unbiased
one).  ``BatchNorm`` is the plain composition's norm, flax
``nn.BatchNorm``'s math, differentiated by autograd: the reference the
fused functions are held against, and the model's norm when
``tpu_fused=False`` or ``zero_init_residual=True``.

``layer_norm`` / ``FusedLayerNorm`` (JAX lines 276-349) are opt-in and
used by no stock model: a LayerNorm over the last axis whose backward
saves the input, the mean and the rstd and rebuilds ``xhat``, so no
higher-precision (B, L, D) tensor is kept for the gradient.
"""

from __future__ import annotations

import torch
from torch import nn

from ..comm import collectives

F32 = torch.float32


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, F32)


def _reduce_dims(x: torch.Tensor) -> list[int]:
    return [0, *range(2, x.ndim)]


def _channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over ``x``'s channel dim 1."""
    return v.view(1, -1, *([1] * (x.ndim - 2)))


def _affine(gamma, beta, x):
    """``gamma``/``beta`` rounded to ``x``'s dtype, then held in the
    statistics dtype.  The train step hands the fused functions the f32
    master parameters; rounding here gives the values the JAX model
    computes with (its step casts them to the compute dtype), while the
    gradients leave as the f32 sums JAX's ``custom_vjp`` returns."""
    stat = _stat_dtype(x)
    return gamma.to(x.dtype).to(stat), beta.to(x.dtype).to(stat)


def _batch_stats(x, group, differentiable: bool = False):
    """(mean, var, n) of ``x`` per channel in the statistics dtype, over
    every rank of ``group`` when one is given: the local ``[sum x, sum
    x^2, n]`` stacked and summed over the group, then the same biased
    ``E[x^2] - E[x]^2``.  ``n`` is the (global) count.  ``differentiable``
    sums through ``all_reduce_sum``, whose backward sums the statistics'
    cotangents over the ranks too (autograd's BatchNorm)."""
    xf = x.to(_stat_dtype(x))
    dims = _reduce_dims(x)
    if group is None:
        mean = xf.mean(dims)
        var = (xf * xf).mean(dims) - mean * mean
        return mean, var, xf.numel() // x.shape[1]
    c = x.shape[1]
    sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                      xf.new_full((1,), xf.numel() // c)])
    sums = (collectives.all_reduce_sum(sums, group) if differentiable
            else collectives.psum(sums, group))
    n = sums[2 * c]
    mean = sums[:c] / n
    return mean, sums[c:2 * c] / n - mean * mean, n


def _bn_core(x, gamma, beta, eps, group=None):
    """Forward math of the three functions: returns (z, mean, var, n)."""
    gamma, beta = _affine(gamma, beta, x)
    mean, var, n = _batch_stats(x, group)
    rstd = torch.rsqrt(var + eps)
    scale = (gamma * rstd).to(x.dtype)
    bias = (beta - mean * gamma * rstd).to(x.dtype)
    return x * _channel(scale, x) + _channel(bias, x), mean, var, n


def _bn_bwd_core(z, gamma, beta, var, n, dz, eps, group=None):
    """The BN gradient with ``xhat`` rebuilt from the output ``z``:
    returns (dx, dgamma, dbeta).  A |gamma| below 1e-12 is replaced by
    1e-12 with gamma's sign, so a transiently tiny gamma still
    reconstructs without overflow and without flipping xhat's sign.

    With a ``group`` the two sums that ``dx`` needs are summed over it
    (one all-reduce) and ``n`` is the global count; ``dgamma``/``dbeta``
    stay this rank's own sums.  Each rank differentiates its local loss,
    so its cotangents are world-size times the global loss's: ``dx`` is
    consistent under that scale, and the local sums give the true
    ``dgamma``/``dbeta`` once the step averages gradients over ranks
    (summed ones would come out world-size times too large)."""
    stat = _stat_dtype(z)
    rstd = torch.rsqrt(var + eps)
    g, b = _affine(gamma, beta, z)
    tiny = torch.full_like(g, 1e-12)
    safe_g = torch.where(g.abs() < tiny, torch.copysign(tiny, g), g)
    xhat = z.to(stat) / _channel(safe_g, z) - _channel(b / safe_g, z)
    dims = _reduce_dims(z)
    dzf = dz.to(stat)
    sum_dz = dzf.sum(dims)
    sum_dz_xhat = (dzf * xhat).sum(dims)
    mean_dz, mean_dz_xhat = sum_dz / n, sum_dz_xhat / n
    if group is not None:
        c = z.shape[1]
        sums = collectives.psum(torch.cat([sum_dz, sum_dz_xhat]), group)
        mean_dz, mean_dz_xhat = sums[:c] / n, sums[c:] / n
    dx = _channel(g * rstd, z) * (dzf - _channel(mean_dz, z)
                                  - xhat * _channel(mean_dz_xhat, z))
    return dx.to(z.dtype), sum_dz_xhat, sum_dz


def _relu_grad(z, dy):
    """d max(z, 0) / dz as JAX's ``jnp.maximum`` gives it: 1 above 0, a
    half at a tie, 0 below."""
    return torch.where(z > 0, dy,
                       torch.where(z == 0, dy * 0.5, torch.zeros_like(dy)))


def _save(ctx, saved, var, n, eps, group) -> None:
    """What the three functions keep for the backward: ``z`` (and ``r``),
    gamma, beta and the statistics."""
    ctx.save_for_backward(*saved, var)
    ctx.n, ctx.eps, ctx.group = n, eps, group


def _grads(ctx, z, gamma, beta, var, dz):
    return _bn_bwd_core(z, gamma, beta, var, ctx.n, dz, ctx.eps, ctx.group)


class _BatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, group):
        z, mean, var, n = _bn_core(x, gamma, beta, eps, group)
        _save(ctx, (z, gamma, beta), var, n, eps, group)
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        z, gamma, beta, var = ctx.saved_tensors
        return (*_grads(ctx, z, gamma, beta, var, dz), None, None)


class _BNRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, group):
        z, mean, var, n = _bn_core(x, gamma, beta, eps, group)
        _save(ctx, (z, gamma, beta), var, n, eps, group)
        ctx.mark_non_differentiable(mean, var)
        return z.clamp_min(0), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        z, gamma, beta, var = ctx.saved_tensors
        dz = _relu_grad(z, dy)
        return (*_grads(ctx, z, gamma, beta, var, dz), None, None)


class _BNAddRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, gamma, beta, eps, group):
        z, mean, var, n = _bn_core(x, gamma, beta, eps, group)
        _save(ctx, (z, r, gamma, beta), var, n, eps, group)
        ctx.mark_non_differentiable(mean, var)
        return (z + r.to(z.dtype)).clamp_min(0), mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        z, r, gamma, beta, var = ctx.saved_tensors
        # The ReLU mask from the two saved tensors: no pre-ReLU sum kept.
        ds = torch.where(z + r.to(z.dtype) > 0, dout, torch.zeros_like(dout))
        dx, dgamma, dbeta = _grads(ctx, z, gamma, beta, var, ds)
        return dx, ds.to(r.dtype), dgamma, dbeta, None, None


def batch_norm(x, gamma, beta, eps: float = 1e-5, group=None):
    """Train-mode BatchNorm ``(x, gamma, beta) -> (z, mean, var)``;
    ``mean``/``var`` are the batch statistics, outside the gradient.
    With a process ``group`` they are taken over every rank's batch
    (sync-BN)."""
    return _BatchNorm.apply(x, gamma, beta, eps, group)


def bn_relu(x, gamma, beta, eps: float = 1e-5, group=None):
    """``relu(batch_norm(x))`` saving only ``z``: returns (y, mean, var)."""
    return _BNRelu.apply(x, gamma, beta, eps, group)


def bn_add_relu(x, r, gamma, beta, eps: float = 1e-5, group=None):
    """Residual-block tail ``relu(bn(x) + r)`` saving ``z`` and the
    residual input ``r``, which the graph keeps anyway: returns
    (out, mean, var)."""
    return _BNAddRelu.apply(x, r, gamma, beta, eps, group)


class _NormBase(nn.Module):
    """Parameters, running statistics and their update, shared by the
    fused variants and the plain ``BatchNorm``.

    In training a forward updates the running statistics.  They go into
    ``new_stats[self.stats_key + ".mean" / ".var"]`` when the caller
    passes that dict (the train step's functional call: the buffers stay
    as they were) and into this module's buffers otherwise.  The owning
    model sets ``stats_key`` to the module's name.  A ``group`` (a
    ``torch.distributed`` process group) takes the statistics over every
    rank's batch.

    ``master_affine``: the module computes with ``scale``/``bias`` as
    given in f32 and rounds them itself, so the train step hands it the
    master parameters uncast (see ``master_affine_params``)."""

    master_affine = False

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
        gamma, beta = _affine(self.scale, self.bias, x)
        rstd = torch.rsqrt(self.var + self.epsilon)
        scale = (gamma * rstd).to(x.dtype)
        bias = (beta - self.mean * gamma * rstd).to(x.dtype)
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

    def forward(self, x, new_stats: dict | None = None, group=None):
        if self.training:
            mean, var, _ = _batch_stats(x, group, differentiable=True)
            var = var.clamp_min(0.0)
            self._update_stats(mean.detach(), var.detach(), new_stats)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x - _channel(mean, x)) * _channel(mul, x) + _channel(self.bias, x)
        return y.to(x.dtype)


class FusedBNRelu(_NormBase):
    """``BatchNorm -> relu`` through :func:`bn_relu`."""

    master_affine = True

    def forward(self, x, new_stats: dict | None = None, group=None):
        if not self.training:
            scale, bias = self._eval_scale_bias(x)
            return (x * scale + bias).clamp_min(0)
        y, mean, var = bn_relu(x, self.scale, self.bias, self.epsilon, group)
        self._update_stats(mean, var, new_stats)
        return y


class FusedBN(_NormBase):
    """A bare BatchNorm through :func:`batch_norm` (the downsample
    branch's, whose output the block tail keeps anyway)."""

    master_affine = True

    def forward(self, x, new_stats: dict | None = None, group=None):
        if not self.training:
            scale, bias = self._eval_scale_bias(x)
            return x * scale + bias
        z, mean, var = batch_norm(x, self.scale, self.bias, self.epsilon,
                                  group)
        self._update_stats(mean, var, new_stats)
        return z


class FusedBNAddRelu(_NormBase):
    """The block tail ``BatchNorm -> + residual -> relu`` through
    :func:`bn_add_relu`."""

    master_affine = True

    def forward(self, x, residual, new_stats: dict | None = None,
                group=None):
        if not self.training:
            scale, bias = self._eval_scale_bias(x)
            return (x * scale + bias + residual.to(x.dtype)).clamp_min(0)
        y, mean, var = bn_add_relu(x, residual, self.scale, self.bias,
                                   self.epsilon, group)
        self._update_stats(mean, var, new_stats)
        return y


def master_affine_params(model: nn.Module) -> set[str]:
    """Names of the parameters the train step keeps out of the policy's
    cast: the fused norms' ``scale``/``bias``, which JAX's ``custom_vjp``
    differentiates into f32 sums that reach the f32 master unrounded."""
    return {f"{name}.{p}" if name else p
            for name, m in model.named_modules()
            if getattr(m, "master_affine", False) for p in ("scale", "bias")}


class _LayerNorm(torch.autograd.Function):
    """JAX ``layer_norm``'s ``custom_vjp``: statistics in the promoted
    dtype (f32 for f32/bf16 input) with the two-pass variance, output in
    ``x``'s dtype; the backward is the standard LN gradient in the same
    dtype, ``dscale``/``dbias`` returned in the scale's and bias's dtype
    (``.astype(scale.dtype)``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = _ln_core(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        sd = _stat_dtype(x)
        xhat = (x.to(sd) - mean) * rstd
        dyf = dy.to(sd)
        dxhat = dyf * scale.to(sd)
        m1 = dxhat.mean(-1, keepdim=True)
        m2 = (dxhat * xhat).mean(-1, keepdim=True)
        dx = (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
        dims = tuple(range(dy.ndim - 1))
        dscale = (dyf * xhat).sum(dims).to(scale.dtype)
        dbias = dyf.sum(dims).to(ctx.bias_dtype)
        return dx, dscale, dbias, None


def _ln_core(x, scale, bias, eps):
    sd = _stat_dtype(x)
    xf = x.to(sd)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * scale.to(sd) + bias.to(sd)
    return y.to(x.dtype), mean, rstd


def layer_norm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm over the last axis with the low-memory backward.  Under
    the bf16 policy ``scale``/``bias`` arrive as bf16 copies, so their
    gradients come back rounded to bf16, as in JAX (unlike the fused
    BatchNorms', whose f32 masters get f32 sums)."""
    return _LayerNorm.apply(x, scale, bias, eps)


class FusedLayerNorm(nn.Module):
    """flax ``nn.LayerNorm``'s parameters (``scale`` 1, ``bias`` 0, f32)
    with ``layer_norm``'s backward; the output is cast to ``dtype`` when
    one is given."""

    def __init__(self, features: int, epsilon: float = 1e-6, dtype=None,
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, dtype=F32,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=F32,
                                             device=device))

    def forward(self, x):
        y = layer_norm(x, self.scale, self.bias, self.epsilon)
        return y.to(self.dtype) if self.dtype is not None else y
