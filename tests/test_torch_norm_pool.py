"""The port's opt-in ``layer_norm`` / ``FusedLayerNorm``
(``ops/fused_norm.py``) and ``max_pool_3x3_s2`` (``ops/pooling.py``)
against the JAX package's, on the same seeded numpy inputs:

- ``layer_norm``: output, ``dx``, ``dscale``, ``dbias`` within 1e-5 in
  f32; in bf16 the output and ``dx`` within one bf16 rounding of JAX's
  bf16 result, ``dscale``/``dbias`` returned in bf16 as JAX returns them;
- ``FusedLayerNorm`` against the flax module (parameters, output dtype);
- ``max_pool_3x3_s2``: forward and backward on post-ReLU input, where
  many windows tie at 0 and every tied input takes the full gradient,
  within 1e-5 in f32 and equal to JAX's bf16 result in bf16; odd extents
  (the fallback) on tie-free input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops import fused_norm as jfn
from pytorch_distributed_training_tpu.ops import pooling as jpool
from pytorch_distributed_training_tpu_torch.ops import fused_norm as tfn
from pytorch_distributed_training_tpu_torch.ops import pooling as tpool

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _ln_inputs(seed=0, shape=(3, 7, 48)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, dy


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layer_norm_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x, scale, bias, dy = _ln_inputs()
    jargs = [jnp.asarray(a, jdt) for a in (x, scale, bias)]
    y_ref, vjp = jax.vjp(lambda a, b, c: jfn.layer_norm(a, b, c, 1e-6),
                         *jargs)
    grads_ref = vjp(jnp.asarray(dy, jdt))
    targs = [torch.tensor(a, dtype=tdt, requires_grad=True)
             for a in (x, scale, bias)]
    y = tfn.layer_norm(*targs, 1e-6)
    grads = torch.autograd.grad(y, targs, torch.tensor(dy, dtype=tdt))
    assert y.dtype == tdt
    assert [g.dtype for g in grads] == [tdt] * 3
    # bf16: one rounding of the same f32 value (2^-8 relative) either way.
    atol, rtol = (1e-5, 0) if dtype == "float32" else (1e-2, 2 ** -7)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref, np.float32),
                               atol=atol, rtol=rtol)
    for g, r, name in zip(grads, grads_ref, ("dx", "dscale", "dbias")):
        tol = atol if name == "dx" else atol * 10
        np.testing.assert_allclose(_np(g), np.asarray(r, np.float32),
                                   atol=tol, rtol=rtol, err_msg=name)


def test_layer_norm_matches_plain_layer_norm():
    x, scale, bias, dy = _ln_inputs(1)
    targs = [torch.tensor(a, requires_grad=True) for a in (x, scale, bias)]
    y = tfn.layer_norm(*targs, 1e-6)
    g = torch.autograd.grad(y, targs, torch.tensor(dy))
    plain = torch.nn.functional.layer_norm(targs[0], (48,), targs[1],
                                           targs[2], 1e-6)
    gp = torch.autograd.grad(plain, targs, torch.tensor(dy))
    torch.testing.assert_close(y, plain, atol=1e-5, rtol=0)
    for a, b in zip(g, gp):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_fused_layer_norm_module_matches_flax(out_dtype):
    x, _, _, _ = _ln_inputs(2)
    jdt, tdt = DTYPES[out_dtype] if out_dtype else (None, None)
    jm = jfn.FusedLayerNorm(dtype=jdt)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(variables, jnp.asarray(x))
    m = tfn.FusedLayerNorm(48, dtype=tdt)
    assert {k: tuple(v.shape) for k, v in m.named_parameters()} == {
        k: v.shape for k, v in variables["params"].items()}
    assert m.scale.dtype == torch.float32
    got = m(torch.from_numpy(x))
    assert got.dtype == (tdt or torch.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=1e-5 if tdt is None else 1e-2,
                               rtol=0 if tdt is None else 2 ** -7)


def _pool_inputs(seed, shape, ties: bool):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if ties:
        x = np.maximum(x - 0.5, 0.0)          # post-ReLU: tied zeros
    n, h, w, c = shape
    dy = rng.standard_normal((n, (h + 1) // 2, (w + 1) // 2, c)).astype(
        np.float32)
    return x, dy


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,ties", [((2, 16, 16, 8), True),
                                        ((2, 12, 8, 4), True),
                                        ((2, 15, 9, 4), False)])
def test_max_pool_matches_jax(shape, ties, dtype):
    jdt, tdt = DTYPES[dtype]
    x, dy = _pool_inputs(3, shape, ties)
    y_ref, vjp = jax.vjp(jpool.max_pool_3x3_s2, jnp.asarray(x, jdt))
    (dx_ref,) = vjp(jnp.asarray(dy, jdt))
    xt = torch.tensor(x, dtype=tdt).permute(0, 3, 1, 2).requires_grad_()
    y = tpool.max_pool_3x3_s2(xt)
    (dx,) = torch.autograd.grad(y, xt, torch.tensor(dy, dtype=tdt).permute(
        0, 3, 1, 2))
    y, dx = y.permute(0, 2, 3, 1), dx.permute(0, 2, 3, 1)
    np.testing.assert_array_equal(_np(y), np.asarray(y_ref, np.float32))
    tol = 1e-5 if dtype == "float32" else 0.0
    np.testing.assert_allclose(_np(dx), np.asarray(dx_ref, np.float32),
                               atol=tol, rtol=0)
    if ties:
        # A tied window hands each of its maxima the full gradient: more
        # gradient in total than the one-position library pool's.
        windows = int((x[:, ::2, ::2] == 0).sum())
        assert windows > 0
        plain = xt.detach().requires_grad_()
        (dx_lib,) = torch.autograd.grad(
            torch.nn.functional.max_pool2d(plain, 3, 2, 1), plain,
            torch.ones_like(y.permute(0, 3, 1, 2)))
        (dx_all,) = torch.autograd.grad(
            tpool.max_pool_3x3_s2(plain), plain,
            torch.ones_like(y.permute(0, 3, 1, 2)))
        assert float(dx_all.float().sum()) > float(dx_lib.float().sum())
