"""The port's flash attention (plain versions, on the CPU) against the JAX
package's Pallas kernels in interpret mode, in each TPU tiling.

The same inputs (numpy, seeded) go through both; out, the row LSE and the
gradients of ``sum(out**2)`` must agree: f32 atol 2e-5 for out and LSE
and 2e-4 for gradients (the JAX tests' own, ``tests/test_ops.py``), bf16
2e-2.  The tilings and the calls that reach them:

- #2/#3 heads-fused single tile: public ``flash_attention`` at L 128-256;
- #4/#5 grouped heads: L 640, H 2, f32 (config (2, 128, 128));
- #6/#8 transposed multi-tile: ``flash_attention(block_q=block_k=128)``
  at L 256;
- #1/#7 transposed single tile: ``pallas_attention._flash`` at L 128.

Also: causal cross-length, the padded non-causal L 197, the routing of
``chip_smoke.py``'s shapes A-D, the dispatch rule, and the bf16 softmax
backward of the plain path.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops import attention as jattn
from pytorch_distributed_training_tpu.ops import pallas_attention as pa
from pytorch_distributed_training_tpu_torch.ops import attention as tattn
from pytorch_distributed_training_tpu_torch.ops import flash_attention as fa

D = 64
TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 2e-2)}


def _inputs(b, lq, lk, h, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, h, D)).astype(np.float32)
               for n in (lq, lk, lk))
    return q, k, v


def _jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype).requires_grad_()


def _port(q, k, v, causal, tdtype):
    tq, tk, tv = (_torch(x, tdtype) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad((out.float() ** 2).sum(), (tq, tk, tv))
    _, lse = fa.flash_fwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                causal, D ** -0.5)
    return out, lse, grads


def _close(got, ref, atol, what):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float32),
        np.asarray(jnp.asarray(ref).astype(jnp.float32)),
        atol=atol, rtol=atol, err_msg=what)


def _check(fn_out, fn_lse, q, k, v, causal, dtype="float32"):
    """``fn_out(q, k, v)`` → JAX out (B, L, H, D); ``fn_lse`` → JAX LSE
    as (B, H, L), or None where the route does not expose it."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    atol, gtol = TOL[dtype]
    jq, jk, jv = (_jax(x, jd) for x in (q, k, v))
    ref = fn_out(jq, jk, jv)
    ref_grads = jax.grad(
        lambda a, b, c: jnp.sum(fn_out(a, b, c).astype(jnp.float32) ** 2),
        argnums=(0, 1, 2))(jq, jk, jv)
    out, lse, grads = _port(q, k, v, causal, td)
    _close(out, ref, atol, "out")
    if fn_lse is not None:
        _close(lse, fn_lse(jq, jk, jv), atol, "lse")
    for name, g, r in zip("qkv", grads, ref_grads):
        _close(g, r, gtol, f"d{name}")


def _nlhd(x):
    return x.reshape(x.shape[0], x.shape[1], -1)


@pytest.mark.parametrize("length", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_heads_fused_single_tile_2_3(length, causal):
    q, k, v = _inputs(2, length, length, 3)
    h = q.shape[2]
    assert length <= 512 and pa._nlhd_single_fits(length, length, h * D, 4)

    def lse(a, b, c):
        _, l = pa._flash_fwd_single_nlhd(
            _nlhd(a), _nlhd(b), _nlhd(c), causal, D ** -0.5, length, True,
            0, None, h)
        return jnp.swapaxes(l, 1, 2)

    _check(lambda a, b, c: pa.flash_attention(a, b, c, causal=causal,
                                              interpret=True),
           lse, q, k, v, causal)


def test_heads_fused_single_tile_bf16():
    q, k, v = _inputs(2, 256, 256, 2, seed=4)
    _check(lambda a, b, c: pa.flash_attention(a, b, c, causal=True,
                                              interpret=True),
           None, q, k, v, True, dtype="bfloat16")


def test_grouped_heads_4_5():
    q, k, v = _inputs(1, 640, 640, 2, seed=1)
    cfg = pa._nlhd_group_config(640, 640, 2, D, 4)
    assert cfg == (2, 128, 128)

    def lse(a, b, c):
        _, l = pa._flash_fwd_grouped(
            _nlhd(a), _nlhd(b), _nlhd(c), True, D ** -0.5, True, 0, None, 2,
            cfg)
        return jnp.transpose(l[:, 0], (0, 2, 1))   # (B, 1, L, Hg) → (B, H, L)

    _check(lambda a, b, c: pa.flash_attention(a, b, c, causal=True,
                                              interpret=True),
           lse, q, k, v, True)


def test_transposed_multi_tile_6_8():
    q, k, v = _inputs(1, 256, 256, 2, seed=2)

    def lse(a, b, c):
        _, l = pa._flash_fwd(*(jnp.swapaxes(x, 1, 2) for x in (a, b, c)),
                             True, D ** -0.5, 128, 128, True)
        return l

    _check(lambda a, b, c: pa.flash_attention(
        a, b, c, causal=True, block_q=128, block_k=128, interpret=True),
        lse, q, k, v, True)


def test_transposed_single_tile_1_7():
    q, k, v = _inputs(2, 128, 128, 2, seed=3)

    def out(a, b, c):
        o = pa._flash(*(jnp.swapaxes(x, 1, 2) for x in (a, b, c)), True,
                      D ** -0.5, 128, 128, True, None, None)
        return jnp.swapaxes(o, 1, 2)

    def lse(a, b, c):
        _, l = pa._flash_fwd(*(jnp.swapaxes(x, 1, 2) for x in (a, b, c)),
                             True, D ** -0.5, 128, 128, True)
        return l

    _check(out, lse, q, k, v, True)


def test_causal_cross_length():
    q, k, v = _inputs(1, 128, 256, 2, seed=5)
    _check(lambda a, b, c: pa.flash_attention(a, b, c, causal=True,
                                              interpret=True),
           None, q, k, v, True)


@pytest.mark.parametrize("q_len,k_len", [(256, 128), (200, 72)])
def test_causal_rows_without_live_keys(q_len, k_len):
    """Causal q_len > k_len: the first q_len - k_len rows see no key.  The
    plain versions give out 0, lse -1e30 and finite gradients there, and
    agree with the Pallas path (whose l == 0 guard covers those rows)."""
    q, k, v = _inputs(1, q_len, k_len, 2, seed=9)
    _check(lambda a, b, c: pa.flash_attention(a, b, c, causal=True,
                                              interpret=True),
           None, q, k, v, True)
    out, lse, grads = _port(q, k, v, True, torch.float32)
    dead = q_len - k_len
    assert torch.equal(out[:, :dead].detach(), torch.zeros_like(out[:, :dead]))
    assert bool((lse[:, :, :dead] == fa._NEG_INF).all())
    assert bool(torch.isfinite(lse[:, :, dead:]).all())
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert torch.equal(grads[0][:, :dead], torch.zeros_like(grads[0][:, :dead]))


def test_padded_non_causal_197():
    q, k, v = _inputs(2, 197, 197, 2, seed=6)
    _check(lambda a, b, c: pa.flash_attention(a, b, c, causal=False,
                                              interpret=True),
           None, q, k, v, False)


def _chip_smoke_shapes() -> dict:
    """``FLASH_SHAPES`` of chip_smoke.py, read without importing it."""
    src = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    for node in ast.parse(src.read_text()).body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "FLASH_SHAPES":
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py defines no FLASH_SHAPES")


def _route(length: int, heads: int) -> tuple[int, int]:
    """The rows ``pa.flash_attention`` takes for a bf16 causal self-attention
    of this length (a multiple of 128) at its default 1024 blocks: the
    dispatch of lines 1136-1179 with its own fit helpers."""
    if length <= 512 and pa._nlhd_single_fits(length, length, heads * D, 2):
        return 2, 3
    if length <= 1024 and pa._nlhd_group_config(length, length, heads, D, 2):
        return 4, 5
    return (1, 7) if length <= 1024 else (6, 8)


def test_chip_smoke_shapes_route_to_their_rows():
    shapes = _chip_smoke_shapes()
    assert set(shapes) == {"A", "B", "C", "D"}
    for name, s in shapes.items():
        assert _route(s["seq"], s["heads"]) == (s["fwd"], s["bwd"]), name
    b = shapes["B"]
    assert pa._nlhd_group_config(b["seq"], b["seq"], b["heads"], D, 2) \
        == (6, 512, 256)


def test_dispatch_rule(monkeypatch):
    monkeypatch.delenv("PDT_FORCE_ATTN", raising=False)
    assert tattn.flash_preferred(256, 256, 64, device="cuda")
    assert not tattn.flash_preferred(255, 256, 64, device="cuda")
    assert not tattn.flash_preferred(1024, 1024, 32, device="cuda")
    assert not tattn.flash_preferred(1024, 1024, 64, device="cpu")
    q = torch.zeros(1, 256, 2, D)
    calls = []
    monkeypatch.setattr(fa, "flash_fwd_plain",
                        lambda *a: calls.append("flash") or (
                            torch.zeros(1, 256, 2, D), torch.zeros(1, 2, 256)))
    tattn.dot_product_attention(q, q, q, causal=True)
    assert calls == []          # host tensors: the plain XLA counterpart
    monkeypatch.setenv("PDT_FORCE_ATTN", "flash")
    tattn.dot_product_attention(q, q, q, causal=True)
    assert calls == ["flash"]
    monkeypatch.setenv("PDT_FORCE_ATTN", "flsh")
    with pytest.raises(ValueError, match="PDT_FORCE_ATTN"):
        tattn.dot_product_attention(q, q, q, causal=True)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_bf16_matches_jax(causal):
    """The plain path in bf16, forward and grads: the softmax saves bf16
    probabilities and evaluates its backward in f32 (``_softmax_lowp``)."""
    q, k, v = _inputs(2, 64, 64, 2, seed=7)
    jq, jk, jv = (_jax(x, jnp.bfloat16) for x in (q, k, v))

    def jf(a, b, c):
        return jnp.sum(jattn._xla_attention(a, b, c, causal=causal)
                       .astype(jnp.float32) ** 2)

    ref_out = jattn._xla_attention(jq, jk, jv, causal=causal)
    ref_grads = jax.grad(jf, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (_torch(x, torch.bfloat16) for x in (q, k, v))
    out = tattn._xla_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad((out.float() ** 2).sum(), (tq, tk, tv))
    _close(out, ref_out, 2e-2, "out")
    for name, g, r in zip("qkv", grads, ref_grads):
        _close(g, r, 2e-2, f"d{name}")


def test_softmax_lowp_backward_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32) * 3
    dw = rng.standard_normal((3, 5, 40)).astype(np.float32)
    w_ref, vjp = jax.vjp(jattn._softmax_lowp, _jax(logits, jnp.bfloat16))
    (dl_ref,) = vjp(_jax(dw, jnp.bfloat16))
    tl = _torch(logits, torch.bfloat16)
    w = tattn.SoftmaxLowp.apply(tl)
    (dl,) = torch.autograd.grad(w, tl, torch.from_numpy(dw).bfloat16())
    assert w.dtype == dl.dtype == torch.bfloat16
    _close(w, w_ref, 2e-2, "w")
    _close(dl, dl_ref, 2e-2, "dl")
