"""Flash attention, forward and backward: the CUDA kernels of
``csrc/flash_attention.cu`` and their plain PyTorch versions.

Counterpart of the flash section of the JAX package's
``ops/pallas_attention.py`` (lines 41-1179).  There, four TPU tilings of
one forward (#1 ``_flash_fwd_single``, #2 ``_flash_fwd_single_nlhd``, #4
``_flash_fwd_grouped``, #6 ``_flash_fwd``) and four of one backward (#3
``_flash_bwd_nlhd``, #5 ``_flash_bwd_grouped``, #7 ``_flash_bwd_single``,
#8 ``_flash_bwd``) are chosen by VMEM budget and length.  A Hopper block
has no such budget, so three kernels cover all eight: the forward, a dq
pass over key tiles and a dk/dv pass over query tiles (#8's split).

- ``flash_attention(q, k, v, *, causal, scale)``: (B, L, H, D) in and out,
  any lengths, ``q_len != k_len`` included; the causal mask is
  bottom-right aligned (key j is visible to query i iff
  ``j <= i + k_len - q_len``).  The kernels mask out-of-range keys
  themselves, so nothing is padded to a tile (the JAX wrapper's pad to
  128 with ``kv_len`` masking computes the same function).
- ``FlashAttention``: the ``torch.autograd.Function`` in the role of the
  ``custom_vjp`` wrappers ``_flash``, ``_flash_nlhd`` and
  ``_flash_nlhd_grouped``.  It saves q, k, v, out and the f32 row LSE,
  never p; the backward computes ``delta = rowsum(dO * O)`` in f32 and
  runs the dq and the dk/dv passes.
- ``flash_fwd`` / ``flash_bwd_dq`` / ``flash_bwd_dkv``: the three kernel
  entries, each with a ``.launches`` count.  CPU tensors take the plain
  version and count nothing; CUDA tensors launch the kernel or raise.
  ``meta`` tensors (the flop probe of ``obs/cost.py``) launch nothing:
  they return outputs of the right shape and add the kernel's
  floating-point operations to :data:`meta_flops` — 2 x the visible
  (query, key) pairs x head_dim for each of its products: the forward's
  two (scores, p·v), the dq pass's three (scores, dp, dq) and the dk/dv
  pass's four (scores, dp, dv, dk).
- ``flash_fwd_plain`` / ``flash_bwd_plain``: the plain versions, with the
  one-tile math of #4 (``_fwd_tile``) and ``_bwd_block``: f32 scores,
  masked entries an explicit 0, p normalised before its rounding to v's
  dtype, ds and p rounded to the input dtype before their products, f32
  accumulation, one rounding of each result.

Only head_dim 64 is built (every model the repo defines at its published
widths has it); the wrapper raises for any other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_NEG_INF = -1e30
HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _live_mask(q_len: int, k_len: int, causal: bool, device) -> torch.Tensor | None:
    """(q_len, k_len) bool: key j visible to query i, or None if all are."""
    if not causal:
        return None
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(k_len, device=device)[None, :]
    return j <= i + (k_len - q_len)


def _scores(q, k, scale):
    """(B, H, Lq, Lk) f32 scores from (B, L, H, D) q and k."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def flash_fwd_plain(q, k, v, causal: bool, scale: float):
    """Plain forward: ``(out (B, Lq, H, D) in q's dtype, lse (B, H, Lq)
    f32)``, the one-tile math of ``_fwd_tile``."""
    mask = _live_mask(q.shape[1], k.shape[1], causal, q.device)
    s = _scores(q, k, scale)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    p = (p / l_safe).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)
    return out, (m + torch.log(l_safe))[..., 0]


def _bwd_tiles(q, k, v, do, lse, delta, causal, scale):
    """``_bwd_block`` over the whole (Lq, Lk) tile: (p, ds), both f32."""
    mask = _live_mask(q.shape[1], k.shape[1], causal, q.device)
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    if mask is not None:
        # Explicit zero: a row with no live key has lse = -1e30, and
        # exp(s - lse) there is not 0.
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def _dq_plain(q, k, ds):
    return torch.einsum(
        "bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float()
    ).to(q.dtype)


def _dkv_plain(q, k, v, do, p, ds):
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Plain backward: ``(dq, dk, dv)`` in the inputs' dtypes.  ``lse`` and
    ``delta`` are (B, H, Lq) f32."""
    p, ds = _bwd_tiles(q, k, v, do, lse, delta, causal, scale)
    return (_dq_plain(q, k, ds),) + _dkv_plain(q, k, v, do, p, ds)


def _check(named: dict, rows: dict) -> None:
    """What the CUDA kernels take; anything else raises.  ``named``: the
    (B, L, H, D) operands; ``rows``: the (B, H, Lq) f32 LSE/delta."""
    ts = list(named.values()) + list(rows.values())
    if not all(t.is_cuda for t in ts):
        raise ValueError("the flash-attention kernels take CUDA tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError("flash-attention operands lie on different devices")
    q = named["q"]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    b, q_len, h, d = q.shape
    k_len = named["k"].shape[1]
    if d != HEAD_DIM:
        raise ValueError(
            f"head_dim {d}: the flash-attention kernels are built for "
            f"head_dim {HEAD_DIM} only"
        )
    for name, t in named.items():
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        length = q_len if name in ("q", "do", "out", "dq") else k_len
        if t.dim() != 4 or tuple(t.shape) != (b, length, h, d):
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected "
                f"{(b, length, h, d)}"
            )
        # 16-byte vector loads: a contiguous last dim, row strides in whole
        # 16-byte units, a 16-byte-aligned base.
        unit = 16 // t.element_size()
        if t.stride(-1) != 1 or any(s % unit for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} needs a contiguous last dim, row strides in 16-byte "
                f"units and a 16-byte-aligned base (strides {t.stride()})"
            )
    for name, t in rows.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, q_len) \
                or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous (B, H, Lq) = {(b, h, q_len)} "
                f"float32 tensor, got {tuple(t.shape)} {t.dtype}"
            )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("flash_attention.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i] * 6 + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), p]
    lib.pdt_flash_fwd.argtypes = [i] + [p] * 5 + tail
    lib.pdt_flash_bwd_dq.argtypes = [i] + [p] * 7 + tail
    lib.pdt_flash_bwd_dkv.argtypes = [i] + [p] * 8 + tail
    for fn in (lib.pdt_flash_fwd, lib.pdt_flash_bwd_dq, lib.pdt_flash_bwd_dkv):
        fn.restype = i
    lib.pdt_flash_error_string.argtypes = [i]
    lib.pdt_flash_error_string.restype = ctypes.c_char_p
    return lib


def _launch(fn_name: str, tensors: list, q, k, causal, scale) -> None:
    """Call one C entry with the shape arguments and the (b, l, h) strides
    of the (B, L, H, D) operands in ``tensors``; raise on a CUDA error."""
    lib = _library()
    strides = [s for t in tensors if t.dim() == 4 for s in t.stride()[:3]]
    arr = (ctypes.c_longlong * len(strides))(*strides)
    b, q_len, h, d = q.shape
    rc = getattr(lib, fn_name)(
        _DTYPE_CODES[q.dtype], *(t.data_ptr() for t in tensors),
        b, h, q_len, k.shape[1], d, int(bool(causal)), float(scale), arr,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        msg = lib.pdt_flash_error_string(rc).decode()
        raise RuntimeError(f"flash-attention kernel {fn_name} failed: {msg} ({rc})")


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


# FLOPs of the kernel calls made on ``meta`` tensors (module docstring);
# the flop probe zeroes it before counting and reads it after.
meta_flops = 0


def _visible_pairs(q_len: int, k_len: int, causal: bool) -> int:
    """(query, key) pairs the mask leaves visible: all, or under the
    bottom-right aligned causal mask those with j <= i + k_len - q_len."""
    if not causal:
        return q_len * k_len
    rows = torch.arange(q_len) + 1 + (k_len - q_len)
    return int(rows.clamp(0, k_len).sum())


def _count_meta(products: int, q, k, causal: bool) -> None:
    global meta_flops
    b, q_len, h, d = q.shape
    meta_flops += products * 2 * b * h * d * _visible_pairs(
        q_len, k.shape[1], causal)


def flash_fwd(q, k, v, *, causal: bool = False, scale=None):
    """Forward kernel: ``(out, lse)``, out (B, Lq, H, D) in q's dtype, lse
    (B, H, Lq) f32.  CPU tensors take ``flash_fwd_plain``."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    b, q_len, h, d = q.shape
    out = torch.empty((b, q_len, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, q_len), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        _count_meta(2, q, k, causal)
        return out, lse
    _check(dict(q=q, k=k, v=v), {})
    # Operand order of pdt_flash_fwd: q, k, v, out, lse.
    _launch("pdt_flash_fwd", [q, k, v, out, lse], q, k, causal, scale)
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                 scale=None):
    """dq pass over the key tiles: dq (B, Lq, H, D) in q's dtype."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        _, ds = _bwd_tiles(q, k, v, do, lse, delta, causal, scale)
        return _dq_plain(q, k, ds)
    if q.device.type == "meta":
        _count_meta(3, q, k, causal)
        return torch.empty_like(q, memory_format=torch.contiguous_format)
    _check(dict(q=q, k=k, v=v, do=do), dict(lse=lse, delta=delta))
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch("pdt_flash_bwd_dq", [q, k, v, do, lse, delta, dq], q, k, causal,
            scale)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                  scale=None):
    """dk/dv pass over the query tiles: (dk, dv) in k's and v's dtype."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        p, ds = _bwd_tiles(q, k, v, do, lse, delta, causal, scale)
        return _dkv_plain(q, k, v, do, p, ds)
    if q.device.type == "meta":
        _count_meta(4, q, k, causal)
        return (torch.empty_like(k, memory_format=torch.contiguous_format),
                torch.empty_like(v, memory_format=torch.contiguous_format))
    _check(dict(q=q, k=k, v=v, do=do), dict(lse=lse, delta=delta))
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("pdt_flash_bwd_dkv", [q, k, v, do, lse, delta, dk, dv], q, k,
            causal, scale)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: saves q, k, v, out and the row
    LSE (never p) and recomputes p and ds tile by tile."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        # delta_i = sum_d dO * O in f32, laid out like the LSE: (B, H, Lq).
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False, scale=None):
    """Flash attention with its gradient.  q: (B, Lq, H, D); k, v:
    (B, Lk, H, D).  Returns (B, Lq, H, D) in q's dtype."""
    return FlashAttention.apply(q, k, v, causal, _scale(q, scale))
