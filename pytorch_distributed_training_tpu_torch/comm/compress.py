"""The codec layer of the JAX package's ``comm/compress.py``: the
gradient-sync codecs of the two-tier sync's cross-node hop
(``comm/hierarchical.py``, ``--grad-sync``), its bucket layout and
bucket sizer, and the KV-cache codec of the quantized paged pool
(``--serve-kv-dtype``).

**Gradient sync.**  The payload is a ``(n_buckets, shard)`` matrix of
reduce-scattered gradient partials and a row is a bucket: int8 with an
f32 scale per row, int4 with a bf16 scale (two nibbles a byte), or
magnitude top-k (a 1-bit index bitmap plus int8 values ordered by
position, with a bf16 scale).  Error feedback is the caller's loop:
``err = x + residual`` is encoded and ``err - decode(encode(err))`` is
the next residual.  ``bucket_wire_bytes`` is the byte model of each
payload, ``_BucketLayout`` the flatten of a name -> tensor dict into
buckets and ``auto_bucket_mb`` the bucket sizer, whose link constants
describe the inter-node link of an H100 node.

**KV cache.**  A row is one position of one head: K/V are stored as
int8, or as two's-complement int4 nibbles packed two per byte, with one
bf16 scale per row, and dequantized at the attention read (inside the
paged CUDA kernels, or in the plain gather path).

Every codec is bit-exact with the JAX one:

- the scale is ``max|x| / qmax`` in f32 (a true quotient on the card
  too), clamped to f32 ``tiny``, then rounded to its wire dtype;
- the division uses the rounded scale (the transmitted value);
- rounding is half-to-even (``torch.round``, as ``jnp.round``);
- int8 clips to [-127, 127], int4 to [-7, 7];
- int4 packs the low nibble from the even column, the high nibble from
  the odd one;
- top-k keeps, on a tie of magnitudes, the lower index (``lax.top_k``'s
  order; ``torch.topk`` promises none, so the port sorts stably).

**Pipeline stage boundaries** (``--pp-compress``).  The payload is a
(mb, L, D) activation block or its cotangent and a row is a token: bf16
(sent as its 16-bit pattern) or int8 with an f32 scale per token and an
error-feedback residual the engines carry through their tick loops
(``boundary_permute``); ``pp_boundary_bytes_per_step`` is JAX's byte
model of a step's hops.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# Storage dtypes the serving KV pool accepts.  "bf16" means no
# quantization: K/V stay in the model's compute dtype.
KV_DTYPES = ("bf16", "int8", "int4")

# Codec names (the grad-sync modes map onto these as ``hier-<codec>``).
CODECS = ("f32", "bf16", "int8", "int4", "topk")

_TINY = float(np.finfo(np.float32).tiny)
_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def topk_k(cols: int, frac: float) -> int:
    """Values transmitted per row under top-k at ``frac``, shared by the
    encoder and the byte model."""
    return max(1, min(cols, int(cols * frac)))


def _row_scale(x: torch.Tensor, qmax: float,
               dtype=torch.float32) -> torch.Tensor:
    """Per-row ``max|x| / qmax`` scale (keepdim), clamped away from zero
    and stored in ``dtype``.  ``qmax`` divides as a tensor on ``x``'s
    device: CUDA divides by a Python scalar as a product with its f32
    reciprocal, which differs from the quotient in about one row of 20."""
    scale = x.abs().amax(dim=-1, keepdim=True) / x.new_full((), qmax)
    return scale.clamp_min(_TINY).to(dtype)


def encode_int8(err: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) f32 → (q int8, scale f32 (rows, 1))."""
    scale = _row_scale(err, 127.0)
    q = torch.clamp(torch.round(err / scale), -127, 127)
    return q.to(torch.int8), scale


def decode_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale.float()


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


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(rows, cols) bool → (rows, cols // 8) uint8 (LSB = lowest column)."""
    rows, cols = mask.shape
    bits = mask.reshape(rows, cols // 8, 8).to(torch.uint8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8,
                           device=mask.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def _unpack_bits(packed: torch.Tensor, cols: int) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], cols).bool()


def encode_topk(err: torch.Tensor, frac: float):
    """(rows, cols) f32 → (bitmap uint8 (rows, cols // 8), values int8
    (rows, k), scale bf16 (rows, 1)).

    Magnitude top-k per row: the k largest ``|err|``, a tie going to the
    lower index (a stable descending sort, as ``lax.top_k`` orders).  The
    values are quantized to int8 against the selected row's max and sent
    in position order, so the receiver places them at the bitmap's set
    bits.  ``cols`` must be divisible by 8."""
    rows, cols = err.shape
    k = topk_k(cols, frac)
    idx = torch.sort(err.abs(), dim=1, descending=True,
                     stable=True).indices[:, :k]
    mask = torch.zeros((rows, cols), dtype=torch.bool, device=err.device)
    mask.scatter_(1, idx, True)
    pos = torch.sort(idx, dim=1).values
    sel = torch.gather(err, 1, pos)
    scale = _row_scale(sel, 127.0, dtype=torch.bfloat16)
    q = torch.clamp(torch.round(sel / scale.float()), -127, 127)
    return _pack_bits(mask), q.to(torch.int8), scale


def decode_topk(bitmap: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                cols: int) -> torch.Tensor:
    """Inverse of :func:`encode_topk`: the position-ordered values go to
    the bitmap's set bits, in ascending order."""
    rows, k = q.shape
    unset = (~_unpack_bits(bitmap, cols)).to(torch.uint8)
    pos = torch.sort(unset, dim=1, stable=True).indices[:, :k]
    vals = q.float() * scale.float()
    out = torch.zeros((rows, cols), dtype=torch.float32, device=q.device)
    return out.scatter_(1, pos, vals)


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


# ---- the wire byte model -------------------------------------------------


def bucket_wire_bytes(cols: int, codec: str, *, topk_frac: float = 0.1) -> int:
    """Bytes ONE (1, cols) row shard puts on the wire under ``codec``:
    int8 carries an f32 scale per row, int4 and top-k a bf16 scale, top-k
    its 1-bit bitmap."""
    if codec == "f32":
        return 4 * cols
    if codec == "bf16":
        return 2 * cols
    if codec == "int8":
        return cols + 4
    if codec == "int4":
        return cols // 2 + 2
    if codec == "topk":
        return cols // 8 + topk_k(cols, topk_frac) + 2
    raise ValueError(f"unknown codec {codec!r}")


_MODE_CODEC = {
    "flat": "f32", "hier": "f32", "hier-bf16": "bf16",
    "hier-int8": "int8", "hier-int4": "int4", "hier-topk": "topk",
}


# ---- the bucket layout -----------------------------------------------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class _BucketLayout:
    """Flatten/unflatten plan: a name -> tensor dict ↔ (n_buckets, elems).

    The tensors are concatenated in the dict's order into one f32 vector,
    zero-padded to ``n_buckets * bucket_elems`` with ``bucket_elems``
    divisible by ``divisor`` (the group size times any codec packing
    granularity, so every reduce-scatter shard is whole and packable).
    The JAX layout's rule, over the port's names and order."""

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    sizes: tuple[int, ...]
    n_buckets: int
    bucket_elems: int

    @staticmethod
    def build(params: dict, *, bucket_mb: float,
              divisor: int) -> "_BucketLayout":
        names = tuple(params)
        shapes = tuple(tuple(params[n].shape) for n in names)
        sizes = tuple(math.prod(s) for s in shapes)
        total = sum(sizes)
        cap_elems = max(int(bucket_mb * (1 << 20) / 4), 1)
        n_buckets = max(_ceil_div(total, cap_elems), 1)
        bucket_elems = _ceil_div(_ceil_div(total, n_buckets),
                                 divisor) * divisor
        return _BucketLayout(names=names, shapes=shapes, sizes=sizes,
                             n_buckets=n_buckets, bucket_elems=bucket_elems)

    @property
    def padded(self) -> int:
        return self.n_buckets * self.bucket_elems

    def flatten(self, tensors) -> torch.Tensor:
        """A dict (in the layout's order of names) or a list of tensors in
        that order → (n_buckets, bucket_elems) f32."""
        if isinstance(tensors, dict):
            tensors = [tensors[n] for n in self.names]
        flat = torch.cat([t.float().reshape(-1) for t in tensors])
        pad = self.padded - flat.numel()
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.view(self.n_buckets, self.bucket_elems)

    def unflatten(self, buckets: torch.Tensor) -> dict:
        """(n_buckets, bucket_elems) → name -> view of its shape."""
        flat = buckets.reshape(-1)
        out, off = {}, 0
        for name, shape, size in zip(self.names, self.shapes, self.sizes):
            out[name] = flat[off:off + size].view(shape)
            off += size
        return out


# ---- the bucket sizer -------------------------------------------------------

# The inter-node link of an H100 node, which the sizer's crossover is
# computed from.  Bandwidth: one 400 Gb/s ConnectX-7 port per GPU (NVIDIA
# DGX H100 data sheet: 8 single-port ConnectX-7, up to 400 Gb/s
# InfiniBand each), i.e. 50e9 bytes/s a rail.  Latency: the per-step
# latency NCCL's own cost model charges a ring over the network with the
# Simple protocol (src/graph/tuning.cc: base 8.4 us + network hardware
# 14.0 us).  Neither was measured here: the card's machine has one H100
# and no inter-node link.
LINK_LATENCY_S = 22.4e-6
LINK_BYTES_PER_S = 50e9

# Keep per-bucket launch latency at <= 1/10 of wire time.
_LATENCY_HEADROOM = 10.0
_MIN_BUCKET_MB = 4.0
_MAX_BUCKET_MB = 64.0
# Under the phase-pipelined schedule the bucket count is the overlap
# depth: fewer than 3 buckets and the RS/AR/AG wavefront never fills.
_MIN_OVERLAP_DEPTH = 3


def auto_bucket_mb(
    total_param_bytes: int,
    *,
    mode: str = "hier",
    topk_frac: float = 0.1,
    microbatch_flops: float | None = None,
    peak_flops: float | None = None,
    latency_s: float = LINK_LATENCY_S,
    dcn_bytes_per_s: float = LINK_BYTES_PER_S,
    phase_overlap: bool = False,
) -> float:
    """Bucket size (MB of f32 gradient) for ``--grad-sync-bucket-mb auto``,
    the JAX sizer's formula:

    - the target wire time of a bucket is ``_LATENCY_HEADROOM`` times the
      link latency, capped (when ``microbatch_flops`` and ``peak_flops``
      are known) at half a microbatch's compute time; the wire bytes it
      buys, over the codec's wire bytes per f32 element, give the f32
      bucket;
    - clamped to [4, 64] MB and to the whole model;
    - under ``phase_overlap``, capped at a third of the model so that at
      least 3 buckets are in flight;
    - rounded up to the millibyte."""
    codec = _MODE_CODEC.get(mode)
    if codec is None:
        raise ValueError(f"unknown grad-sync mode {mode!r}")
    wire_per_elem = {
        "f32": 4.0, "bf16": 2.0, "int8": 1.0, "int4": 0.5,
        "topk": 0.125 + topk_frac,
    }[codec]
    t_wire = _LATENCY_HEADROOM * latency_s
    if microbatch_flops and peak_flops:
        t_micro = microbatch_flops / peak_flops
        t_wire = min(t_wire, max(t_micro / 2.0, latency_s))
    wire_bytes = t_wire * dcn_bytes_per_s
    f32_bytes = wire_bytes * (4.0 / wire_per_elem)
    mb = f32_bytes / (1 << 20)
    mb = min(max(mb, _MIN_BUCKET_MB), _MAX_BUCKET_MB)
    total_mb = max(total_param_bytes / (1 << 20), 1e-3)
    if phase_overlap:
        mb = min(mb, max(total_mb / _MIN_OVERLAP_DEPTH, 1e-3))
    return math.ceil(min(mb, total_mb) * 1000) / 1000


# ---------------------------------------------------------------------- #
# pipeline stage-boundary codec (--pp-compress)
# ---------------------------------------------------------------------- #

# Stage-boundary payload modes (--pp-compress).
PP_COMPRESS_MODES = ("none", "bf16", "int8")


def _check_pp_mode(mode: str) -> None:
    if mode not in PP_COMPRESS_MODES:
        raise ValueError(
            f"pp-compress mode {mode!r} not in {PP_COMPRESS_MODES}")


def boundary_has_residual(mode: str) -> bool:
    """Whether the boundary codec carries error-feedback state through the
    tick loop (int8 does; bf16's rounding runs stateless, as on the
    grad-sync ladder)."""
    _check_pp_mode(mode)
    return mode == "int8"


def _rows2d(x: torch.Tensor) -> torch.Tensor:
    """(..., D) → (rows, D): the per-token row view the quantizers take."""
    return x.reshape(-1, x.shape[-1])


def _striped_ppermute(x: torch.Tensor, group, perm, stripe: int):
    """``ppermute`` of ``x`` as ``stripe`` concurrent permutes of slices
    of its last axis (the same src → dst hops, the payload split into
    that many transfers in flight); the slices concatenate back, so the
    result is bitwise one ``ppermute``.  ``stripe <= 1``, or a payload
    narrower than the lane count, is the single permute.  ``group`` None
    is a ring of one rank: the hop is to itself."""
    from .collectives import ppermute
    from .striping import split_stripes

    if group is None:
        return x
    parts = split_stripes(x, stripe) if stripe > 1 else [x]
    if len(parts) == 1:
        return ppermute(x, group, perm)
    pending = [ppermute(p, group, perm, async_op=True) for p in parts]
    return torch.cat([p.wait() for p in pending], dim=-1)


def _wire_permute(x: torch.Tensor, group, perm, stripe: int, codec: str,
                  payload=None):
    """One compressed hop of ``x`` along ``perm``: the encoded payload is
    what crosses.  ``none``: ``x`` itself; ``bf16``: ``x`` rounded to
    bf16 and sent as its 16-bit pattern (JAX bitcasts to u16 so that no
    compiler widens the wire; here the integer view moves as bytes),
    widened to f32; ``int8``: the per-token int8 payload (striped) and its
    f32 scale column (one permute), decoded to f32.  ``payload``: int8's
    ``(q, scale)`` of ``x`` when the caller has encoded it already."""
    if codec == "none":
        return _striped_ppermute(x, group, perm, stripe)
    if codec == "bf16":
        wire = x.to(torch.bfloat16).view(torch.int16)
        got = _striped_ppermute(wire, group, perm, stripe)
        return got.view(torch.bfloat16).float()
    from .collectives import ppermute

    q, scale = (payload if payload is not None
                else encode_int8(_rows2d(x.float())))
    qp = _striped_ppermute(q, group, perm, stripe)
    sp = scale if group is None else ppermute(scale, group, perm)
    return decode_int8(qp, sp).reshape(x.shape)


class _BoundaryPermute(torch.autograd.Function):
    """The differentiable compressed hop: the backward sends the cotangent
    along the inverse edges through the same (stateless) codec, so a
    compressed boundary stays compressed in the GPipe backward too (JAX's
    ``_permute_int8`` / ``_permute_bf16`` custom vjps; ``none`` is the
    plain ``ppermute`` transpose)."""

    @staticmethod
    def forward(ctx, x, group, perm, stripe, codec, payload=None):
        ctx.group, ctx.perm, ctx.stripe, ctx.codec = group, perm, stripe, codec
        return _wire_permute(x, group, perm, stripe, codec, payload)

    @staticmethod
    def backward(ctx, ct):
        inverse = tuple((d, s) for s, d in ctx.perm)
        if ctx.codec != "none":
            ct = ct.float()
        out = _wire_permute(ct.contiguous(), ctx.group, inverse, ctx.stripe,
                            ctx.codec)
        return out.to(ct.dtype), None, None, None, None, None


def boundary_permute(y: torch.Tensor, resid, group, perm, mode: str,
                     stripe: int = 1):
    """Compressed ``ppermute`` of one stage-boundary activation over
    ``group``: ``(received, new_resid)``.

    ``resid`` is the int8 mode's error-feedback state the caller carries
    through its tick loop (``()`` for the stateless modes); it re-feeds
    values and is never differentiated (detached).  ``stripe`` splits the
    wire payload into that many concurrent permutes (``--grad-sync-stripe``
    applied to the stage edge): value-exact on every mode, the same
    residuals and the same wire bytes."""
    _check_pp_mode(mode)
    perm = tuple((int(a), int(b)) for a, b in perm)
    stripe = max(int(stripe), 1)
    if mode == "none":
        return _BoundaryPermute.apply(y, group, perm, stripe, "none"), resid
    if mode == "bf16":
        out = _BoundaryPermute.apply(y, group, perm, stripe, "bf16")
        return out.to(y.dtype), resid
    # One encoding: its local decode measures the residual, and the same
    # (q, scale) crosses the wire.
    err = y.float() + resid.detach()
    q, scale = encode_int8(_rows2d(err.detach()))
    new_resid = err.detach() - decode_int8(q, scale).reshape(err.shape)
    out = _BoundaryPermute.apply(err, group, perm, stripe, "int8",
                                 (q, scale))
    return out.to(y.dtype), new_resid


def boundary_payload_bytes(rows: int, cols: int, mode: str,
                           act_itemsize: int = 4) -> int:
    """Wire bytes of ONE stage-boundary payload ((rows, cols) with batch x
    sequence flattened into rows) under ``--pp-compress mode``; int8 adds
    an f32 scale per token."""
    _check_pp_mode(mode)
    if mode == "none":
        return rows * cols * act_itemsize
    if mode == "bf16":
        return rows * cols * 2
    return rows * (cols + 4)


def pp_boundary_bytes_per_step(
    *,
    schedule: str,
    num_stages: int,
    num_microbatches: int,
    microbatch_rows: int,
    seq_len: int,
    hidden: int,
    act_itemsize: int = 4,
    mode: str = "none",
    num_chunks: int = 1,
) -> int:
    """Analytic hop payload bytes per train step across ALL stage
    boundaries, JAX's model: the ring's S edges, the wrap edge included
    (it carries bytes stage 0 ignores, but they cross all the same).

    ``microbatch_rows`` is the GLOBAL rows of a microbatch: with the batch
    split D ways there are D rings of 1/D-sized payloads, so the total
    does not depend on the split.  Each direction (activations forward,
    cotangents backward) moves one payload per edge per tick: GPipe runs
    M+S-1 ticks each way (the autodiff backward transposes every forward
    hop); 1F1B runs 2(M+S-1) ticks and interleaved the table's T, both
    directions hopping every tick."""
    S, M = num_stages, num_microbatches
    payload = boundary_payload_bytes(microbatch_rows * seq_len, hidden, mode,
                                     act_itemsize)
    if schedule == "gpipe":
        per_edge = 2 * (M + S - 1)
    elif schedule == "1f1b":
        per_edge = 2 * (2 * (M + S - 1))
    elif schedule == "interleaved":
        from ..parallel.pipeline_schedule import make_interleaved_schedule

        per_edge = 2 * make_interleaved_schedule(S, num_chunks, M).T
    else:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    return S * per_edge * payload
