"""Attention over the paged KV block pool: the CUDA kernel of
``csrc/paged_attention.cu`` and its plain PyTorch version.

Counterparts of the paged Pallas TPU kernels in the JAX package's
``ops/pallas_attention.py``, with the same entry points and signatures:

- ``paged_decode_attention`` (``_paged_decode_kernel``): one query per row,
  q (B, H, Dh);
- ``paged_decode_attention_multi`` (C <= 8, the speculative verify chunk)
  and ``paged_prefill_attention`` (C <= ``MAX_FUSED_PREFILL_CHUNK``,
  chunked prefill), which share one kernel as the TPU ones share
  ``_paged_multi_call``: q (B, C, H, Dh), query j of row b attends
  0..index[b]+j.

``k_blocks``/``v_blocks`` are (num_blocks, H, block_size, Dh) physical
blocks; ``block_table`` (B, nb) int32 maps row b's logical block j to a
physical one and arrives pre-clamped to real blocks; ``index`` (B,) is the
first query's position per row (or a scalar).  An index >= nb * block_size
is the idle-row sentinel: it unmasks the whole row, whose output the
caller discards.  Quantized pools (``quant`` "int8"/"int4") pass the
payload as the blocks and bf16 ``k_scale``/``v_scale`` of shape
(num_blocks, H, block_size); the kernel dequantizes per element.

Each entry takes the plain version for CPU tensors and launches the CUDA
kernel for CUDA tensors, and nothing else: there is no fallback from one
to the other.  Each counts its calls that reach the card in ``.launches``:
one a call, which is two device kernels (``paged_split``: a partition
kernel, then a combine kernel).

The plain version gathers each row's blocks through the table into a
(B, H, nb * block_size, Dh) window, dequantizes a quantized window, and
applies the masked softmax: the JAX package's gather path
(``models/layers.py::_paged_attend``), which is what its engine runs off
the TPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..comm.compress import dequantize_kv
from . import _build
from .decode_attention import (
    MAX_CHUNK, _index_vector, decode_attention_multi_plain, sm_count,
)

# Widest prefill chunk the fused kernel takes, as in the JAX package;
# models/layers.py sends wider chunks down the plain gather path.
MAX_FUSED_PREFILL_CHUNK = 64
QUANTS = ("int8", "int4")
# Widest block table the kernel takes (kMaxTable).
MAX_TABLE_WIDTH = 1024
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STORED_DTYPE = {"int8": torch.int8, "int4": torch.uint8}
# The kernel splits each row's keys into partitions of a multiple of
# PART_ALIGN keys (kPartAlign), one thread block each, and aims at about
# BLOCKS_PER_SM blocks a call for each SM of the card.  A partition holds
# at most MAX_PART_KEYS keys: a long row still spreads over many blocks,
# and each block's f32 sums stay short.
PART_ALIGN = 64
BLOCKS_PER_SM = 4
MAX_PART_KEYS = 256


class PagedSplit(NamedTuple):
    num_parts: int   # partitions of a row's key span
    part_keys: int   # keys per partition
    scratch: int     # f32 partials the combine reads


@functools.lru_cache(maxsize=None)
def paged_split(batch: int, heads: int, table_width: int, block_size: int,
                chunk: int, head_dim: int, num_sms: int) -> PagedSplit:
    """How the kernel splits the key span of a call (flash-decoding): from
    the shapes and the card's SM count alone, never from ``index`` (no
    device sync).  The span (``table_width * block_size`` keys) is cut into
    partitions of whole ``PART_ALIGN``-key tiles, as many as bring the
    grid (partitions x heads x rows) to about ``BLOCKS_PER_SM * num_sms``,
    and at least as many as keep each within ``MAX_PART_KEYS``.  Each live
    block writes (m, l, acc) in f32 for its ``chunk`` queries: ``scratch``
    floats in all."""
    span = table_width * block_size
    tiles = -(-span // PART_ALIGN)
    want = -(-BLOCKS_PER_SM * num_sms // (batch * heads))
    parts = max(1, min(tiles, want))
    part_keys = min(-(-tiles // parts) * PART_ALIGN, MAX_PART_KEYS)
    parts = -(-span // part_keys)
    return PagedSplit(parts, part_keys,
                      batch * heads * parts * chunk * (head_dim + 2))


def gather_window(blocks: torch.Tensor, block_table: torch.Tensor):
    """Physical blocks (N, H, bs, ...) through a (B, nb) table → each
    row's contiguous (B, H, nb * bs, ...) window (payloads and scales)."""
    g = blocks[block_table.long()]                  # (B, nb, H, bs, ...)
    b, nb, h, bs = g.shape[:4]
    return g.transpose(1, 2).reshape(b, h, nb * bs, *g.shape[4:])


def paged_window(k_blocks, v_blocks, block_table, *, k_scale=None,
                 v_scale=None, quant=None):
    """K/V windows (B, H, nb * bs, Dh) through the table, dequantized to
    f32 when the pool is quantized."""
    kk = gather_window(k_blocks, block_table)
    vv = gather_window(v_blocks, block_table)
    if quant is not None:
        kk = dequantize_kv(kk, gather_window(k_scale, block_table), quant)
        vv = dequantize_kv(vv, gather_window(v_scale, block_table), quant)
    return kk, vv


def paged_attention_plain(q, k_blocks, v_blocks, block_table, index, *,
                          scale=None, k_scale=None, v_scale=None,
                          quant=None):
    """Plain PyTorch version of the kernel.  q: (B, C, H, Dh).  Returns
    (B, C, H, Dh) in q's dtype."""
    kk, vv = paged_window(k_blocks, v_blocks, block_table, k_scale=k_scale,
                          v_scale=v_scale, quant=quant)
    return decode_attention_multi_plain(q, kk, vv, index, scale=scale)


def _check(q, k_blocks, v_blocks, block_table, k_scale, v_scale, quant,
           chunk_dims: int) -> None:
    """What the CUDA kernel takes; anything else raises."""
    tensors = [q, k_blocks, v_blocks, block_table]
    if quant is not None:
        tensors += [k_scale, v_scale]
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the paged-attention kernel takes CUDA tensors")
    if any(t.device != q.device for t in tensors):
        raise ValueError("the paged-attention operands lie on different "
                         "devices")
    if q.dtype not in _Q_CODES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    stored = _STORED_DTYPE.get(quant, q.dtype)
    if not (k_blocks.dtype == v_blocks.dtype == stored):
        raise ValueError(
            f"blocks must be {stored} for q {q.dtype} and quant {quant}, "
            f"got k {k_blocks.dtype}, v {v_blocks.dtype}"
        )
    if k_blocks.dim() != 4 or k_blocks.shape != v_blocks.shape:
        raise ValueError(
            f"k_blocks/v_blocks must be equal (N, H, bs, Dh), got "
            f"{tuple(k_blocks.shape)} and {tuple(v_blocks.shape)}"
        )
    _, h, bs, dh_stored = k_blocks.shape
    dh = q.shape[-1]
    if dh % 8 or dh > 128:
        raise ValueError(f"head_dim must be a multiple of 8 up to 128, got {dh}")
    if dh_stored != (dh // 2 if quant == "int4" else dh):
        raise ValueError(
            f"stored head dim {dh_stored} does not fit q's {dh} "
            f"(quant {quant})"
        )
    if q.dim() != 3 + chunk_dims or q.shape[-2] != h:
        raise ValueError(
            f"q shape {tuple(q.shape)} does not match the blocks "
            f"{tuple(k_blocks.shape)}"
        )
    if (block_table.dim() != 2 or block_table.dtype != torch.int32
            or block_table.shape[0] != q.shape[0]
            or not 1 <= block_table.shape[1] <= MAX_TABLE_WIDTH
            or block_table.stride(-1) != 1):
        raise ValueError(
            f"block_table must be a (B, nb) int32 table with contiguous "
            f"rows and nb <= {MAX_TABLE_WIDTH}, got {block_table.dtype} "
            f"{tuple(block_table.shape)}"
        )
    if quant is not None:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (sc.dtype != torch.bfloat16
                    or tuple(sc.shape) != tuple(k_blocks.shape[:3])
                    or not sc.is_contiguous()):
                raise ValueError(
                    f"{name} must be contiguous bf16 (N, H, bs), got "
                    f"{sc.dtype} {tuple(sc.shape)}"
                )
    if q.stride(-1) != 1:
        raise ValueError("q needs a contiguous last dim")
    for name, t in (("k_blocks", k_blocks), ("v_blocks", v_blocks)):
        # Rows are read with 16-, 8- or 4-byte vector loads.
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("paged_attention.cu")
    lib.pdt_paged_attention.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
        + [ctypes.c_float] + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
    )
    lib.pdt_paged_attention.restype = ctypes.c_int
    lib.pdt_paged_error_string.argtypes = [ctypes.c_int]
    lib.pdt_paged_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k_blocks, v_blocks, block_table, index, scale, k_scale,
            v_scale, quant) -> torch.Tensor:
    """Launch the kernel for q (B, C, H, Dh); returns (B, C, H, Dh)."""
    b, c, h, dh = q.shape
    n_blocks, _, bs, _ = k_blocks.shape
    index = _index_vector(index, b, q.device)
    out = torch.empty((b, c, h, dh), dtype=q.dtype, device=q.device)
    split = paged_split(b, h, block_table.shape[1], bs, c, dh,
                        sm_count(q.device))
    partials = torch.empty(split.scratch, dtype=torch.float32, device=q.device)
    if quant is None:
        storage = _Q_CODES[q.dtype]
        ks_ptr = vs_ptr = None
        s_n = s_h = 0
    else:
        storage = 2 if quant == "int8" else 3
        ks_ptr, vs_ptr = k_scale.data_ptr(), v_scale.data_ptr()
        s_n, s_h = k_scale.stride(0), k_scale.stride(1)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.pdt_paged_attention(
        storage, _Q_CODES[q.dtype], c, q.data_ptr(), k_blocks.data_ptr(),
        v_blocks.data_ptr(), ks_ptr, vs_ptr, block_table.data_ptr(),
        index.data_ptr(), out.data_ptr(), partials.data_ptr(), b, h, dh, bs,
        block_table.shape[1], n_blocks, split.num_parts, split.part_keys,
        float(scale),
        q.stride(0), q.stride(1), q.stride(2),
        k_blocks.stride(0), k_blocks.stride(1), k_blocks.stride(2),
        s_n, s_h, block_table.stride(0),
        out.stride(0), out.stride(1), out.stride(2),
        stream,
    )
    if rc != 0:
        msg = lib.pdt_paged_error_string(rc).decode()
        raise RuntimeError(f"paged-attention kernel failed: {msg} ({rc})")
    return out


def _check_quant(quant, k_scale, v_scale) -> None:
    if quant is None:
        if k_scale is not None or v_scale is not None:
            raise ValueError("k_scale/v_scale belong to a quantized pool "
                             "(pass quant)")
        return
    if quant not in QUANTS:
        raise ValueError(f"unknown kv quant {quant!r} (int8|int4)")
    if k_scale is None or v_scale is None:
        raise ValueError(f"quant {quant!r} needs k_scale and v_scale")


def _run(entry, q, k_blocks, v_blocks, block_table, index, scale, k_scale,
         v_scale, quant, chunk_dims: int):
    """Plain version for CPU tensors, else the checked kernel launch,
    counted on ``entry``.  q: (B, C, H, Dh)."""
    _check_quant(quant, k_scale, v_scale)
    kw = dict(k_scale=k_scale, v_scale=v_scale, quant=quant)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_blocks, v_blocks, block_table,
                                     index, scale=scale, **kw)
    q_in = q[:, 0] if chunk_dims == 0 else q
    _check(q_in, k_blocks, v_blocks, block_table, k_scale, v_scale, quant,
           chunk_dims)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    out = _launch(q, k_blocks, v_blocks, block_table, index, scale, **kw)
    entry.launches += 1
    return out


def paged_decode_attention(q, k_blocks, v_blocks, block_table, index, *,
                           scale=None, k_scale=None, v_scale=None,
                           quant=None):
    """Single-token attention through the block table.  q: (B, H, Dh);
    returns (B, H, Dh) in q's dtype."""
    return _run(paged_decode_attention, q[:, None], k_blocks, v_blocks,
                block_table, index, scale, k_scale, v_scale, quant,
                chunk_dims=0)[:, 0]


def paged_decode_attention_multi(q, k_blocks, v_blocks, block_table, index,
                                 *, scale=None, k_scale=None, v_scale=None,
                                 quant=None):
    """Multi-token attention through the block table, C <= 8 (the verify
    chunk).  q: (B, C, H, Dh), its K/V already written at
    index[b]..index[b]+C-1; returns (B, C, H, Dh) in q's dtype."""
    if not 1 <= q.shape[1] <= MAX_CHUNK:
        raise ValueError(f"chunk width must be 1..{MAX_CHUNK}, got "
                         f"{q.shape[1]}")
    return _run(paged_decode_attention_multi, q, k_blocks, v_blocks,
                block_table, index, scale, k_scale, v_scale, quant,
                chunk_dims=1)


def paged_prefill_attention(q, k_blocks, v_blocks, block_table, index, *,
                            scale=None, k_scale=None, v_scale=None,
                            quant=None):
    """Chunked-prefill attention through the block table, C <=
    ``MAX_FUSED_PREFILL_CHUNK``.  Same contract as
    :func:`paged_decode_attention_multi`; index[b] is the chunk's start
    (a prefix-cache hit starts past the cached blocks)."""
    if not 1 <= q.shape[1] <= MAX_FUSED_PREFILL_CHUNK:
        raise ValueError(
            f"prefill chunk {q.shape[1]} outside 1..{MAX_FUSED_PREFILL_CHUNK}"
            " (models/layers.py sends wider chunks down the gather path)"
        )
    return _run(paged_prefill_attention, q, k_blocks, v_blocks, block_table,
                index, scale, k_scale, v_scale, quant, chunk_dims=1)


paged_decode_attention.launches = 0
paged_decode_attention_multi.launches = 0
paged_prefill_attention.launches = 0
