"""Decode attention over the contiguous KV cache: the CUDA kernels of
``csrc/decode_attention.cu`` and their plain PyTorch versions.

Counterparts of two Pallas TPU kernels in the JAX package's
``ops/pallas_attention.py``:

- ``decode_attention`` (``_decode_kernel``): one query per row,
  q (B, H, Dh) over the cache (B, H, L, Dh); row b attends 0..index[b].
- ``decode_attention_multi`` (``_decode_kernel_multi``): a chunk of C <= 8
  queries per row (the speculative-verify step); query j of row b attends
  0..index[b]+j.

``index`` is a scalar shared by every row (lockstep decode) or a (B,) int32
vector (serving slots).  An entry >= L is the idle-slot sentinel: it
unmasks the whole row, and the caller discards that row's output.

Each wrapper takes the plain version for CPU tensors and launches the CUDA
kernel for CUDA tensors, and nothing else: there is no fallback from one
to the other.  A wrapper counts its kernel launches in ``.launches``: one
a call.  The kernel splits each (row, head)'s visible keys over a cluster
of ``decode_split(...).cluster`` thread blocks and keeps the softmax exact
across them in shared memory: one launch, no scratch in device memory.

The plain versions copy the TPU kernels' numerics: the scale is applied
after an f32 QK^T, masked scores are -1e30, softmax runs in f32, and the
probabilities are rounded to V's dtype before an f32-accumulated PV.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

_NEG_INF = -1e30
MAX_CHUNK = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# A block may use 227 KB of shared memory on Hopper (232,448 bytes).
MAX_SMEM = 232_448
# Constants of csrc/decode_attention.cu that size a block's shared memory:
# keys per share tile (kTile), ring slots (kSlots), queries per tensor-core
# tile (kQPad), warps a block (kWarps), the portable cluster size
# (kMaxCluster).  A long share's ring is held to RING_BYTES; the split
# aims at BLOCKS_PER_SM blocks a call for each SM, as the paged kernel's
# does.
TILE = 16
SLOTS = 8
QPAD = 8
WARPS = 4
MAX_CLUSTER = 8
RING_BYTES = 96 * 1024
BLOCKS_PER_SM = 4


class DecodeSplit(NamedTuple):
    cluster: int     # S: thread blocks per (row, head), one cluster
    share_keys: int  # the most keys one block holds
    tile_keys: int   # keys per ring slot
    smem_bytes: int  # dynamic shared memory per block


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _smem_bytes(share: int, tile: int, chunk: int, head_dim: int,
                itemsize: int) -> int:
    """A block's shared memory (make_layout of the kernel): the ring, q,
    the share's f32 scores, bf16 p (tensor-core path), the partial output
    and the per-query max and sum."""
    mma = itemsize == 2
    off = SLOTS * tile * (_round_up(head_dim * itemsize, 16) + 16)
    if mma:
        off += QPAD * (_round_up(head_dim, 16) + 8) * 2
    else:
        off += chunk * (head_dim + 4) * 4
    off = _round_up(off, 16) + chunk * (share + 4) * 4
    if mma:
        off += QPAD * (share + 8) * 2
    return _round_up(off, 16) + chunk * head_dim * 4 + (2 + WARPS) * QPAD * 4


def decode_layout(cluster: int, length: int, chunk: int, head_dim: int,
                  itemsize: int) -> DecodeSplit:
    """The share and ring of a cluster of ``cluster`` blocks: a share is
    whole ``TILE``-key tiles of the row; the ring's ``SLOTS`` slots hold
    the share's K at once where ``RING_BYTES`` allow (V refills the slots
    K frees), else tiles as large as fit (16 keys at the least, if that is
    what fits).  A small ring keeps a call's blocks resident at once."""
    tiles = -(-length // TILE)
    share = -(-tiles // cluster) * TILE
    row = _round_up(head_dim * itemsize, 16) + 16
    cap = max(TILE, RING_BYTES // (SLOTS * row) // TILE * TILE)
    tile = min(_round_up(-(-share // SLOTS), TILE), cap)
    smem = _smem_bytes(share, tile, chunk, head_dim, itemsize)
    if smem > MAX_SMEM:
        tile = TILE
        smem = _smem_bytes(share, tile, chunk, head_dim, itemsize)
    return DecodeSplit(cluster, share, tile, smem)


@functools.lru_cache(maxsize=None)
def decode_split(batch: int, heads: int, length: int, chunk: int,
                 head_dim: int, num_sms: int, itemsize: int) -> DecodeSplit:
    """How the kernel splits each (row, head)'s keys: from the shapes, the
    storage width and the card's SM count alone, never from ``index`` (no
    device sync).  S, a power of two up to ``MAX_CLUSTER``, brings the
    grid (S x heads x rows) to about ``BLOCKS_PER_SM * num_sms`` blocks
    without cutting a row finer than one ``TILE`` a block; then, where a
    share's scores would not fit a block's shared memory, S doubles up to
    ``MAX_CLUSTER``.  ``smem_bytes`` above ``MAX_SMEM`` means the cache is
    too long for the kernel."""
    tiles = -(-length // TILE)
    want = -(-BLOCKS_PER_SM * num_sms // (batch * heads))
    s = 1
    while s < MAX_CLUSTER and s < want and 2 * s <= tiles:
        s *= 2
    split = decode_layout(s, length, chunk, head_dim, itemsize)
    while split.smem_bytes > MAX_SMEM and split.cluster < MAX_CLUSTER:
        split = decode_layout(2 * split.cluster, length, chunk, head_dim,
                              itemsize)
    return split


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _index_vector(index, batch: int, device) -> torch.Tensor:
    """The (B,) int32 per-row index the kernels take, from a scalar or a
    vector (broadcast like the TPU wrappers do)."""
    if isinstance(index, torch.Tensor):
        if index.device != torch.device(device):
            raise ValueError(
                f"index lies on {index.device}, the cache on {device}"
            )
        index = index.to(torch.int32).reshape(-1)
    else:
        if (torch.device(device).type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            # A host-to-device copy, which a CUDA graph cannot hold.
            raise RuntimeError(
                "a scalar index is copied to the card on each call; under "
                "CUDA graph capture pass the index as a tensor on the card"
            )
        index = torch.tensor([int(index)], dtype=torch.int32, device=device)
    if index.numel() not in (1, batch):
        raise ValueError(
            f"index must be a scalar or have {batch} entries, got "
            f"{index.numel()}"
        )
    return index.expand(batch).contiguous()


def decode_attention_multi_plain(q, k_cache, v_cache, index, *, scale=None):
    """Plain PyTorch version of both kernels.  q: (B, C, H, Dh); k_cache,
    v_cache: (B, H, L, Dh); index: (B,) int (or a scalar).  Returns
    (B, C, H, Dh) in q's dtype."""
    b, c, h, dh = q.shape
    length = k_cache.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    index = _index_vector(index, b, k_cache.device)
    s = torch.einsum(
        "bchd,bhld->bhcl", q.float(), k_cache.float()
    ) * scale
    cols = torch.arange(length, device=q.device)
    last = index[:, None].long() + torch.arange(c, device=q.device)[None, :]
    visible = cols[None, None, :] <= last[:, :, None]          # (B, C, L)
    s = torch.where(visible[:, None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhcl,bhld->bchd", p.float(), v_cache.float())
    return out.to(q.dtype)


def decode_attention_plain(q, k_cache, v_cache, index, *, scale=None):
    """Plain PyTorch version of ``decode_attention``: q (B, H, Dh)."""
    return decode_attention_multi_plain(
        q[:, None], k_cache, v_cache, index, scale=scale
    )[:, 0]


def _check(q, k_cache, v_cache, chunk_dims: int) -> None:
    """What the CUDA kernel takes; anything else raises."""
    if not (q.is_cuda and k_cache.is_cuda and v_cache.is_cuda):
        raise ValueError("the decode-attention kernel takes CUDA tensors")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q, k_cache and v_cache lie on different devices")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(
            f"dtypes differ: q {q.dtype}, k {k_cache.dtype}, "
            f"v {v_cache.dtype}"
        )
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"k_cache/v_cache must be equal (B, H, L, Dh), got "
            f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}"
        )
    b, h, _, dh = k_cache.shape
    if q.dim() != 3 + chunk_dims or q.shape[0] != b or q.shape[-2:] != (h, dh):
        raise ValueError(
            f"q shape {tuple(q.shape)} does not match the cache "
            f"{tuple(k_cache.shape)}"
        )
    if dh % 8 or dh > 128:
        raise ValueError(f"head_dim must be a multiple of 8 up to 128, got {dh}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        # Each row must be contiguous and start on a 16-byte boundary: the
        # kernel reads rows with 16-byte vector loads.
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]):
            raise ValueError(
                f"{name} needs a contiguous last dim and row strides that "
                f"are multiples of 8 elements, got strides {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("decode_attention.cu")
    lib.pdt_decode_plan.argtypes = (
        [ctypes.c_int] * 9 + [ctypes.c_float] + [ctypes.c_longlong] * 12
        + [ctypes.POINTER(ctypes.c_int)] * 2
    )
    lib.pdt_decode_plan.restype = ctypes.c_void_p
    lib.pdt_decode_run.argtypes = [ctypes.c_void_p] * 7
    lib.pdt_decode_run.restype = ctypes.c_int
    lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pdt_cuda_error_string.restype = ctypes.c_char_p
    return lib


_INVALID_CONFIGURATION = 9  # cudaErrorInvalidConfiguration


@functools.lru_cache(maxsize=None)
def _plan(dtype, q_shape, q_strides, k_shape, k_strides, v_strides,
          scale: float, cluster, device) -> int:
    """The kernel's plan for every launch of one shape, made once: the
    split (``cluster`` forces S, 1..8, in place of ``decode_split``'s),
    held against the shared memory a block has and against the kernel's
    own layout, and a check that such a cluster can be resident.  Returns
    the library's plan pointer."""
    b, c, h, dh = q_shape
    length = k_shape[2]
    if not 1 <= c <= MAX_CHUNK:
        raise ValueError(f"chunk width must be 1..{MAX_CHUNK}, got {c}")
    if cluster is None:
        split = decode_split(b, h, length, c, dh, sm_count(device),
                             dtype.itemsize)
    elif 1 <= cluster <= MAX_CLUSTER:
        split = decode_layout(cluster, length, c, dh, dtype.itemsize)
    else:
        raise ValueError(f"cluster must be 1..{MAX_CLUSTER}, got {cluster}")
    if split.smem_bytes > MAX_SMEM:
        raise ValueError(
            f"cache length {length} at chunk {c} needs {split.smem_bytes} "
            f"bytes of shared memory a block, split over {split.cluster} "
            f"blocks, more than a block has ({MAX_SMEM})"
        )
    lib = _library()
    smem, err = ctypes.c_int(), ctypes.c_int()
    plan = lib.pdt_decode_plan(
        _DTYPE_CODES[dtype], c, b, h, length, dh, split.cluster,
        split.share_keys, split.tile_keys, scale, *q_strides[:3],
        *k_strides[:3], *v_strides[:3], c * h * dh, h * dh, dh,
        ctypes.byref(smem), ctypes.byref(err),
    )
    if not plan:
        if err.value == _INVALID_CONFIGURATION:
            raise RuntimeError(
                f"a cluster of {split.cluster} blocks with "
                f"{split.smem_bytes} bytes of shared memory each cannot be "
                "resident on this device"
            )
        msg = lib.pdt_cuda_error_string(err.value).decode()
        raise RuntimeError(f"decode-attention plan failed: {msg} "
                           f"({err.value})")
    if smem.value != split.smem_bytes:
        raise RuntimeError(
            f"the kernel lays out {smem.value} bytes of shared memory a "
            f"block where decode_split counts {split.smem_bytes}: "
            "_smem_bytes and make_layout in csrc/decode_attention.cu differ"
        )
    return plan


def _launch(q, k_cache, v_cache, index, scale, cluster=None) -> torch.Tensor:
    """Launch the kernel for q (B, C, H, Dh); returns (B, C, H, Dh).
    ``cluster`` forces S (1..8) in place of ``decode_split``'s."""
    plan = _plan(q.dtype, q.shape, q.stride(), k_cache.shape,
                 k_cache.stride(), v_cache.stride(), float(scale), cluster,
                 q.device)
    index = _index_vector(index, q.shape[0], k_cache.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _library()
    rc = lib.pdt_decode_run(
        plan, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        index.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        msg = lib.pdt_cuda_error_string(rc).decode()
        raise RuntimeError(f"decode-attention kernel failed: {msg} ({rc})")
    return out


def decode_attention(q, k_cache, v_cache, index, *, scale=None):
    """Single-token KV-cache attention.  q: (B, H, Dh); k_cache/v_cache:
    (B, H, L, Dh); index: scalar or (B,).  Returns (B, H, Dh) in q's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, index, scale=scale)
    _check(q, k_cache, v_cache, chunk_dims=0)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    out = _launch(q[:, None], k_cache, v_cache, index, scale)[:, 0]
    decode_attention.launches += 1
    return out


def decode_attention_multi(q, k_cache, v_cache, index, *, scale=None):
    """Multi-token KV-cache attention.  q: (B, C, H, Dh) with C <= 8, its
    K/V already written at index[b]..index[b]+C-1; query j of row b
    attends 0..index[b]+j.  Returns (B, C, H, Dh) in q's dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return decode_attention_multi_plain(
            q, k_cache, v_cache, index, scale=scale
        )
    _check(q, k_cache, v_cache, chunk_dims=1)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    out = _launch(q, k_cache, v_cache, index, scale)
    decode_attention_multi.launches += 1
    return out


decode_attention.launches = 0
decode_attention_multi.launches = 0
