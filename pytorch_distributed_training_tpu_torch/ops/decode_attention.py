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
to the other.  A wrapper counts its kernel launches in ``.launches``.

The plain versions copy the TPU kernels' numerics: the scale is applied
after an f32 QK^T, masked scores are -1e30, softmax runs in f32, and the
probabilities are rounded to V's dtype before an f32-accumulated PV.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_NEG_INF = -1e30
MAX_CHUNK = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# A block may use 227 KB of shared memory on Hopper (232,448 bytes).
_MAX_SMEM = 232_448
_WARPS = 8  # kWarps of csrc/decode_attention.cu: sizes its shared memory


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
    lib.pdt_decode_attention.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float] + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
    )
    lib.pdt_decode_attention.restype = ctypes.c_int
    lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pdt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k_cache, v_cache, index, scale) -> torch.Tensor:
    """Launch the kernel for q (B, C, H, Dh); returns (B, C, H, Dh)."""
    b, c, h, dh = q.shape
    length = k_cache.shape[2]
    if not 1 <= c <= MAX_CHUNK:
        raise ValueError(f"chunk width must be 1..{MAX_CHUNK}, got {c}")
    smem = 4 * (c * length + _WARPS * c * dh)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"cache length {length} at chunk {c} needs {smem} bytes of "
            f"shared memory, more than a block has ({_MAX_SMEM})"
        )
    index = _index_vector(index, b, k_cache.device)
    out = torch.empty((b, c, h, dh), dtype=q.dtype, device=q.device)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.pdt_decode_attention(
        _DTYPE_CODES[q.dtype], c, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), index.data_ptr(), out.data_ptr(),
        b, h, length, dh, float(scale),
        q.stride(0), q.stride(1), q.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        stream,
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
