"""The port's decode-attention ops against the Pallas kernels.

The plain PyTorch versions of ``decode_attention`` / ``decode_attention_
multi`` are held against the JAX package's Pallas kernels run in
interpret mode (f32, atol 2e-5: summation order only), over a scalar
index, a per-row index vector, the idle-slot sentinel (index >= L), rows
whose first queries see no key (index < 0: the mean of V over all L
positions) and chunk widths 1..8.  The kernel's cluster split is held
there too, through a test-local reference of its arithmetic
(``_cluster_reference``), and ``decode_split`` is pinned by shape and SM
count.  The wrapper contract is pinned as well: CPU tensors take the
plain version and count no launch, bad inputs raise, and the kernel build
raises instead of falling back when nvcc is missing.  The CUDA kernel
itself is compared with the plain version on a card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops.pallas_attention import (
    decode_attention as jax_decode_attention,
    decode_attention_multi as jax_decode_attention_multi,
)
from pytorch_distributed_training_tpu_torch.ops import _build
from pytorch_distributed_training_tpu_torch.ops import decode_attention as da

B, H, L, DH = 4, 3, 40, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the cores are
    shared with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, c, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, H, L, DH)).astype(np.float32)
    v = rng.standard_normal((B, H, L, DH)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("index", [
    np.int32(17),                                  # lockstep: one scalar
    np.asarray([0, 9, L - 1, L], np.int32),        # ragged + sentinel row
    np.asarray([-1, 9, L - 1, L], np.int32),       # row 0 sees no key
])
def test_single_query_matches_pallas(index):
    q, k, v = _inputs(1, seed=1)
    ref = np.asarray(jax_decode_attention(
        jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(index), interpret=True,
    ))
    idx = torch.as_tensor(np.asarray(index))
    out = da.decode_attention(
        torch.from_numpy(q[:, 0]), torch.from_numpy(k), torch.from_numpy(v),
        idx if idx.dim() else int(idx),
    )
    assert out.shape == (B, H, DH) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("c", range(1, 9))
def test_multi_query_matches_pallas(c):
    q, k, v = _inputs(c, seed=10 + c)
    # Row 2's chunk runs past the cache end; row 3 is the sentinel.  In
    # the second index, row 0's chunk starts at -2: its first two queries
    # see no key, and both sides return the mean of V there.
    for index in (np.asarray([0, 11, L - 3, L + 5], np.int32),
                  np.asarray([-2, 11, L - 3, -1], np.int32)):
        ref = np.asarray(jax_decode_attention_multi(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(index), interpret=True,
        ))
        out = da.decode_attention_multi(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(index),
        )
        assert out.shape == (B, c, H, DH)
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)
    mean_v = v[0].mean(axis=1)                          # (H, DH)
    for j in range(min(c, 2)):
        np.testing.assert_allclose(out.numpy()[0, j], mean_v, atol=2e-5)


def test_bf16_rounds_probabilities_like_the_kernel():
    """bf16 inputs: p is rounded to bf16 before PV, as in the TPU kernel;
    the plain version agrees with the Pallas kernel to bf16 rounding."""
    q, k, v = _inputs(2, seed=3)
    index = np.asarray([4, 20, L - 1, L], np.int32)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jax_decode_attention_multi(
        qb, kb, vb, jnp.asarray(index), interpret=True,
    ).astype(jnp.float32))
    out = da.decode_attention_multi(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(index),
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_cpu_tensors_count_no_launch():
    q, k, v = _inputs(2, seed=4)
    before = (da.decode_attention.launches, da.decode_attention_multi.launches)
    da.decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                        torch.from_numpy(v), 3)
    da.decode_attention_multi(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), 3)
    assert (da.decode_attention.launches,
            da.decode_attention_multi.launches) == before


def test_index_must_match_batch():
    q, k, v = _inputs(1, seed=5)
    with pytest.raises(ValueError, match="entries"):
        da.decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                            torch.from_numpy(v), torch.tensor([1, 2]))


def test_kernel_checks_reject_what_it_cannot_take():
    """The CUDA wrapper's input checks, run on meta tensors (no card
    needed): non-CUDA tensors and chunk widths past 8 raise before any
    launch (the checks a card needs are in test_torch_cuda_kernels.py)."""
    meta = dict(device="meta")
    q = torch.empty(B, H, DH, **meta)
    kv = torch.empty(B, H, L, DH, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        da._check(q, kv, kv, chunk_dims=0)
    with pytest.raises(ValueError, match="chunk width"):
        da._launch(torch.empty(B, 9, H, DH, **meta), kv, kv, 0, 1.0)


def test_build_raises_without_nvcc(monkeypatch):
    """No silent fallback: a missing compiler is an error."""
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_library_path_keyed_by_source_hash():
    path = _build.library_path("decode_attention.cu")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("decode_attention-") and path.suffix == ".so"
    assert path == _build.library_path("decode_attention.cu")


# The kernel's cluster split, on the host: ``_cluster_reference`` cuts each
# row's visible keys into the S shares the kernel's blocks take (whole
# 16-key tiles, equal shares, the last ones short or empty), and follows
# its exact softmax across them: the global max over the shares, each
# share's sum of exp(s - M), the global sum in rank order, p = exp(s - M)
# / Z rounded to V's dtype, then each share's partial p . V in f32, summed
# in rank order.  A query that sees no key takes all L keys at score 0.
# Rows: a chunk that starts at -2, fresh rows, ragged ones, a full row and
# the idle sentinel, over L = 72 (4.5 tiles: S = 2, 4, 8 leave short and
# empty shares).
CL_L, CL_H, CL_DH = 72, 2, 16
CL_INDEX = np.asarray([-2, 0, 5, 17, 40, CL_L - 1, CL_L, 33], np.int32)


def _round(x, dtype):
    """f32 values rounded to ``dtype`` and back."""
    return torch.from_numpy(x).to(dtype).float().numpy()


def _cluster_reference(q, k, v, index, s_blocks, scale, dtype=torch.float32):
    """(B, C, H, Dh) f32 from q (B, C, H, Dh), k/v (B, H, L, Dh), the
    kernel's arithmetic with S = ``s_blocks`` blocks a (row, head)."""
    b, c, h, dh = q.shape
    length = k.shape[2]
    s = np.einsum("bchd,bhld->bhcl", q, k) * np.float32(scale)
    last = index[:, None].astype(np.int64) + np.arange(c)[None, :]
    cols = np.arange(length)
    visible = (cols[None, None, :] <= last[:, :, None]) | (last < 0)[..., None]
    s = np.where((last < 0)[:, None, :, None], np.float32(0), s)
    n_keys = np.where(index < 0, length,
                      np.minimum(index.astype(np.int64) + c, length))
    per = -(-(-(-n_keys // 16)) // s_blocks) * 16            # (B,)
    rank = np.where(cols[None, :] < n_keys[:, None],
                    cols[None, :] // per[:, None], -1)       # (B, L)
    shares = [(rank == r)[:, None, None, :] & visible[:, None]
              for r in range(s_blocks)]
    neg = np.float32(-np.inf)
    m = np.max([np.where(sh, s, neg).max(-1) for sh in shares], axis=0)
    e = np.where(visible[:, None], np.exp(s - m[..., None]), np.float32(0))
    z = np.zeros_like(m)
    for sh in shares:
        z = z + np.where(sh, e, np.float32(0)).sum(-1, dtype=np.float32)
    p = _round((e / z[..., None]).astype(np.float32), dtype)
    out = np.zeros((b, h, c, dh), np.float32)
    for sh in shares:
        out = out + np.einsum("bhcl,bhld->bhcd",
                              np.where(sh, p, np.float32(0)), v)
    return out.transpose(0, 2, 1, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cluster_case(c, dtype_name):
    """Inputs (rounded to the dtype), the Pallas kernel's output in
    interpret mode and the plain version's, for C = ``c``."""
    dtype = getattr(torch, dtype_name)
    rng = np.random.default_rng(70 + c)
    b = len(CL_INDEX)
    q = rng.standard_normal((b, c, CL_H, CL_DH)).astype(np.float32)
    k = rng.standard_normal((b, CL_H, CL_L, CL_DH)).astype(np.float32)
    v = rng.standard_normal((b, CL_H, CL_L, CL_DH)).astype(np.float32)
    q, k, v = (_round(x, dtype) for x in (q, k, v))
    jdt = jnp.bfloat16 if dtype is torch.bfloat16 else jnp.float32
    pallas = np.asarray(jax_decode_attention_multi(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(CL_INDEX),
        interpret=True,
    ).astype(jnp.float32))
    plain = da.decode_attention_multi(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
        torch.from_numpy(CL_INDEX),
    ).float().numpy()
    return q, k, v, pallas, plain


@pytest.mark.parametrize("dtype_name,atol,rtol", [("float32", 2e-5, 0.0),
                                                  ("bfloat16", 2e-2, 2e-2)])
@pytest.mark.parametrize("c", [1, 5, 8])
@pytest.mark.parametrize("s_blocks", [1, 2, 4, 8])
def test_cluster_reference_matches_pallas_and_plain(s_blocks, c, dtype_name,
                                                    atol, rtol):
    q, k, v, pallas, plain = _cluster_case(c, dtype_name)
    ref = _cluster_reference(q, k, v, CL_INDEX, s_blocks, CL_DH ** -0.5,
                             getattr(torch, dtype_name))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(ref, pallas, atol=atol, rtol=rtol)
    np.testing.assert_allclose(ref, plain, atol=atol, rtol=rtol)
    # Rows 0 (chunk at -2) and 1 (fresh) split unevenly or leave shares
    # empty at S > 1: the first two queries of row 0 average V.
    mean_v = _round(v[0].mean(axis=1), getattr(torch, dtype_name))
    for j in range(min(c, 2)):
        np.testing.assert_allclose(ref[0, j], mean_v, atol=atol, rtol=rtol)


H100_SMS = 132


@pytest.mark.parametrize("chunk,itemsize,expect", [
    # The serving shapes (B 8, H 12, L 1024, Dh 64) on 132 SMs: clusters
    # of 8, 128 keys a block, the share's K in the ring at once (V refills
    # the slots K frees): 8 or more blocks an SM fit, all 768 at once.
    (1, 2, (8, 128, 16, 22736)),
    (5, 2, (8, 128, 16, 25872)),
    (8, 2, (8, 128, 16, 28224)),
    (5, 4, (8, 128, 16, 40288)),
])
def test_decode_split_at_the_serving_shapes(chunk, itemsize, expect):
    split = da.decode_split(8, 12, 1024, chunk, 64, H100_SMS, itemsize)
    assert tuple(split) == expect
    assert split.smem_bytes <= da.MAX_SMEM


def test_decode_split_small_and_wide_calls():
    # A tiny cache: 3 tiles of 16 keys split over 2 blocks, not 8.
    tiny = da.decode_split(4, 3, 40, 1, 16, H100_SMS, 4)
    assert (tiny.cluster, tiny.share_keys, tiny.tile_keys) == (2, 32, 16)
    # Enough (row, head) pairs to fill the card alone: no split.
    wide = da.decode_split(64, 16, 1024, 1, 64, H100_SMS, 2)
    assert (wide.cluster, wide.share_keys) == (1, 1024)
    # Fewer SMs, fewer blocks: 2 a (row, head) at the serving shapes.
    assert da.decode_split(8, 12, 1024, 1, 64, 40, 2).cluster == 2


@pytest.mark.parametrize("itemsize", [2, 4])
def test_decode_split_long_cache_fits(itemsize):
    """L 8192 at C 8: the whole-row kernel needed 4 * (8 * 8192 + 8 * 8
    * 64) = 278,528 bytes of shared memory a block and refused it; a share
    of 1024 keys fits, its ring refilled from 8 slots."""
    split = da.decode_split(8, 12, 8192, 8, 64, H100_SMS, itemsize)
    assert split.cluster == 8 and split.share_keys == 1024
    assert split.smem_bytes <= da.MAX_SMEM
    assert 8 * split.tile_keys < 2 * split.share_keys
    # Wide enough not to split by occupancy: S doubles until it fits.
    wide = da.decode_split(64, 16, 8192, 8, 128, H100_SMS, 4)
    assert wide.cluster == 2 and wide.smem_bytes <= da.MAX_SMEM


def test_launch_refuses_a_cache_past_the_limit():
    """Past the limit the wrapper raises, naming it, before any launch
    (meta tensors: no card needed)."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    length = 34_960          # 8 shares of 4384 keys at C 8: 232,512 bytes
    kv = torch.empty(1, 1, length, 64, **meta)
    q = torch.empty(1, 8, 1, 64, **meta)
    assert da.decode_layout(8, 34_944, 8, 64, 2).smem_bytes <= da.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        da._launch(q, kv, kv, 0, 1.0, cluster=8)
    with pytest.raises(ValueError, match="cluster must be"):
        da._launch(q[:, :, :, :], kv[:, :, :64], kv[:, :, :64], 0, 1.0,
                   cluster=16)
