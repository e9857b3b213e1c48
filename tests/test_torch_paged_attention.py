"""The port's paged-attention ops and KV codec against the JAX package.

The plain PyTorch versions of ``paged_decode_attention`` (#11) and of the
``_paged_multi_call`` entries ``paged_decode_attention_multi`` /
``paged_prefill_attention`` (#12) are held against the JAX package's
Pallas kernels run in interpret mode, on the same numpy inputs: native f32
(atol 2e-5: summation order and the kernel's online softmax) and bf16
(atol/rtol 2e-2: one bf16 rounding of p and of the output), and int8/int4
pools fed the same stored bytes to both sides.  Index cases: a fresh row
(0), mid-block, past a prefix hit, and the idle sentinel (>= nb * bs).

The KV codec (``comm/compress.py``) is pinned bit-exact against the JAX
codec: payload bytes and bf16 scale bits, rounding ties included.  The
wrapper contract is pinned too: chunks past the entry's width raise, CPU
tensors count no launch, and the CUDA input checks raise on meta tensors
before any launch.  The CUDA kernel itself is compared with the plain
version on a card by tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.comm import compress as jax_compress
from pytorch_distributed_training_tpu.ops.pallas_attention import (
    paged_decode_attention as jax_paged_decode,
    paged_decode_attention_multi as jax_paged_multi,
    paged_prefill_attention as jax_paged_prefill,
)
from pytorch_distributed_training_tpu_torch.comm import compress
from pytorch_distributed_training_tpu_torch.ops import paged_attention as pa

B, H, BS, NB, N_BLOCKS = 4, 2, 4, 24, 30
SPAN = NB * BS
# fresh row, mid-block, past a prefix hit (3 cached blocks), idle sentinel
INDEX = np.asarray([0, 5, 12, SPAN], np.int32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the cores are
    shared with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, c, H, dh)).astype(np.float32)
    k = rng.standard_normal((N_BLOCKS, H, BS, dh)).astype(np.float32)
    v = rng.standard_normal((N_BLOCKS, H, BS, dh)).astype(np.float32)
    table = np.stack([rng.permutation(N_BLOCKS)[:NB] for _ in range(B)])
    table[3, NB // 2:] = N_BLOCKS        # unallocated entries ...
    table = np.minimum(table, N_BLOCKS - 1).astype(np.int32)  # ... clamped
    return q, k, v, table


def _jax_entry(c):
    if c == 1:
        return lambda q, *a, **kw: jax_paged_decode(q[:, 0], *a, **kw)[:, None]
    return jax_paged_multi if c <= 8 else jax_paged_prefill


def _port_entry(c):
    if c == 1:
        return lambda q, *a, **kw: pa.paged_decode_attention(
            q[:, 0], *a, **kw)[:, None]
    if c <= 8:
        return pa.paged_decode_attention_multi
    return pa.paged_prefill_attention


def _bf16_to_torch(x) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(
        np.asarray(x).view(np.uint16).astype(np.int16)
    ).view(torch.bfloat16)


@pytest.mark.parametrize("c", [1, 5, 8, 16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_native_matches_pallas(c, dtype):
    dh = 8 if c == 64 else 16
    q, k, v, table = _inputs(c, dh, seed=c)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    ref = np.asarray(_jax_entry(c)(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(table),
        jnp.asarray(INDEX), interpret=True,
    ).astype(jnp.float32))
    out = _port_entry(c)(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(table), torch.from_numpy(INDEX),
    )
    assert out.shape == (B, c, H, dh) and out.dtype == tdt
    tol = dict(atol=2e-5, rtol=0) if dtype == "float32" else dict(
        atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


@pytest.mark.parametrize("c", [1, 5, 16])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_matches_pallas_on_the_same_bytes(c, quant):
    q, k, v, table = _inputs(c, 16, seed=20 + c)
    kq, ks = jax_compress.quantize_kv(jnp.asarray(k), quant)
    vq, vs = jax_compress.quantize_kv(jnp.asarray(v), quant)
    ref = np.asarray(_jax_entry(c)(
        jnp.asarray(q), kq, vq, jnp.asarray(table), jnp.asarray(INDEX),
        interpret=True, k_scale=ks, v_scale=vs, quant=quant,
    ))
    out = _port_entry(c)(
        torch.from_numpy(q), torch.from_numpy(np.array(kq)),
        torch.from_numpy(np.array(vq)), torch.from_numpy(table),
        torch.from_numpy(INDEX), k_scale=_bf16_to_torch(ks),
        v_scale=_bf16_to_torch(vs), quant=quant,
    )
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)


def test_quantized_bf16_queries_match_pallas():
    """bf16 q over an int8 pool (the serving case): q is widened to f32
    on both sides and p stays f32, so only the output rounds to bf16."""
    q, k, v, table = _inputs(5, 16, seed=31)
    kq, ks = jax_compress.quantize_kv(jnp.asarray(k), "int8")
    vq, vs = jax_compress.quantize_kv(jnp.asarray(v), "int8")
    ref = np.asarray(jax_paged_multi(
        jnp.asarray(q, jnp.bfloat16), kq, vq, jnp.asarray(table),
        jnp.asarray(INDEX), interpret=True, k_scale=ks, v_scale=vs,
        quant="int8",
    ).astype(jnp.float32))
    out = pa.paged_decode_attention_multi(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(np.array(kq)),
        torch.from_numpy(np.array(vq)), torch.from_numpy(table),
        torch.from_numpy(INDEX), k_scale=_bf16_to_torch(ks),
        v_scale=_bf16_to_torch(vs), quant="int8",
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_codec_bit_exact_with_jax(quant):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 3, 5, 16)).astype(np.float32)
    # Rounding ties: max|x| = qmax makes the scale exactly 1, so the
    # half-integer entries land on .5 (half-to-even decides them).
    halves = np.arange(14) - 6.5
    x[0, 0, 0] = np.concatenate([[7.0, -7.0], halves])
    x[0, 0, 1] = np.concatenate([[127.0, -127.0], halves * 17])
    x[0, 0, 2] = 0.0                       # an all-zero row: the tiny clamp
    x[0, 0, 3] = 1e-39                     # denormal row
    jq, js = jax_compress.quantize_kv(jnp.asarray(x), quant)
    tq, ts = compress.quantize_kv(torch.from_numpy(x), quant)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == (torch.int8 if quant == "int8" else torch.uint8)
    np.testing.assert_array_equal(
        ts.view(torch.int16).numpy().view(np.uint16),
        np.asarray(js).view(np.uint16),
    )
    np.testing.assert_array_equal(
        compress.dequantize_kv(tq, ts, quant).numpy(),
        np.asarray(jax_compress.dequantize_kv(jq, js, quant)),
    )


def test_int4_nibble_order():
    """Low nibble = even column, two's complement."""
    x = torch.tensor([[7.0, -7.0, 1.0, -1.0]])
    packed, scale = compress.encode_int4(x)
    assert scale.item() == 1.0
    assert packed.tolist() == [[0x97, 0xF1]]
    np.testing.assert_array_equal(
        compress.decode_int4(packed, scale).numpy(), x.numpy())


def test_odd_head_dim_int4_raises():
    with pytest.raises(ValueError, match="even head_dim"):
        compress.quantize_kv(torch.zeros(2, 5), "int4")


def test_chunk_widths_past_the_entries_raise():
    q, k, v, table = _inputs(1, 8, seed=3)
    kt, vt, tt = (torch.from_numpy(x) for x in (k, v, table))
    idx = torch.from_numpy(INDEX)
    with pytest.raises(ValueError, match="prefill chunk 65"):
        pa.paged_prefill_attention(torch.zeros(B, 65, H, 8), kt, vt, tt, idx)
    with pytest.raises(ValueError, match="chunk width"):
        pa.paged_decode_attention_multi(torch.zeros(B, 9, H, 8), kt, vt, tt,
                                        idx)
    with pytest.raises(ValueError, match="needs k_scale"):
        pa.paged_decode_attention(torch.zeros(B, H, 8), kt, vt, tt, idx,
                                  quant="int8")


def test_cpu_tensors_count_no_launch():
    q, k, v, table = _inputs(16, 8, seed=4)
    entries = (pa.paged_decode_attention, pa.paged_decode_attention_multi,
               pa.paged_prefill_attention)
    before = [e.launches for e in entries]
    args = (torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(table),
            torch.from_numpy(INDEX))
    pa.paged_decode_attention(torch.from_numpy(q[:, 0]), *args)
    pa.paged_decode_attention_multi(torch.from_numpy(q[:, :5]), *args)
    pa.paged_prefill_attention(torch.from_numpy(q), *args)
    assert [e.launches for e in entries] == before


def test_kernel_checks_reject_what_it_cannot_take():
    """The CUDA wrapper's input checks, on meta tensors (no card needed):
    they raise before any launch."""
    meta = dict(device="meta")
    q = torch.empty(B, 5, H, 64, **meta)
    kv = torch.empty(N_BLOCKS, H, BS, 64, **meta)
    tbl = torch.empty(B, NB, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        pa._check(q, kv, kv, tbl, None, None, None, chunk_dims=1)
    before = pa.paged_decode_attention_multi.launches
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_decode_attention_multi(q, kv, kv, tbl, 0)
    assert pa.paged_decode_attention_multi.launches == before
    with pytest.raises(ValueError, match="prefill chunk"):
        pa.paged_prefill_attention(torch.empty(B, 65, H, 64, **meta), kv, kv,
                                   tbl, 0)
    with pytest.raises(ValueError, match="unknown kv quant"):
        pa.paged_decode_attention(q[:, 0], kv, kv, tbl, 0, quant="fp8",
                                  k_scale=kv, v_scale=kv)


def test_library_path_keyed_by_source_hash():
    from pytorch_distributed_training_tpu_torch.ops import _build

    assert "paged_attention.cu" in _build.SOURCES
    path = _build.library_path("paged_attention.cu")
    assert path.name.startswith("paged_attention-") and path.suffix == ".so"


# The kernel's split of the key span (flash-decoding), on the host: a
# test-local f32 reference cuts each row's keys into the partitions
# ``paged_split`` picks, computes each partition's (m, l, acc), and merges
# them in partition order as the combine kernel does.  Rows: a fresh row,
# mid-block, past the first partition, deep in the last, the idle
# sentinel, and a negative index whose first queries see no key.
SPLIT_BS, SPLIT_NB, SPLIT_BLOCKS = 8, 32, 40
SPLIT_SPAN = SPLIT_BS * SPLIT_NB
SPLIT_INDEX = np.asarray([0, 5, 70, 200, SPLIT_SPAN, -3], np.int32)
H100_SMS = 132


def _split_reference(q, k, v, table, index, part_keys, scale):
    """(B, C, H, Dh) f32: per-partition partials, then the fixed-order
    merge m = max m_i, l = sum e^(m_i - m) l_i, acc = sum e^(m_i - m)
    acc_i; a partition without a live key is (-1e30, 0, 0)."""
    b, c, h, dh = q.shape
    span = table.shape[1] * k.shape[2]
    kw = k[table].transpose(0, 2, 1, 3, 4).reshape(b, h, span, dh)
    vw = v[table].transpose(0, 2, 1, 3, 4).reshape(b, h, span, dh)
    last = index[:, None].astype(np.int64) + np.arange(c)[None, :]
    visible = np.arange(span)[None, None, :] <= last[:, :, None]
    s = np.einsum("bchd,bhkd->bhck", q, kw) * np.float32(scale)
    neg = np.float32(-1e30)
    parts = []
    for p0 in range(0, span, part_keys):
        cut = slice(p0, p0 + part_keys)
        live = visible[:, None, :, cut]
        sp = np.where(live, s[..., cut], neg)
        m = sp.max(-1)
        e = np.where(live, np.exp(sp - m[..., None]), np.float32(0))
        parts.append((m, e.sum(-1), np.einsum("bhck,bhkd->bhcd", e,
                                              vw[:, :, cut])))
    m = np.max([p[0] for p in parts], axis=0)
    l = np.zeros_like(m)
    acc = np.zeros_like(parts[0][2])
    for m_i, l_i, acc_i in parts:
        w = np.exp(m_i - m)
        l = l + w * l_i
        acc = acc + w[..., None] * acc_i
    out = acc / np.where(l == 0, np.float32(1), l)[..., None]
    return out.transpose(0, 2, 1, 3).astype(np.float32)


@pytest.mark.parametrize("c", [1, 5, 16])
def test_split_reference_matches_pallas_and_plain(c):
    rng = np.random.default_rng(40 + c)
    b, h, dh = len(SPLIT_INDEX), H, 16
    q = rng.standard_normal((b, c, h, dh)).astype(np.float32)
    k = rng.standard_normal((SPLIT_BLOCKS, h, SPLIT_BS, dh)).astype(np.float32)
    v = rng.standard_normal((SPLIT_BLOCKS, h, SPLIT_BS, dh)).astype(np.float32)
    table = np.stack([rng.permutation(SPLIT_BLOCKS)[:SPLIT_NB]
                      for _ in range(b)])
    table[0, 1:] = SPLIT_BLOCKS              # the fresh row's unallocated tail
    table = np.minimum(table, SPLIT_BLOCKS - 1).astype(np.int32)
    split = pa.paged_split(b, h, SPLIT_NB, SPLIT_BS, c, dh, H100_SMS)
    assert split.num_parts == 4 and split.part_keys == 64
    ref = _split_reference(q, k, v, table, SPLIT_INDEX, split.part_keys,
                           dh ** -0.5)
    # Partitions past a row's last visible key hold nothing for it.
    assert (SPLIT_INDEX[:2] + c - 1 < split.part_keys).all()
    pallas = np.asarray(_jax_entry(c)(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(table),
        jnp.asarray(SPLIT_INDEX), interpret=True,
    ))
    np.testing.assert_allclose(ref, pallas, atol=1e-5, rtol=0)
    plain = pa.paged_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(table),
        torch.from_numpy(SPLIT_INDEX)).numpy()
    # A query with no live key: 0 from the split and the Pallas kernel;
    # the gather path's softmax over -1e30 alone averages V instead, so
    # the plain version is compared on the queries that see a key.
    dead = SPLIT_INDEX[:, None] + np.arange(c)[None, :] < 0      # (B, C)
    assert dead.any() and (ref[dead] == 0).all() and (pallas[dead] == 0).all()
    np.testing.assert_allclose(ref[~dead], plain[~dead], atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,sms,want", [
    ((8, 12, 64, 16), H100_SMS, (6, 192)),     # serving: GPT-2 124M, 8 slots
    ((8, 12, 64, 16), 66, (4, 256)),           # a card with half the SMs
    ((8, 12, 1024, 16), H100_SMS, (64, 256)),  # the widest table: capped
    ((2, 2, 1024, 16), H100_SMS, (128, 128)),  # few rows: a 128-key tile a block
    ((8, 12, 4, 16), H100_SMS, (1, 64)),       # one partition
    ((1, 1, 1, 1), H100_SMS, (1, 64)),
    ((8, 12, 64, 24), H100_SMS, (6, 256)),     # a block size not dividing 64
])
def test_paged_split_picks_partitions_from_the_shapes(shape, sms, want):
    b, h, nb, bs = shape
    for c, dh in ((1, 64), (16, 64), (64, 40)):
        split = pa.paged_split(b, h, nb, bs, c, dh, sms)
        assert (split.num_parts, split.part_keys) == want
        span = nb * bs
        assert split.part_keys % pa.PART_ALIGN == 0
        assert (split.num_parts - 1) * split.part_keys < span
        assert split.num_parts * split.part_keys >= span
        assert split.scratch == b * h * split.num_parts * c * (dh + 2)
        assert split.part_keys <= pa.MAX_PART_KEYS
        if split.part_keys < pa.MAX_PART_KEYS and (
                split.num_parts < -(-span // pa.PART_ALIGN)):
            # Not every tile its own block: the grid comes within a factor
            # of 2 of the target (whole tiles a partition round it down).
            assert 2 * b * h * split.num_parts > pa.BLOCKS_PER_SM * sms
