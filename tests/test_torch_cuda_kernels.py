"""The port's CUDA kernels on a card (marked ``cuda``; they skip without
one: a CUDA kernel has no CPU mode).

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

Pinned: both decode-attention kernels against their plain PyTorch
versions at the serving shapes (f32 atol 1e-5: summation order; bf16
atol 2e-3, rtol 1e-2: an output one bf16 ulp off, about four times the
largest error of sound runs), a scalar
index, the launch counters, the wrapper's refusals, and a small GPT-2's
slot-mode logits on the card against the same weights on the host; the
cluster split forced to S = 1, 2, 4, 8 blocks at every C = 1..8, over rows
of 0, 1, 15, 16, 17 and L - 1 visible keys and the sentinel, a query
that sees no key (the mean of V over all L positions, as the TPU kernel
gives), the engine's strided cache view, L 8192 at C 8, a length past
the shared-memory limit (raises), a bit-identical repeat and the
wrapper's shared-memory count against the kernel's own layout.  The
paged kernels (#11 ``paged_decode_attention``, #12 behind
``paged_decode_attention_multi`` / ``paged_prefill_attention``) likewise,
through a shuffled block table, in every storage kind (f32, bf16, and
int8/int4 with bf16 q at atol/rtol 2e-2), and the small GPT-2 over the
paged and int8 paged pools; the split of the key span across blocks at
its edges (visible counts around the partition size, one partition and
many, block sizes 8, 16, 24, 32, head dims 40, 64, 128, C = 1..64),
queries with no live key (exactly 0) and a bit-identical repeat.  The
flash kernels (forward, dq and dk/dv passes) against their plain versions at the training shapes A-D of
``chip_smoke.py`` and at the edges of their tiling (ragged lengths, causal
q_len > k_len with rows that see no key: out exactly 0), on strided views
of one fused projection, f32 (out atol 2e-5, grads 2e-4) and bf16
(atol/rtol 2e-2: the rounding of p and ds to bf16), with their launch
counts, a bit-identical backward on repeat, an autograd pass through
``flash_attention`` and the wrapper's refusals.  The ResNet path runs no
kernel of its own, but its output-saving BatchNorm functions are held on
CUDA tensors against the host and the plain composition, and a shallow
f32 ResNet trains three steps like the host.  The ViT path likewise: a
2-layer ViT-B/16 (full width, 224 px) forward and backward on the card
against the host in f32 (TF32 off) under each attention layout, and a
``PackedImages`` uint8 batch moved to the card and scaled there.
"""

import pytest
import torch

from pytorch_distributed_training_tpu_torch.comm.compress import quantize_kv
from pytorch_distributed_training_tpu_torch.models import gpt2_124m
from pytorch_distributed_training_tpu_torch.ops import decode_attention as da
from pytorch_distributed_training_tpu_torch.ops import flash_attention as fa
from pytorch_distributed_training_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda
B, H, L, DH = 8, 12, 1024, 64
INDEX = [0, 5, 100, 511, 1000, 1023, 1024, 300]
BS, NB, NBLOCKS = 16, 64, 512
# The decode kernels in bf16 against their plain version: a sound run's
# largest error is one bf16 ulp of an output (4.9e-4 at the serving
# shapes), and an output one ulp off stays within rtol.
DECODE_BF16 = (torch.bfloat16, 2e-3, 1e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _cache(dev, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn(B, H, L, DH, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, H, L, DH, generator=gen, device=dev).to(dtype)
    return k, v, gen


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0),
                                             DECODE_BF16])
@pytest.mark.parametrize("c", [1, 2, 5, 8])
def test_kernel_matches_plain(dev, dtype, atol, rtol, c):
    k, v, gen = _cache(dev, dtype)
    index = torch.tensor(INDEX, dtype=torch.int32, device=dev)
    q = torch.randn(B, c, H, DH, generator=gen, device=dev).to(dtype)
    before = (da.decode_attention.launches, da.decode_attention_multi.launches)
    if c == 1:
        out = da.decode_attention(q[:, 0], k, v, index)[:, None]
    else:
        out = da.decode_attention_multi(q, k, v, index)
    after = (da.decode_attention.launches, da.decode_attention_multi.launches)
    assert after == (before[0] + (c == 1), before[1] + (c > 1))
    ref = da.decode_attention_multi_plain(q, k, v, index)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def test_scalar_index_and_strided_cache(dev):
    """Lockstep's scalar index, over a cache view that skips a trailing
    scratch position (the layout models/layers.py hands the kernel)."""
    k, v, gen = _cache(dev, torch.float32)
    q = torch.randn(B, H, DH, generator=gen, device=dev)
    out = da.decode_attention(q, k[:, :, :700], v[:, :, :700], 650)
    ref = da.decode_attention_plain(q, k[:, :, :700], v[:, :, :700], 650)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


# Query 0 of each row sees 0, 1, 15, 16, 17, L - 1 keys, the whole row
# (the idle sentinel), and 101 keys.
EDGE_INDEX = [-1, 0, 14, 15, 16, L - 2, L, 100]


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0),
                                             DECODE_BF16])
@pytest.mark.parametrize("c", range(1, 9))
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_cluster_split_matches_plain(dev, cluster, c, dtype, atol, rtol):
    """The wrappers' launch with S forced: every split of a row's keys
    (short, empty and full shares) gives the plain version's answer."""
    k, v, gen = _cache(dev, dtype, seed=c)
    q = torch.randn(B, c, H, DH, generator=gen, device=dev).to(dtype)
    for rows in (INDEX, EDGE_INDEX):
        index = torch.tensor(rows, dtype=torch.int32, device=dev)
        out = da._launch(q, k, v, index, DH ** -0.5, cluster=cluster)
        ref = da.decode_attention_multi_plain(q, k, v, index)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out.float()).all())
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0),
                                             DECODE_BF16])
@pytest.mark.parametrize("c", [1, 5])
def test_query_without_a_key_takes_the_mean_of_v(dev, dtype, atol, rtol, c):
    """index[b] + j < 0: the TPU kernel's scores are all -1e30 and its
    softmax uniform, so it returns the mean of V over all L positions;
    the kernel does the same (row 0 from -1, row 1 from -3)."""
    k, v, gen = _cache(dev, dtype, seed=7)
    q = torch.randn(B, c, H, DH, generator=gen, device=dev).to(dtype)
    index = torch.tensor([-1, -3] + INDEX[2:], dtype=torch.int32, device=dev)
    out = (da.decode_attention(q[:, 0], k, v, index)[:, None] if c == 1
           else da.decode_attention_multi(q, k, v, index))
    ref = da.decode_attention_multi_plain(q, k, v, index)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    mean_v = v.float().mean(dim=2)                     # (B, H, Dh)
    torch.testing.assert_close(out[0, 0].float(), mean_v[0], atol=atol,
                               rtol=rtol)
    for j in range(min(c, 3)):
        torch.testing.assert_close(out[1, j].float(), mean_v[1], atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_cache_view(dev, dtype):
    """The view models/layers.py hands the kernel: a (B, H, L + 1, Dh)
    cache cut to its first L positions (row stride L + 1 positions), at
    the verify chunk's C = 5."""
    gen = torch.Generator(device=dev).manual_seed(3)
    ck = torch.randn(B, H, L + 1, DH, generator=gen, device=dev).to(dtype)
    cv = torch.randn(B, H, L + 1, DH, generator=gen, device=dev).to(dtype)
    k, v = ck[:, :, :L], cv[:, :, :L]
    q = torch.randn(B, 5, H, DH, generator=gen, device=dev).to(dtype)
    index = torch.tensor(INDEX, dtype=torch.int32, device=dev)
    out = da.decode_attention_multi(q, k, v, index)
    ref = da.decode_attention_multi_plain(q, k, v, index)
    torch.cuda.synchronize()
    atol, rtol = (1e-5, 0.0) if dtype is torch.float32 else DECODE_BF16[1:]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0),
                                             DECODE_BF16])
def test_long_cache_runs(dev, dtype, atol, rtol):
    """L 8192 at C 8, which a whole row's scores in one block refused:
    shares of 1024 keys through a refilled ring."""
    b, h = 4, 12
    gen = torch.Generator(device=dev).manual_seed(11)
    k = torch.randn(b, h, 8192, DH, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, h, 8192, DH, generator=gen, device=dev).to(dtype)
    q = torch.randn(b, 8, h, DH, generator=gen, device=dev).to(dtype)
    index = torch.tensor([8184, 8192, 3000, 5], dtype=torch.int32, device=dev)
    out = da.decode_attention_multi(q, k, v, index)
    ref = da.decode_attention_multi_plain(q, k, v, index)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def test_cache_past_the_limit_raises(dev):
    length = 34_960   # 8 shares of 4384 keys at C 8: past 232,448 bytes
    k = torch.zeros(1, 1, length, DH, device=dev, dtype=torch.bfloat16)
    q = torch.zeros(1, 8, 1, DH, device=dev, dtype=torch.bfloat16)
    before = da.decode_attention_multi.launches
    with pytest.raises(ValueError, match="shared memory"):
        da.decode_attention_multi(q, k, k, 0)
    assert da.decode_attention_multi.launches == before
    out = da.decode_attention_multi(q, k[:, :, :34_944], k[:, :, :34_944], 0)
    torch.cuda.synchronize()
    assert bool((out == 0).all())


@pytest.mark.parametrize("cluster", [None, 8])
@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 1), (torch.bfloat16, 8),
                                     (torch.float32, 5)])
def test_kernel_is_deterministic(dev, dtype, c, cluster):
    """Every sum has a fixed order: a repeated call gives the same bits."""
    k, v, gen = _cache(dev, dtype, seed=9)
    q = torch.randn(B, c, H, DH, generator=gen, device=dev).to(dtype)
    index = torch.tensor(INDEX, dtype=torch.int32, device=dev)
    first = da._launch(q, k, v, index, DH ** -0.5, cluster=cluster)
    second = da._launch(q, k, v, index, DH ** -0.5, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_layout_matches_the_kernel(dev, dtype):
    """The shared memory decode_split counts is what the kernel lays out
    (a plan raises where the two differ): at the serving shapes, a tiny
    cache and L 8192, for every C, with S chosen and forced; a forced S
    whose share does not fit raises before the library is asked."""
    scale = DH ** -0.5
    for b, length in ((B, L), (2, 40), (4, 8192)):
        k_shape = (b, H, length, DH)
        k_strides = (H * length * DH, length * DH, DH, 1)
        for c in range(1, 9):
            q_shape = (b, c, H, DH)
            q_strides = (c * H * DH, H * DH, DH, 1)
            for cluster in (None, 1, 2, 4, 8):
                split = (da.decode_split(b, H, length, c, DH,
                                         da.sm_count(dev), dtype.itemsize)
                         if cluster is None else
                         da.decode_layout(cluster, length, c, DH,
                                          dtype.itemsize))
                args = (dtype, q_shape, q_strides, k_shape, k_strides,
                        k_strides, scale, cluster, dev)
                if split.smem_bytes > da.MAX_SMEM:
                    with pytest.raises(ValueError, match="shared memory"):
                        da._plan(*args)
                else:
                    assert da._plan(*args)


def test_kernel_refuses_what_it_cannot_take(dev):
    k, v, gen = _cache(dev, torch.float32)
    q = torch.randn(B, H, DH, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        da.decode_attention(q.half(), k.half(), v.half(), 3)
    with pytest.raises(ValueError, match="dtypes differ"):
        da.decode_attention(q, k.bfloat16(), v.bfloat16(), 3)
    with pytest.raises(ValueError, match="contiguous last dim"):
        da.decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                            v, 3)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention(q[..., :60], k[..., :60], v[..., :60], 3)
    with pytest.raises(ValueError, match="does not match"):
        da.decode_attention(q[:, :6], k, v, 3)


def test_small_gpt2_slot_logits_match_host(dev):
    """Prefill chunk (plain ragged path), decode tick and verify chunk
    (both kernels) with an idle sentinel row, f32, card vs host."""
    torch.backends.cuda.matmul.allow_tf32 = False
    small = dict(num_layers=2, hidden_dim=64, num_heads=2, vocab_size=256,
                 max_seq_len=64)
    host = gpt2_124m(small, device="cpu", seed=1).eval()
    card = gpt2_124m(small, device="cpu", seed=1).to(dev).eval()
    caches = host.new_cache(3, 48), card.new_cache(3, 48)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for width, pos in ((12, [0, 5, 48]), (1, [12, 17, 48]),
                           (5, [13, 18, 48])):
            tok = torch.randint(0, 256, (3, width), generator=gen)
            p = torch.tensor(pos, dtype=torch.int32)
            ref = host(tok, cache=caches[0], positions=p)
            out = card(tok.to(dev), cache=caches[1], positions=p.to(dev))
            torch.testing.assert_close(out.cpu()[:2], ref[:2], atol=1e-3,
                                       rtol=0)


def _paged_pool(dev, storage, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn(NBLOCKS + 1, H, BS, DH, generator=gen, device=dev)
    v = torch.randn(NBLOCKS + 1, H, BS, DH, generator=gen, device=dev)
    perm = torch.randperm(NBLOCKS, generator=torch.Generator().manual_seed(3))
    table = perm[:B * NB].view(B, NB).to(torch.int32)
    table[6, NB // 2:] = NBLOCKS
    table = table.clamp(max=NBLOCKS - 1).to(dev)
    if storage in ("int8", "int4"):
        kq, ks = quantize_kv(k, storage)
        vq, vs = quantize_kv(v, storage)
        return kq, vq, table, dict(k_scale=ks, v_scale=vs, quant=storage), gen
    dtype = torch.float32 if storage == "f32" else torch.bfloat16
    return k.to(dtype), v.to(dtype), table, {}, gen


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("c", [1, 5, 8, 16, 64])
def test_paged_kernel_matches_plain(dev, storage, c):
    kb, vb, table, kw, gen = _paged_pool(dev, storage)
    dtype = torch.float32 if storage == "f32" else torch.bfloat16
    index = torch.tensor(INDEX, dtype=torch.int32, device=dev)
    q = torch.randn(B, c, H, DH, generator=gen, device=dev).to(dtype)
    entry = (pa.paged_decode_attention if c == 1
             else pa.paged_decode_attention_multi if c <= 8
             else pa.paged_prefill_attention)
    before = entry.launches
    if c == 1:
        out = entry(q[:, 0], kb, vb, table, index, **kw)[:, None]
    else:
        out = entry(q, kb, vb, table, index, **kw)
    assert entry.launches == before + 1
    ref = pa.paged_attention_plain(q, kb, vb, table, index, **kw)
    torch.cuda.synchronize()
    atol, rtol = (1e-5, 0.0) if storage == "f32" else (2e-2, 2e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def test_paged_kernel_refuses_what_it_cannot_take(dev):
    kb, vb, table, _, gen = _paged_pool(dev, "f32")
    q = torch.randn(B, H, DH, generator=gen, device=dev)
    with pytest.raises(ValueError, match="blocks must be"):
        pa.paged_decode_attention(q, kb.bfloat16(), vb.bfloat16(), table, 3)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_decode_attention(q, kb, vb, table.long(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_attention(q[..., :32], kb[..., :32], vb[..., :32],
                                  table, 3)


# The split kernel's edges: (rows, heads, table width, block size, head
# dim).  One partition and many (width 1024), block sizes that do and do
# not divide the 64-key stage, head dims 64, 128 and 40 (8 mod 16).
SPLIT_SHAPES = {
    "serving": (8, 12, 64, 16, 64),
    "bs8": (8, 4, 64, 8, 64),
    "bs24 dh40": (8, 4, 40, 24, 40),
    "bs32 dh128": (8, 4, 32, 32, 128),
    "one partition": (8, 12, 4, 16, 64),
    "width 1024": (8, 2, 1024, 16, 64),
}


def _split_case(dev, shape, storage, c, seed=5):
    """A pool, table and index around the partition edges of ``shape``:
    row r's first query sees 1, P - 1, P, P + 1 keys, the full span, the
    whole span as the idle sentinel, a fresh row's 4 keys (its table tail
    unallocated), and half the span."""
    b, h, nb, bs, dh = SPLIT_SHAPES[shape]
    span = nb * bs
    part = pa.paged_split(b, h, nb, bs, c, dh, pa.sm_count(dev)).part_keys
    n_blocks = b * nb
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn(n_blocks + 1, h, bs, dh, generator=gen, device=dev)
    v = torch.randn(n_blocks + 1, h, bs, dh, generator=gen, device=dev)
    perm = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(seed))
    table = perm.view(b, nb).to(torch.int32)
    table[5, nb // 2:] = n_blocks
    table[6, 1:] = n_blocks
    table = table.clamp(max=n_blocks - 1).to(dev)
    index = torch.tensor([0, part - 2, part - 1, part, span - 1, span, 3,
                          span // 2], dtype=torch.int32, device=dev)
    dtype = torch.float32 if storage == "f32" else torch.bfloat16
    q = torch.randn(b, c, h, dh, generator=gen, device=dev).to(dtype)
    if storage in ("int8", "int4"):
        kq, ks = quantize_kv(k, storage)
        vq, vs = quantize_kv(v, storage)
        return q, kq, vq, table, index, dict(k_scale=ks, v_scale=vs,
                                             quant=storage)
    return q, k.to(dtype), v.to(dtype), table, index, {}


def _paged_call(q, kb, vb, table, index, kw):
    c = q.shape[1]
    if c == 1:
        return pa.paged_decode_attention(q[:, 0], kb, vb, table, index,
                                         **kw)[:, None]
    entry = (pa.paged_decode_attention_multi if c <= 8
             else pa.paged_prefill_attention)
    return entry(q, kb, vb, table, index, **kw)


def _plain_f64(q, kb, vb, table, index):
    """The plain version's math in float64 (f32 storage).  At width 1024
    the sentinel row's f32 sums run over 16384 keys and carry errors near
    1e-5 of their own, so the f32 kernel is held to this exact-rounding
    reference at f32's atol 1e-5 instead."""
    kk, vv = pa.paged_window(kb, vb, table)
    c, dh = q.shape[1], q.shape[-1]
    s = torch.einsum("bchd,bhld->bhcl", q.double(), kk.double()) * dh ** -0.5
    cols = torch.arange(kk.shape[2], device=q.device)
    last = index[:, None].long() + torch.arange(c, device=q.device)[None, :]
    visible = cols[None, None, :] <= last[:, :, None]
    s = s.masked_fill(~visible[:, None], -1e30)
    return torch.einsum("bhcl,bhld->bchd", torch.softmax(s, -1), vv.double())


@pytest.mark.parametrize("c", [1, 5, 8, 16, 64])
@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("shape", sorted(SPLIT_SHAPES))
def test_paged_split_kernel_matches_plain(dev, shape, storage, c):
    q, kb, vb, table, index, kw = _split_case(dev, shape, storage, c)
    entry = (pa.paged_decode_attention if c == 1
             else pa.paged_decode_attention_multi if c <= 8
             else pa.paged_prefill_attention)
    before = entry.launches
    out = _paged_call(q, kb, vb, table, index, kw)
    assert entry.launches == before + 1   # one count a call, split or not
    if storage == "f32" and shape == "width 1024":
        ref = _plain_f64(q, kb, vb, table, index)
    else:
        ref = pa.paged_attention_plain(q, kb, vb, table, index, **kw)
    torch.cuda.synchronize()
    atol, rtol = (1e-5, 0.0) if storage == "f32" else (2e-2, 2e-2)
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("shape", ["serving", "one partition"])
@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_paged_query_without_a_live_key_is_zero(dev, shape, storage):
    """Negative indices: queries before position 0 see no key and give
    exactly 0 (as the TPU kernel does), a whole row of them (row 2) and
    the first three of row 3; the rest match the plain version."""
    q, kb, vb, table, index, kw = _split_case(dev, shape, storage, 5)
    index[2] = -7
    index[3] = -3
    out = _paged_call(q, kb, vb, table, index, kw)
    ref = pa.paged_attention_plain(q, kb, vb, table, index, **kw)
    torch.cuda.synchronize()
    keep = torch.ones(out.shape[:2], dtype=torch.bool, device=dev)
    keep[2] = False
    keep[3, :3] = False
    assert bool((out[~keep] == 0).all())
    atol, rtol = (1e-5, 0.0) if storage == "f32" else (2e-2, 2e-2)
    torch.testing.assert_close(out[keep].float(), ref[keep].float(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("storage,c", [("bf16", 1), ("bf16", 16),
                                       ("bf16", 64), ("int8", 1),
                                       ("int4", 5)])
@pytest.mark.parametrize("shape", ["serving", "width 1024"])
def test_paged_kernel_is_deterministic(dev, shape, storage, c):
    """The partials merge in a fixed order: a repeated call gives the
    same bits."""
    q, kb, vb, table, index, kw = _split_case(dev, shape, storage, c)
    first = _paged_call(q, kb, vb, table, index, kw)
    second = _paged_call(q, kb, vb, table, index, kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_small_gpt2_paged_logits_match_host(dev, kv_quant):
    """Prefill chunk (#12), decode tick (#11) and verify chunk (#12) over
    the paged pool, with an idle sentinel row, f32, card vs host."""
    torch.backends.cuda.matmul.allow_tf32 = False
    small = dict(num_layers=2, hidden_dim=64, num_heads=2, vocab_size=256,
                 max_seq_len=64)
    host = gpt2_124m(small, device="cpu", seed=1).eval()
    card = gpt2_124m(small, device="cpu", seed=1).to(dev).eval()
    caches = (host.new_block_cache(40, 4, kv_quant),
              card.new_block_cache(40, 4, kv_quant))
    table = torch.tensor([list(range(12)), list(range(23, 11, -1)),
                          [40] * 12], dtype=torch.int32)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for width, pos in ((12, [0, 5, 48]), (1, [12, 17, 48]),
                           (5, [13, 18, 48])):
            tok = torch.randint(0, 256, (3, width), generator=gen)
            p = torch.tensor(pos, dtype=torch.int32)
            ref = host(tok, cache=caches[0], positions=p, block_table=table)
            out = card(tok.to(dev), cache=caches[1], positions=p.to(dev),
                       block_table=table.to(dev))
            torch.testing.assert_close(out.cpu()[:2], ref[:2], atol=1e-3,
                                       rtol=0)


# Flash cases: (batch, q_len, k_len, heads, causal).  The training shapes
# A-D of chip_smoke.py, then the edges of the kernels' tiling: ragged
# lengths (causal L 1000, non-causal L 197, causal q 100 over k 1000) and a
# causal q_len > k_len whose first rows see no key.
FLASH_SHAPES = {"A": (16, 512, 512, 12, True), "B": (8, 1024, 1024, 12, True),
                "C": (2, 1024, 1024, 25, True), "D": (2, 2048, 2048, 12, True),
                "L1000": (2, 1000, 1000, 4, True),
                "L197 non-causal": (4, 197, 197, 4, False),
                "q100 k1000": (2, 100, 1000, 4, True),
                "q300 k100": (2, 300, 100, 4, True)}


def _flash_inputs(dev, b, q_len, k_len, h, dtype, seed=4):
    """q, k, v as the model hands them over: strided views cut from one
    fused (B, L, 3, H, 64) projection (q apart and k/v from one (B, Lk, 2,
    H, 64) tensor when the lengths differ), and a seeded dO."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    if q_len == k_len:
        q, k, v = rnd(b, q_len, 3, h, DH).unbind(2)
    else:
        q = rnd(b, q_len, h, DH)
        k, v = rnd(b, k_len, 2, h, DH).unbind(2)
    return q, k, v, rnd(b, q_len, h, DH)


def _flash_all(q, k, v, do, causal):
    out, lse = fa.flash_fwd(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    return out, lse, delta, (dq, dk, dv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_kernels_match_plain(dev, shape, dtype):
    b, q_len, k_len, h, causal = FLASH_SHAPES[shape]
    q, k, v, do = _flash_inputs(dev, b, q_len, k_len, h, dtype)
    assert q_len != k_len or q.stride(1) == 3 * h * DH  # fused views
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    out, lse, delta, grads = _flash_all(q, k, v, do, causal)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal, DH ** -0.5)
    refs = fa.flash_bwd_plain(q, k, v, do, ref_lse, delta, causal,
                              DH ** -0.5)
    torch.cuda.synchronize()
    f32 = dtype is torch.float32
    tol = dict(atol=2e-5, rtol=0) if f32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), ref_out.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, **tol)
    gtol = dict(atol=2e-4, rtol=0) if f32 else tol
    for got, ref in zip(grads, refs):
        assert bool(torch.isfinite(got.float()).all())
        torch.testing.assert_close(got.float(), ref.float(), **gtol)
    if causal and q_len > k_len:   # rows with no live key: out exactly 0
        dead = q_len - k_len
        assert bool((out[:, :dead] == 0).all())
        assert bool((lse[:, :, :dead] == fa._NEG_INF).all())
        assert bool((grads[0][:, :dead] == 0).all())


@pytest.mark.parametrize("shape", ["B", "q300 k100"])
def test_flash_backward_is_deterministic(dev, shape):
    """The split backward has no atomics: a second run gives the same
    bits for dq, dk and dv (and the forward for out and LSE)."""
    b, q_len, k_len, h, causal = FLASH_SHAPES[shape]
    q, k, v, do = _flash_inputs(dev, b, q_len, k_len, h, torch.bfloat16)
    first = _flash_all(q, k, v, do, causal)
    second = _flash_all(q, k, v, do, causal)
    torch.cuda.synchronize()
    for a, c in zip(first[:2] + first[3], second[:2] + second[3]):
        assert torch.equal(a, c)


def test_flash_autograd_cross_length(dev):
    """The autograd Function on the card: causal q 256 over k 1024, f32,
    against autograd through the plain path on the host."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(2, 256, 4, DH, generator=gen)
    k = torch.randn(2, 1024, 4, DH, generator=gen)
    v = torch.randn(2, 1024, 4, DH, generator=gen)
    host = [t.clone().requires_grad_() for t in (q, k, v)]
    card = [t.to(dev).requires_grad_() for t in (q, k, v)]
    outs = [fa.flash_attention(*ts, causal=True) for ts in (host, card)]
    grads = [torch.autograd.grad((o ** 2).sum(), ts)
             for o, ts in zip(outs, (host, card))]
    torch.testing.assert_close(outs[1].cpu(), outs[0], atol=2e-5, rtol=0)
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a.cpu(), b, atol=2e-4, rtol=0)


def test_flash_refuses_what_it_cannot_take(dev):
    q = torch.randn(1, 128, 2, DH, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q[..., :32], q[..., :32], q[..., :32])
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous last dim"):
        t = q.transpose(-1, -2).contiguous().transpose(-1, -2)
        fa.flash_fwd(t, t, t)


# --- the ResNet path's BatchNorm functions on the card ----------------------

@pytest.mark.parametrize("name", ["batch_norm", "bn_relu", "bn_add_relu"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_bn_functions_on_the_card_match_the_host(dev, name, dtype, atol):
    """The output-saving BatchNorm functions on CUDA tensors: outputs,
    statistics and grads against the same call on the host (f32 atol
    1e-5: summation order; bf16 2e-2: a bf16 ulp of outputs near 4), and
    in f32 against autograd of the plain composition on the card."""
    import torch.nn.functional as F

    from pytorch_distributed_training_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(16, 32, 14, 14, generator=gen) * 2 + 0.5).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    r = torch.randn(16, 32, 14, 14, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last)
    g = torch.rand(32, generator=gen) + 0.5
    b = torch.randn(32, generator=gen)
    dy = torch.randn(16, 32, 14, 14, generator=gen).to(dtype)

    def run(where, plain=False):
        xt, rt = x.to(where).requires_grad_(), r.to(where).requires_grad_()
        gt, bt = g.to(where).requires_grad_(), b.to(where).requires_grad_()
        if plain:
            m = fn.BatchNorm(32, device=where)
            stats: dict = {}
            y = torch.func.functional_call(m, {"scale": gt, "bias": bt},
                                           (xt, stats))
            y = {"batch_norm": y, "bn_relu": F.relu(y),
                 "bn_add_relu": F.relu(y + rt)}[name]
            mean = stats["mean"] / 0.1
        elif name == "bn_add_relu":
            y, mean, _ = fn.bn_add_relu(xt, rt, gt, bt)
        else:
            y, mean, _ = getattr(fn, name)(xt, gt, bt)
        grads = torch.autograd.grad(y, (xt, rt, gt, bt), dy.to(where),
                                    allow_unused=True)
        return [t.float().cpu() for t in (y, mean, *grads) if t is not None]

    card, host = run(dev), run("cpu")
    for a, e in zip(card, host):
        torch.testing.assert_close(a, e, atol=atol, rtol=atol)
    if dtype == torch.float32:
        for a, e in zip(card, run(dev, plain=True)):
            torch.testing.assert_close(a, e, atol=1e-4, rtol=1e-4)


def test_small_resnet_trains_like_the_host(dev):
    """Three f32 sgd steps of a shallow ResNet (fused norms, the CIFAR
    stem) on the card with TF32 off and on the host from the same
    weights: losses, weights and running statistics within 1e-4.  No max
    pool: its argmax is discontinuous, and a near-tie tipped the other
    way by the card's rounding is amplified by the steps (``chip_smoke.py``
    R4 checks the pool's tie positions directly)."""
    import copy

    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer,
    )
    from pytorch_distributed_training_tpu_torch.models import resnet
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, make_train_step,
    )

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        host = resnet.resnet18(10, {"stage_sizes": (1, 1),
                                    "small_stem": True}, device="cpu",
                               seed=1)
        models = {"cpu": host, "cuda": copy.deepcopy(host).to(dev)}
        gen = torch.Generator().manual_seed(1)
        batches = [(torch.rand(32, 32, 32, 3, generator=gen),
                    torch.randint(0, 10, (32,), generator=gen))
                   for _ in range(3)]
        out = {}
        for where, model in models.items():
            policy = make_policy("f32")
            state = create_train_state(
                model, build_optimizer("sgd", 0.05, weight_decay=1e-3),
                policy=policy)
            step = make_train_step(kind="image_classifier", policy=policy,
                                   num_microbatches=2)
            losses = []
            for x, y in batches:
                state, m = step(state, {"image": x.to(where),
                                        "label": y.to(where)})
                losses.append(float(m["loss"]))
            out[where] = (losses, {k: v.detach().cpu() for k, v in {
                **state.params, **state.batch_stats}.items()})
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    torch.testing.assert_close(torch.tensor(out["cuda"][0]),
                               torch.tensor(out["cpu"][0]), atol=1e-4,
                               rtol=0)
    for k, v in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], v, atol=1e-4, rtol=0,
                                   msg=k)


@pytest.mark.parametrize("layout", ["bhld2", "bhld", "auto"])
def test_vit_forward_backward_like_the_host(dev, layout):
    """ViT-B/16 at full width cut to 2 layers, 224 px, f32 with TF32 off:
    logits and every parameter's gradient on the card against the host
    from the same weights.  ``auto`` at L 197 takes the plain attention
    path on both."""
    import copy

    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.ops.losses import (
        cross_entropy_loss,
    )

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        host = create_model("vit_b16", device="cpu", seed=2, image_size=224,
                            cfg_overrides={"depth": 2,
                                           "attn_layout": layout})
        card = copy.deepcopy(host).to(dev)
        gen = torch.Generator().manual_seed(2)
        x = torch.rand(4, 224, 224, 3, generator=gen)
        y = torch.randint(0, 1000, (4,), generator=gen)
        out = {}
        for where, model in (("cpu", host), ("cuda", card)):
            logits = model(x.to(where).permute(0, 3, 1, 2))
            loss = cross_entropy_loss(logits, y.to(where))
            grads = torch.autograd.grad(loss, list(model.parameters()))
            out[where] = (logits.detach().cpu(), [g.cpu() for g in grads])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-4,
                               rtol=0)
    names = [n for n, _ in host.named_parameters()]
    for n, a, b in zip(names, out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, msg=n)


def test_packed_uint8_batch_on_the_card(dev, tmp_path):
    """A packed uint8 batch (native crop) goes to the card and is scaled
    and normalized there as on the host."""
    from pytorch_distributed_training_tpu_torch.data import (
        PackedImages, synthesize_packed_images,
    )
    from pytorch_distributed_training_tpu_torch.data.loader import to_device
    from pytorch_distributed_training_tpu_torch.train import make_policy
    from pytorch_distributed_training_tpu_torch.train.step import (
        prepare_image_input,
    )

    path = str(tmp_path / "p.pck")
    synthesize_packed_images(path, n=16, size=232, num_classes=1000)
    ds = PackedImages(path, crop_size=224, output_dtype="uint8")
    batch = ds.get_batch(list(range(16)))
    on_card = to_device(batch, dev)
    assert on_card["image"].dtype == torch.uint8 and on_card["image"].is_cuda
    assert torch.equal(on_card["image"].cpu(),
                       torch.from_numpy(batch["image"]))
    policy = make_policy("f32")
    norm = (ds.mean, ds.std)
    card = prepare_image_input(on_card["image"], policy, norm)
    host = prepare_image_input(torch.from_numpy(batch["image"]), policy,
                               norm)
    assert card.shape == (16, 3, 224, 224)
    torch.testing.assert_close(card.cpu(), host, atol=1e-6, rtol=0)
