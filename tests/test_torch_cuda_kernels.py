"""The port's CUDA kernels on a card (marked ``cuda``; they skip without
one: a CUDA kernel has no CPU mode).

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

Pinned: both decode-attention kernels against their plain PyTorch
versions at the serving shapes (f32 atol 1e-5: summation order; bf16
atol/rtol 2e-2: one bf16 rounding of p and of the output), a scalar
index, the launch counters, the wrapper's refusals, and a small GPT-2's
slot-mode logits on the card against the same weights on the host.  The
paged kernels (#11 ``paged_decode_attention``, #12 behind
``paged_decode_attention_multi`` / ``paged_prefill_attention``) likewise,
through a shuffled block table, in every storage kind (f32, bf16, and
int8/int4 with bf16 q at atol/rtol 2e-2), and the small GPT-2 over the
paged and int8 paged pools.
"""

import pytest
import torch

from pytorch_distributed_training_tpu_torch.comm.compress import quantize_kv
from pytorch_distributed_training_tpu_torch.models import gpt2_124m
from pytorch_distributed_training_tpu_torch.ops import decode_attention as da
from pytorch_distributed_training_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda
B, H, L, DH = 8, 12, 1024, 64
INDEX = [0, 5, 100, 511, 1000, 1023, 1024, 300]
BS, NB, NBLOCKS = 16, 64, 512


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
                                             (torch.bfloat16, 2e-2, 2e-2)])
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
