"""The sharded paths' card-side pieces (marked ``cuda``; they skip without
a card: what they pin is arithmetic on CUDA tensors).

This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_parallel.py -m cuda --noconftest

Pinned: the flash kernels at the heads a rank holds under tensor
parallelism and Ulysses (H 6 and H 3 at L 1024, causal, bf16) against
their plain versions; ring attention's per-hop fold, two shards of K/V
folded on the card, against the plain attention of the whole sequence,
causal and not; a placement's shard and unshard of a by-head QKV weight
on the card bitwise the host's.
"""

import pytest
import torch

from pytorch_distributed_training_tpu_torch.ops import flash_attention as fa
from pytorch_distributed_training_tpu_torch.ops.attention import (
    _xla_attention,
)
from pytorch_distributed_training_tpu_torch.parallel.ring_attention import (
    _hop,
)
from pytorch_distributed_training_tpu_torch.parallel.sharded import Placement

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels under test run on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.parametrize("batch,heads", [(4, 6), (8, 3)])
def test_flash_at_a_ranks_heads(dev, batch, heads):
    gen = torch.Generator(device=dev).manual_seed(heads)
    q, k, v, do = (torch.randn(batch, 1024, heads, 64, generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(4))
    scale = 64 ** -0.5
    out, lse = fa.flash_fwd(q, k, v, causal=True, scale=scale)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    grads = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True,
                             scale=scale),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True,
                               scale=scale))
    ref_grads = fa.flash_bwd_plain(q, k, v, do, ref_lse, delta, True, scale)
    for got, ref in ((out, ref_out), (lse, ref_lse), *zip(grads, ref_grads)):
        err = (got.float() - ref.float()).abs()
        assert bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all())


@pytest.mark.parametrize("causal", [False, True])
def test_ring_fold_of_two_shards_is_full_attention(dev, causal):
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(2, 32, 4, 16, generator=gen, device=dev)
               for _ in range(3))
    scale = 16 ** -0.5
    want = _xla_attention(q, k, v, causal=causal)
    for rank in range(2):
        qs = q[:, rank * 16:(rank + 1) * 16]
        o = torch.zeros_like(qs)
        m = torch.full((2, 4, 16), -1e30, device=dev)
        lsum = torch.zeros((2, 4, 16), device=dev)
        for hop in range(2):
            src = (rank + hop) % 2
            o, m, lsum = _hop(
                qs, k[:, src * 16:(src + 1) * 16], v[:, src * 16:
                                                    (src + 1) * 16],
                o, m, lsum, rank * 16, src * 16, causal, scale)
        got = o / lsum.transpose(1, 2)[..., None]
        torch.testing.assert_close(got, want[:, rank * 16:(rank + 1) * 16],
                                   atol=2e-5, rtol=0)


def test_by_head_placement_on_the_card(dev):
    host = torch.randn(3 * 64, 64)
    p = Placement((192, 64), 0, ("tensor",), 4, 2, blocks=3)
    assert torch.equal(p.shard(host.to(dev)).cpu(), p.shard(host))
    gathered = torch.cat([p.shard(host.to(dev), i) for i in range(4)])
    assert torch.equal(p.unshard(gathered).cpu(), host)
