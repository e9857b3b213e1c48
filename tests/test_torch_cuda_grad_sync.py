"""The two-tier gradient sync's codecs and bucket layout on a card (marked
``cuda``; they skip without one: what they pin is the card's side of the
codec arithmetic).

This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_grad_sync.py -m cuda --noconftest

Pinned: int8, int4 and top-k payloads and their decodes on CUDA tensors
are bitwise the host's (seeded rows, a row of magnitude ties, a zero
tail, several fractions, 256 rows of spread scales); the bf16 payload's
int16 view is the host's; ``_BucketLayout`` flattens CUDA gradients
into buckets on the card bitwise the host's and unflattens them back to
the same tensors.
"""

import pytest
import torch

from pytorch_distributed_training_tpu_torch.comm import compress as cc
from pytorch_distributed_training_tpu_torch.models import create_model

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the codecs under test run on the "
                    "card")
    return torch.device("cuda")


def _rows(seed: int = 0) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((6, 1024), generator=gen) * 1e-2
    x[1] = torch.round(x[1] * 1e3) / 1e3          # magnitude ties
    x[2, 300:] = 0.0                              # a padded tail
    x[3] = torch.tensor([1.0, -1.0, 0.5, -0.5]).repeat(256)
    return x


def _same(a, b) -> bool:
    return all(torch.equal(x.cpu(), y) for x, y in zip(a, b))


@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_scaled_codecs_on_the_card_are_the_hosts(dev, codec):
    x = _rows()
    enc, dec = (getattr(cc, f"encode_{codec}"), getattr(cc, f"decode_{codec}"))
    on_card, on_host = enc(x.to(dev)), enc(x)
    assert _same(on_card, on_host)
    assert torch.equal(dec(*on_card).cpu(), dec(*on_host))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.25, 1.0])
def test_topk_on_the_card_is_the_hosts(dev, frac):
    x = _rows(1)
    on_card, on_host = cc.encode_topk(x.to(dev), frac), cc.encode_topk(x,
                                                                       frac)
    assert _same(on_card, on_host)
    assert torch.equal(cc.decode_topk(*on_card, 1024).cpu(),
                       cc.decode_topk(*on_host, 1024))


@pytest.mark.parametrize("codec", ["int8", "int4", "topk"])
def test_many_row_scales_on_the_card_are_the_hosts(dev, codec):
    """256 rows of spread magnitudes: a scale computed as a product with
    1/qmax instead of the quotient would differ in about one row of 20."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((256, 512), generator=gen) * torch.rand(
        (256, 1), generator=gen) * 10
    enc = (lambda t: cc.encode_topk(t, 0.1)) if codec == "topk" else \
        getattr(cc, f"encode_{codec}")
    assert _same(enc(x.to(dev)), enc(x))


def test_bf16_payload_view_on_the_card_is_the_hosts(dev):
    x = _rows(2)
    assert torch.equal(x.to(dev).to(torch.bfloat16).view(torch.int16).cpu(),
                       x.to(torch.bfloat16).view(torch.int16))


def test_bucket_layout_on_cuda_tensors(dev):
    model = create_model("gpt2", device="cpu", seed=0, cfg_overrides=dict(
        num_layers=2, hidden_dim=64, num_heads=2, vocab_size=256,
        max_seq_len=64))
    params = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(3)
    grads = {n: torch.randn(p.shape, generator=gen) for n, p in
             params.items()}
    layout = cc._BucketLayout.build(params, bucket_mb=0.05, divisor=32)
    assert layout.n_buckets > 1
    on_card = layout.flatten({n: g.to(dev) for n, g in grads.items()})
    assert on_card.is_cuda
    assert torch.equal(on_card.cpu(), layout.flatten(grads))
    back = layout.unflatten(on_card)
    assert list(back) == list(params)
    for n, g in grads.items():
        assert back[n].is_cuda and torch.equal(back[n].cpu(), g)
