"""The MoE layers on the card (marked ``cuda``; they skip without a card:
what they pin is the routing, the dispatch and the experts on CUDA
tensors).

This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_moe.py -m cuda --noconftest

- ``MoeMlp`` in scatter and einsum mode on the card, f32 with TF32 off,
  at a capacity that drops tokens: the same outputs (atol 1e-5), aux
  loss, drop rate and gradients (atol 1e-4), and the host's.
- A tiny MoE GPT-2 (2 layers, width 32, 2 heads, vocab 128, E 4) takes
  three adamw steps on the card and on the host from the same weights:
  losses within rtol 1e-5, drop rates equal, weights within 2e-5 (the
  key third of each qkv bias within Adam's lr, its gradient being
  rounding noise).
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu_torch.models import create_model
from pytorch_distributed_training_tpu_torch.models.moe import MoeMlp
from pytorch_distributed_training_tpu_torch.train import (
    create_train_state, make_train_step, optim,
)

pytestmark = pytest.mark.cuda

TINY = dict(num_layers=2, hidden_dim=32, num_heads=2, vocab_size=128,
            max_seq_len=16, num_experts=4)
LR = 1e-3


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the layers under test run on the "
                    "card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _layer(mode: str, device: str) -> MoeMlp:
    torch.manual_seed(0)
    layer = MoeMlp(24, 4, 32, capacity_factor=0.5, dispatch_mode=mode,
                   device="cpu")
    layer.init_experts(torch.Generator().manual_seed(1))
    return layer.to(device)


def _run(mode: str, device: str, x: np.ndarray):
    layer = _layer(mode, device)
    out, aux, drop = layer(torch.from_numpy(x).to(device))
    (out ** 2).sum().backward()
    return (out.detach().cpu().numpy(), float(aux.detach()), float(drop),
            {n: p.grad.cpu().numpy() for n, p in layer.named_parameters()})


def test_scatter_equals_einsum_on_the_card_and_the_host():
    x = np.random.default_rng(7).standard_normal((2, 16, 24)).astype(
        np.float32)
    ref = _run("einsum", "cpu", x)
    assert ref[2] > 0
    for mode in ("einsum", "scatter"):
        got = _run(mode, "cuda", x)
        np.testing.assert_allclose(got[0], ref[0], atol=1e-5, err_msg=mode)
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-6, err_msg=mode)
        assert got[2] == ref[2]
        for n, g in ref[3].items():
            np.testing.assert_allclose(got[3][n], g, atol=1e-4,
                                       err_msg=f"{mode} {n}")


def _steps(device: str, batches: np.ndarray):
    model = create_model("gpt2_moe", device=device, seed=3,
                         cfg_overrides={**TINY, "moe_dispatch": "scatter"})
    if device == "cuda":
        host = create_model("gpt2_moe", device="cpu", seed=3,
                            cfg_overrides=TINY)
        model.load_state_dict(host.state_dict())
    state = create_train_state(model, optim.adamw(LR, weight_decay=0.1))
    step = make_train_step(kind="lm")
    losses, drops = [], []
    for b in batches:
        state, m = step(state, {"tokens": torch.from_numpy(b).long().to(
            device)})
        losses.append(float(m["loss"]))
        drops.append(float(m["moe_drop_rate"]))
    return (np.array(losses), np.array(drops),
            {n: p.detach().cpu().numpy() for n, p in state.params.items()})


def test_three_steps_on_the_card_match_the_host():
    batches = np.random.default_rng(4).integers(0, 128, (3, 8, 16))
    host, card = _steps("cpu", batches), _steps("cuda", batches)
    np.testing.assert_allclose(card[0], host[0], rtol=1e-5)
    np.testing.assert_array_equal(card[1], host[1])
    for n, h in host[2].items():
        c = card[2][n]
        if n.endswith("attn.qkv.bias"):
            d = h.shape[0] // 3
            np.testing.assert_allclose(c[d:2 * d], h[d:2 * d], rtol=0,
                                       atol=3 * LR, err_msg=n)
            h = np.concatenate([h[:d], h[2 * d:]])
            c = np.concatenate([c[:d], c[2 * d:]])
        np.testing.assert_allclose(c, h, rtol=0, atol=2e-5, err_msg=n)
