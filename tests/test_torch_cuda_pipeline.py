"""The pipeline engines on the card (marked ``cuda``; they skip without a
card: what they pin is the engines' arithmetic and hops on CUDA
tensors).

This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_pipeline.py -m cuda --noconftest

Two gloo ranks (``tests/torch_pp_worker.py card``; gloo stages each
CUDA hop through the host) take one GPipe and one 1F1B step of a
2-stage tiny GPT-2 (4 layers, width 32, 4 heads, vocab 128) on the card,
f32 with TF32 off, and the same step on the host from the same weights:
the losses within rtol 1e-5 and the weights within 2e-5 (the key third
of each qkv bias within Adam's lr, its gradient being rounding noise).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

# The launcher lives beside this file; imported by its module name, since
# an installed package may own the name ``tests``.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_dp_worker import launch  # noqa: E402

pytestmark = pytest.mark.cuda

LR = 1e-3


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engines under test run on the "
                    "card")
    out = tmp_path_factory.mktemp("pipeline_card")
    launch(["tests/torch_pp_worker.py", "card", str(out)], 2, timeout=240)
    return dict(np.load(out / "rank0.npz"))


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_one_step_on_the_card_matches_the_host(steps, schedule):
    np.testing.assert_allclose(steps[f"cuda/{schedule}/loss"],
                               steps[f"cpu/{schedule}/loss"], rtol=1e-5)
    prefix = f"cpu/{schedule}/p/"
    names = [k[len(prefix):] for k in steps if k.startswith(prefix)]
    assert names
    for n in names:
        host, card = steps[prefix + n], steps[f"cuda/{schedule}/p/{n}"]
        if n.endswith("attn.qkv.bias"):
            d = host.shape[0] // 3
            np.testing.assert_allclose(card[d:2 * d], host[d:2 * d], rtol=0,
                                       atol=LR, err_msg=n)
            host = np.concatenate([host[:d], host[2 * d:]])
            card = np.concatenate([card[:d], card[2 * d:]])
        np.testing.assert_allclose(card, host, rtol=0, atol=2e-5, err_msg=n)
