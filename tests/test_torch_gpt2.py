"""PyTorch port of GPT-2 against the JAX reference on converted weights.

Pinned here: the weight bridge (models/convert.py), full-sequence logits,
one slot-mode serving tick (chunked prefill + a decode and a verify chunk
with an idle sentinel row), the published 124M parameter count, the
precision policy, and the registry's not-yet-ported entries.  f32
throughout; tolerances are f32 summation-order noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models import gpt2_124m as jax_gpt2
from pytorch_distributed_training_tpu_torch.models import (
    GPT2, GPT2Config, create_model, gpt2_124m, gpt2_params_from_jax,
)
from pytorch_distributed_training_tpu_torch.train import make_policy

SMALL = dict(num_layers=2, hidden_dim=64, num_heads=2, vocab_size=256,
             max_seq_len=64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the cores are
    shared with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """The JAX model + params and the port model holding the same weights."""
    jm = jax_gpt2(cfg_overrides=SMALL)
    params = jm.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32), train=False
    )["params"]
    tm = GPT2(GPT2Config(**SMALL))
    tm.load_state_dict(
        gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    )
    return jm, params, tm.eval()


def test_full_forward_logits_match(pair):
    jm, params, tm = pair
    tokens = np.random.default_rng(0).integers(0, 256, (2, 24)).astype(np.int32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens),
                              train=False))
    with torch.no_grad():
        out = tm(torch.from_numpy(tokens).long()).numpy()
    assert out.dtype == np.float32 and out.shape == (2, 24, 256)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_slot_mode_tick_matches_jax(pair):
    """One prefill chunk (ragged path, C=12 > 8), then a decode tick
    (C=1 kernel path) and a verify chunk (C=3 multi kernel path), with
    row 2 idle at the sentinel: the logits of live rows match the JAX
    decoder's slot mode, and the idle row writes nothing."""
    jm, params, tm = pair
    s, max_len = 3, 48
    dec = jm.clone(decode=True)
    cache = dec.init(
        jax.random.PRNGKey(0), jnp.zeros((s, max_len), jnp.int32),
        train=False,
    )["cache"]
    tcache = tm.new_cache(s, max_len)
    rng = np.random.default_rng(1)

    def tick(tokens, positions):
        nonlocal cache
        logits, upd = dec.apply(
            {"params": params, "cache": cache}, jnp.asarray(tokens),
            train=False, mutable=["cache"], positions=jnp.asarray(positions),
        )
        cache = upd["cache"]
        with torch.no_grad():
            out = tm(torch.from_numpy(tokens).long(), cache=tcache,
                     positions=torch.from_numpy(positions))
        return np.asarray(logits), out.numpy()

    sentinel = max_len
    for width, positions in ((12, [0, 5, sentinel]), (1, [12, 17, sentinel]),
                             (3, [13, 18, sentinel])):
        tokens = rng.integers(0, 256, (s, width)).astype(np.int32)
        ref, out = tick(tokens, np.asarray(positions, np.int32))
        np.testing.assert_allclose(out[:2], ref[:2], atol=1e-4, rtol=0)
    # The idle row's cache row was never written (writes went to scratch).
    for k, v in tcache:
        assert not k[2, :, :max_len].any() and not v[2, :, :max_len].any()


@pytest.mark.parametrize("name,count", [
    ("gpt2", 124_439_808), ("gpt2_medium", 354_823_168),
])
def test_param_count_matches_published(name, count):
    """The published counts tests/test_models.py pins for the JAX models
    (tied embeddings), built shape-only on the meta device."""
    model = create_model(name, device="meta")
    assert sum(p.numel() for p in model.parameters()) == count


def test_fresh_init_is_seeded_and_castable():
    a = gpt2_124m(SMALL, device="cpu", seed=7)
    b = gpt2_124m(SMALL, device="cpu", seed=7)
    c = gpt2_124m(SMALL, device="cpu", seed=8, dtype=torch.bfloat16)
    assert torch.equal(a.wte, b.wte) and not torch.equal(a.wte, c.wte.float())
    assert all(p.dtype == torch.bfloat16 for p in c.parameters())
    with torch.no_grad():
        logits = c(torch.zeros((1, 5), dtype=torch.long))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_policy_and_registry():
    assert make_policy("f32").compute_dtype == torch.float32
    assert make_policy("bf16").compute_dtype == torch.bfloat16
    assert make_policy("bf16").param_dtype == torch.float32
    assert make_policy("bf16_full").param_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        make_policy("fp8")
    assert create_model("gpt2_moe", device="meta").cfg.num_experts == 8
    for name in ("vit_s16", "vit_b16"):
        assert create_model(name, device="meta").cfg.attn_layout == "bhld2"
    moe = gpt2_124m({**SMALL, "num_experts": 2}, device="meta")
    assert [type(b).__name__ for b in moe.blocks][:2] == ["Block",
                                                          "MoeBlock"]
    with pytest.raises(ValueError, match="Unknown model"):
        create_model("gpt3", device="meta")
