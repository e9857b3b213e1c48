"""PyTorch port of the ViT against the JAX package.

The same inputs (numpy, seeded) and the same weights (the flax init,
converted by ``vit_params_from_jax``) go through the flax
``VisionTransformer`` and the port's:

- parameter counts of ViT-S/B/L-16 at 224 px equal JAX's, counted on the
  ``meta`` device (nothing allocated);
- f32 logits within 1e-4 under each ``attn_layout`` (auto, bhld,
  bhld2), train and eval mode, at 32 px and at 33 px (flax's ``"SAME"``
  padding, 7 rows above and 8 below);
- the weight bridge round-trips exactly;
- three f32 train steps against JAX's ``make_train_step(kind=
  "image_classifier")`` within rtol 1e-5 (adamw, adam, sgd, accumulation
  1 and 2, label smoothing, uint8 input normalized on the device, global
  norm clip), the key third of each ``qkv`` bias held to Adam's bound
  (its gradient is zero in exact arithmetic); the eval step;
- the bf16 policy's losses within 2e-2 of JAX's bf16 policy.

Port-only: ``remat`` gives the same gradients (with dropout on, the
recompute redraws the same masks); dropout masks follow the seed; uint8
input scaled on the device equals the host-scaled float input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models import vit as jvit
from pytorch_distributed_training_tpu.train import (
    TrainState as JaxTrainState, make_eval_step as jax_eval_step,
    make_policy as jax_policy, make_train_step as jax_train_step,
)
from pytorch_distributed_training_tpu_torch.cli.main import build_optimizer
from pytorch_distributed_training_tpu_torch.models import (
    create_model, vit_params_from_jax, vit_params_to_jax,
)
from pytorch_distributed_training_tpu_torch.models import vit as tvit
from pytorch_distributed_training_tpu_torch.train import (
    create_train_state, make_eval_step, make_policy, make_train_step,
)
from pytorch_distributed_training_tpu_torch.train.step import (
    prepare_image_input,
)
from tests.test_torch_train import _assert_params_close, _optax_tx

SMALL = dict(patch_size=16, hidden_dim=64, depth=2, num_heads=4,
             mlp_dim=128)
CLASSES, BATCH, STEPS = 10, 4, 3
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(autouse=True)
def _full_f32_matmuls():
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(saved)


def _jax_init(size: int, layout: str = "bhld2", seed: int = 1,
              dtype=jnp.float32, **extra):
    jm = jvit.vit_b16(num_classes=CLASSES,
                      cfg_overrides={**SMALL, "attn_layout": layout, **extra},
                      dtype=dtype)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, size, size, 3), jnp.float32),
                     train=False)["params"]
    return jm, params


def _port(params, size: int, layout: str = "bhld2", **extra):
    model = create_model("vit_b16", num_classes=CLASSES, device="cpu",
                         image_size=size,
                         cfg_overrides={**SMALL, "attn_layout": layout,
                                        **extra})
    model.load_state_dict(
        vit_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def _images(n: int, size: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["vit_s16", "vit_b16", "vit_l16"])
def test_param_counts_match_jax(name):
    jm = getattr(jvit, name)()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))
    model = create_model(name, device="meta", image_size=224)
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == want
    if name == "vit_b16":
        assert want == 86_567_656


def test_same_padding():
    assert tvit.same_padding(224, 16) == (0, 0)
    assert tvit.same_padding(33, 16) == (7, 8)
    assert tvit.same_padding(40, 16) == (4, 4)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("layout", ["auto", "bhld", "bhld2"])
def test_logits_match_flax(layout, train, size):
    jm, params = _jax_init(size, layout)
    x = _images(3, size)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               train=train))
    model = _port(params, size, layout).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and got.shape == (3, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_layouts_share_parameter_names():
    names = {layout: dict(_port(_jax_init(32, layout)[1], 32,
                                layout).named_parameters())
             for layout in ("auto", "bhld", "bhld2")}
    assert {k: v.shape for k, v in names["auto"].items()} \
        == {k: v.shape for k, v in names["bhld2"].items()} \
        == {k: v.shape for k, v in names["bhld"].items()}
    assert names["auto"]["blocks.0.attn.qkv.weight"].shape == (192, 64)
    assert names["auto"]["blocks.0.attn.proj.weight"].shape == (64, 64)


def test_weight_bridge_round_trips():
    _, params = _jax_init(32)
    state = vit_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    back = vit_params_to_jax(state)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, x in flat_a:
        np.testing.assert_array_equal(np.asarray(x), flat_b[path])
    assert set(state) == set(_port(params, 32).state_dict())


def _batches(size: int, uint8: bool = False, n: int = STEPS,
             batch: int = BATCH, seed: int = 5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = (rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
             if uint8 else rng.standard_normal(
                 (batch, size, size, 3)).astype(np.float32))
        out.append((x, rng.integers(0, CLASSES, batch).astype(np.int32)))
    return out


def run_jax(jm, params, batches, *, opt, lr, wd, clip=None, accum=1,
            smoothing=0.0, normalize=None, precision="f32"):
    tx = _optax_tx(opt, lr, wd, clip)
    params = jax.tree_util.tree_map(jnp.array, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats={},
                          apply_fn=jm.apply, tx=tx)
    step = jax_train_step(kind="image_classifier",
                          policy=jax_policy(precision),
                          num_microbatches=accum, label_smoothing=smoothing,
                          input_normalize=normalize)
    losses = []
    for x, y in batches:
        state, m = step(state, {"image": jnp.asarray(x),
                                "label": jnp.asarray(y)})
        losses.append(float(m["loss"]))
    return losses, state


def run_port(model, batches, *, opt, lr, wd, clip=None, accum=1,
             smoothing=0.0, normalize=None, precision="f32"):
    policy = make_policy(precision)
    state = create_train_state(
        model, build_optimizer(opt, lr, weight_decay=wd, grad_clip=clip),
        policy=policy)
    assert state.batch_stats == {} and state.keep == frozenset()
    step = make_train_step(kind="image_classifier", policy=policy,
                           num_microbatches=accum, label_smoothing=smoothing,
                           input_normalize=normalize)
    losses = []
    for x, y in batches:
        state, m = step(state, {"image": torch.from_numpy(x),
                                "label": torch.from_numpy(y)})
        losses.append(float(m["loss"]))
    return losses, state


# Adam moves every weight by up to lr a step; at lr 3e-4 the rounding
# noise stays under the tolerance while three steps move the weights far
# past it.
TRAIN_CASES = {
    "adamw-accum2": dict(opt="adamw", lr=3e-4, wd=0.05, accum=2),
    "adam-smoothing": dict(opt="adam", lr=3e-4, wd=1e-3, smoothing=0.1),
    "sgd-accum2": dict(opt="sgd", lr=0.05, wd=1e-3, accum=2),
    "adamw-clip-uint8": dict(opt="adamw", lr=3e-4, wd=0.05, clip=0.5,
                             uint8=True),
    "adamw-auto-layout": dict(opt="adamw", lr=3e-4, wd=0.05,
                              layout="auto"),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_steps_match_jax(case):
    kw = dict(TRAIN_CASES[case])
    layout = kw.pop("layout", "bhld2")
    uint8 = kw.pop("uint8", False)
    if uint8:
        kw["normalize"] = (MEAN, STD)
    jm, params = _jax_init(32, layout)
    batches = _batches(32, uint8)
    ref_losses, ref_state = run_jax(jm, params, batches, **kw)
    losses, state = run_port(_port(params, 32, layout), batches, **kw)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert len(set(losses)) == STEPS
    got = vit_params_to_jax(state.params)
    ref = jax.tree_util.tree_map(np.asarray, ref_state.params)
    lr_bound = 2 * STEPS * kw["lr"] if kw["opt"] != "sgd" else 1e-5
    _assert_params_close(got, ref, atol=1e-5, lr_bound=lr_bound)

    jeval = jax_eval_step(kind="image_classifier", policy=jax_policy("f32"),
                          input_normalize=kw.get("normalize"))
    teval = make_eval_step(kind="image_classifier", policy=make_policy("f32"),
                           input_normalize=kw.get("normalize"))
    x, y = batches[0]
    want = jeval(ref_state, {"image": jnp.asarray(x),
                             "label": jnp.asarray(y)})
    have = teval(state, {"image": torch.from_numpy(x),
                         "label": torch.from_numpy(y)})
    np.testing.assert_allclose(float(have["loss"]), float(want["loss"]),
                               rtol=1e-5)
    assert float(have["accuracy"]) == float(want["accuracy"])


@pytest.mark.parametrize("layout", ["bhld2", "auto"])
def test_bf16_policy_tracks_jax(layout):
    jm, params = _jax_init(32, layout, dtype=jnp.bfloat16)
    batches = _batches(32, uint8=True)
    kw = dict(opt="adamw", lr=1e-3, wd=0.05, accum=2,
              normalize=(MEAN, STD), precision="bf16")
    ref_losses, _ = run_jax(jm, params, batches, **kw)
    losses, state = run_port(_port(params, 32, layout), batches, **kw)
    np.testing.assert_allclose(losses, ref_losses, atol=2e-2, rtol=0)
    assert all(p.dtype == torch.float32 for p in state.params.values())


def _grads(model, x, y, seed=None):
    policy = make_policy("f32")
    state = create_train_state(model, build_optimizer("sgd", 0.0,
                                                      weight_decay=0.0),
                               policy=policy)
    step = make_train_step(kind="image_classifier", policy=policy, seed=seed)
    grads = {}
    hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
             for n, p in state.params.items()]
    try:
        _, m = step(state, {"image": torch.from_numpy(x),
                            "label": torch.from_numpy(y)})
    finally:
        for h in hooks:
            h.remove()
    return float(m["loss"]), grads


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_remat_gives_the_same_gradients(rate):
    _, params = _jax_init(32)
    (x, y), = _batches(32, n=1)
    out = {}
    for remat in (False, True):
        model = _port(params, 32, remat=remat, dropout_rate=rate)
        out[remat] = _grads(model, x, y, seed=7 if rate else None)
    assert out[False][0] == pytest.approx(out[True][0], rel=1e-6)
    assert out[False][1].keys() == out[True][1].keys() \
        == dict(_port(params, 32).named_parameters()).keys()
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, atol=1e-6, rtol=1e-5)


def test_dropout_follows_the_seed():
    _, params = _jax_init(32)
    (x, y), = _batches(32, n=1)
    loss = {s: _grads(_port(params, 32, dropout_rate=0.2), x, y, seed=s)[0]
            for s in (3, 3, 4)}
    again = _grads(_port(params, 32, dropout_rate=0.2), x, y, seed=3)[0]
    assert loss[3] == again
    assert loss[3] != loss[4]
    plain = _grads(_port(params, 32), x, y)[0]
    assert plain not in (loss[3], loss[4])
    model = _port(params, 32, dropout_rate=0.2).train()
    with pytest.raises(ValueError, match="generator"):
        model(torch.zeros(1, 3, 32, 32))


def test_uint8_input_is_scaled_on_the_device():
    _, params = _jax_init(32)
    model = _port(params, 32).eval()
    x = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3),
                                          dtype=np.uint8)
    policy = make_policy("f32")
    scaled = prepare_image_input(torch.from_numpy(x), policy, (MEAN, STD))
    host = torch.from_numpy((x / np.float32(255.0) - MEAN) / STD).permute(
        0, 3, 1, 2)
    torch.testing.assert_close(scaled, host.float(), atol=1e-6, rtol=0)
    with torch.no_grad():
        torch.testing.assert_close(model(scaled), model(host.float()),
                                   atol=1e-5, rtol=0)


def test_vit_runs_on_the_card_unless_asked(monkeypatch):
    from pytorch_distributed_training_tpu_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("vit_b16", cfg_overrides={"depth": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model", "vit_b16", "--synthetic-data", "--steps-per-epoch",
              "1", "--model-overrides", "depth=1"])


def test_attention_paths_per_layout(monkeypatch):
    """bhld/bhld2 never reach ``dot_product_attention`` (so no kernel);
    ``auto`` does, and under ``PDT_FORCE_ATTN=flash`` takes the flash
    entry (its plain version on the host) with flax's logits."""
    from pytorch_distributed_training_tpu_torch.models import layers
    from pytorch_distributed_training_tpu_torch.ops import flash_attention

    calls = []
    real = layers.dot_product_attention
    monkeypatch.setattr(layers, "dot_product_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fwd = flash_attention.flash_fwd_plain
    flash = []
    monkeypatch.setattr(flash_attention, "flash_fwd_plain",
                        lambda *a: flash.append(1) or fwd(*a))
    x = _images(2, 32)
    for layout in ("bhld", "bhld2"):
        jm, params = _jax_init(32, layout)
        with torch.no_grad():
            _port(params, 32, layout)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert calls == [] and flash == []
    jm, params = _jax_init(32, "auto")
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               train=False))
    monkeypatch.setenv("PDT_FORCE_ATTN", "flash")
    with torch.no_grad():
        got = _port(params, 32, "auto")(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(calls) == len(flash) == SMALL["depth"]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_forced_flash_at_l197_routes_to_rows_2_and_3():
    """ViT-B/16 at 224 px has 197 tokens: JAX's ``flash_attention`` pads
    them to 256 and takes the heads-fused single-tile kernels (#2
    ``_flash_fwd_single_nlhd``, #3 ``_flash_bwd_nlhd``), the rows
    chip_smoke.py's V3 launches are added under."""
    import ast
    import pathlib

    from pytorch_distributed_training_tpu.ops import pallas_attention as pa

    padded = 197 + (-197) % 128
    assert padded == 256 <= 512
    assert pa._nlhd_single_fits(padded, padded, 12 * 64, 2)
    src = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    rows = [ast.literal_eval(node.value)
            for node in ast.parse(src.read_text()).body
            if isinstance(node, ast.Assign)
            and getattr(node.targets[0], "id", None) == "VIT_FLASH_ROWS"]
    assert rows == [(2, 3)]
