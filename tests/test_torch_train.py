"""PyTorch port of the LM training path against the JAX package.

The same initial weights (the JAX init, converted by
``gpt2_params_from_jax``) and the same token batches (numpy, seeded) go
through the JAX ``make_train_step`` and the port's for three steps; the
per-step losses agree to rtol 1e-5 and the updated weights, mapped back
with ``gpt2_params_to_jax``, to atol 1e-5 (f32 summation order; the key
bias, whose gradient is zero in exact arithmetic, to Adam's step bound,
see ``_assert_params_close``).  Covered:
accumulation 1 and 2, adam / adamw / sgd, an active global-norm clip,
label smoothing, chunked CE with an uneven tail, a warmup-cosine schedule,
flash attention forced on both sides (Pallas interpret against the port's
plain flash), and the bf16 policy (loss within 2e-2).  Port-only checks:
remat gives identical grads, bf16_full accumulates in f32, dropout draws
distinct masks per microbatch, the optimizers' and schedules' semantics,
the data loader's order, ``TokenFile``, and a CLI smoke.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tpu import data as jdata
from pytorch_distributed_training_tpu.models import gpt2_124m as jax_gpt2
from pytorch_distributed_training_tpu.train import (
    TrainState as JaxTrainState, make_eval_step as jax_eval_step,
    make_policy as jax_policy, make_train_step as jax_train_step,
)
from pytorch_distributed_training_tpu_torch import data as tdata
from pytorch_distributed_training_tpu_torch.cli.main import (
    build_optimizer, build_schedule, main as cli_main,
)
from pytorch_distributed_training_tpu_torch.models import (
    GPT2, GPT2Config, gpt2_params_from_jax, gpt2_params_to_jax,
)
from pytorch_distributed_training_tpu_torch.parallel import (
    accumulate_gradients,
)
from pytorch_distributed_training_tpu_torch.train import (
    create_train_state, make_eval_step, make_policy, make_train_step,
)
from pytorch_distributed_training_tpu_torch.train.step import (
    dropout_generator,
)

SMALL = dict(num_layers=2, hidden_dim=64, num_heads=2, vocab_size=256,
             max_seq_len=64)
SEQ, BATCH, STEPS = 32, 8, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the cores are shared with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(cfg: dict, seed: int = 3):
    jm = jax_gpt2(cfg_overrides=cfg)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
                     train=False)["params"]
    return jm, params


@pytest.fixture(scope="module")
def small_init():
    """The JAX model and its initial params, built once per module."""
    return _jax_params(SMALL)


def _batches(seq=SEQ, batch=BATCH, vocab=256, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (batch, seq)).astype(np.int32)
            for _ in range(n)]


def _optax_tx(name, lr, wd, clip=None, momentum=0.9):
    """The JAX CLI's optimizer block (cli/main.py:1317-1341)."""
    if name == "adam":
        tx = optax.chain(optax.add_decayed_weights(wd), optax.scale_by_adam(),
                         optax.scale_by_learning_rate(lr))
    elif name == "adamw":
        tx = optax.adamw(lr, weight_decay=wd)
    else:
        tx = optax.chain(optax.add_decayed_weights(wd),
                         optax.sgd(lr, momentum=momentum))
    if clip is not None:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    return tx


def _optax_schedule(kind, lr, total, warmup):
    if kind == "constant":
        return lr
    if kind == "cosine":
        return optax.cosine_decay_schedule(lr, decay_steps=total)
    w = max(warmup, 1)
    return optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=w, decay_steps=max(total, w + 1))


def _run_jax(jm, params, batches, *, opt, lr, wd, clip=None, accum=1,
             smoothing=0.0, chunk=None, schedule="constant", precision="f32"):
    tx = _optax_tx(opt, _optax_schedule(schedule, lr, STEPS, 1), wd, clip)
    # Fresh arrays: the jitted step donates its input state.
    params = jax.tree_util.tree_map(jnp.array, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats={},
                          apply_fn=jm.apply, tx=tx)
    step = jax_train_step(kind="lm", policy=jax_policy(precision),
                          num_microbatches=accum, label_smoothing=smoothing,
                          lm_loss_chunk=chunk)
    losses = []
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b)})
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, state.params)


def _port_model(params, cfg: dict, **extra):
    model = GPT2(GPT2Config(**cfg, **extra))
    model.load_state_dict(
        gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def _run_port(params, batches, *, cfg=SMALL, opt, lr, wd, clip=None,
              accum=1, smoothing=0.0, chunk=None, schedule="constant",
              precision="f32", remat=False):
    policy = make_policy(precision)
    model = _port_model(params, cfg, remat=remat)
    tx = build_optimizer(
        opt, build_schedule(schedule, lr, total_steps=STEPS, warmup_steps=1),
        weight_decay=wd, grad_clip=clip)
    state = create_train_state(model, tx, policy=policy)
    step = make_train_step(kind="lm", policy=policy, num_microbatches=accum,
                           label_smoothing=smoothing, lm_loss_chunk=chunk)
    losses = []
    for b in batches:
        state, m = step(state, {"tokens": torch.from_numpy(b)})
        losses.append(float(m["loss"]))
    return losses, gpt2_params_to_jax(state.params)


def _assert_params_close(got, ref, atol, lr_bound):
    """Leaf by leaf within ``atol``, except the key bias (the middle third
    of each qkv bias).  Its gradient is zero in exact arithmetic — softmax
    is invariant to the per-query constant q.b_k — so what both sides
    compute there is rounding noise, which Adam's normalisation turns into
    steps of up to ±lr in either direction.  Those entries are held to
    ``lr_bound``, the most the optimizer can move them."""
    fr = jax.tree_util.tree_leaves_with_path(ref)
    fg = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(fr) == len(fg)
    for path, x in fr:
        x, y = np.asarray(x), np.asarray(fg[path])
        name = jax.tree_util.keystr(path)
        if name.endswith("['qkv']['bias']"):
            d = x.shape[0] // 3
            np.testing.assert_allclose(y[d:2 * d], x[d:2 * d], rtol=0,
                                       atol=lr_bound, err_msg=name + " k")
            x = np.concatenate([x[:d], x[2 * d:]])
            y = np.concatenate([y[:d], y[2 * d:]])
        np.testing.assert_allclose(y, x, atol=atol, rtol=0, err_msg=name)


# Adam moves every weight by up to lr a step whatever its gradient's size,
# so a weight whose gradient is near the rounding noise moves by an amount
# the noise decides; at lr 3e-4 that stays under the 1e-5 tolerance while
# three steps still move the weights ~100x the tolerance.
CASES = {
    "adam-accum1": dict(opt="adam", lr=3e-4, wd=1e-3),
    "adam-accum2": dict(opt="adam", lr=3e-4, wd=1e-3, accum=2),
    "adamw-accum2": dict(opt="adamw", lr=3e-4, wd=0.1, accum=2),
    "sgd": dict(opt="sgd", lr=0.05, wd=1e-3),
    "clip-active": dict(opt="adam", lr=3e-4, wd=1e-3, clip=0.05),
    "label-smoothing": dict(opt="adam", lr=3e-4, wd=1e-3, smoothing=0.1),
    "ce-chunk-uneven": dict(opt="adam", lr=3e-4, wd=1e-3, chunk=7, accum=2),
    "warmup-cosine": dict(opt="adamw", lr=3e-4, wd=0.1,
                          schedule="warmup-cosine"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax(small_init, case):
    jm, params = small_init
    batches = _batches()
    kw = CASES[case]
    ref_losses, ref_params = _run_jax(jm, params, batches, **kw)
    losses, got = _run_port(params, batches, **kw)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    _assert_params_close(got, ref_params, atol=1e-5,
                         lr_bound=2 * STEPS * kw["lr"])


def test_clip_case_is_active(small_init):
    """The clip case's threshold is below the first step's grad norm."""
    _, params = small_init
    model = _port_model(params, SMALL)
    tokens = torch.from_numpy(_batches()[0]).long()
    logits = model(tokens)
    loss = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, 256), tokens[:, 1:].reshape(-1))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
    assert norm > 10 * CASES["clip-active"]["clip"]


def test_bf16_policy_loss_tracks_jax(small_init):
    jm, params = small_init
    batches = _batches()
    kw = dict(opt="adam", lr=1e-3, wd=1e-3, accum=2, precision="bf16")
    ref_losses, _ = _run_jax(jm, params, batches, **kw)
    losses, _ = _run_port(params, batches, **kw)
    np.testing.assert_allclose(losses, ref_losses, atol=2e-2, rtol=0)


def test_flash_forced_train_steps_match_jax(monkeypatch):
    """seq 256, Dh 64, PDT_FORCE_ATTN=flash on both sides: the Pallas
    kernels in interpret mode against the port's plain flash versions."""
    monkeypatch.setenv("PDT_FORCE_ATTN", "flash")
    cfg = dict(num_layers=2, hidden_dim=128, num_heads=2, vocab_size=256,
               max_seq_len=256)
    jm, params = _jax_params(cfg)
    batches = _batches(seq=256, batch=2, n=2)
    kw = dict(opt="adamw", lr=3e-4, wd=0.1)
    ref_losses, ref_params = _run_jax(jm, params, batches, **kw)
    losses, got = _run_port(params, batches, cfg=cfg, **kw)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    _assert_params_close(got, ref_params, atol=1e-5,
                         lr_bound=2 * len(batches) * kw["lr"])


def _grads_of(model, tokens, seed=None):
    """One train step's grads (no update) through make_train_step's loss."""
    from pytorch_distributed_training_tpu_torch.train.step import _lm_loss

    policy = make_policy("f32")
    params = dict(model.named_parameters())
    model.train()
    gen = None if seed is None else dropout_generator(seed, 0, 0)
    loss = _lm_loss(model, params, tokens, policy=policy, generator=gen,
                    lm_loss_chunk=None, label_smoothing=0.0)
    return torch.autograd.grad(loss, list(params.values()))


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_grads_identical(small_init, dropout):
    """Remat reruns each block in the backward on the same tensors and the
    same dropout masks: the grads are bit-identical."""
    _, params = small_init
    tokens = torch.from_numpy(_batches()[0]).long()
    seed = 5 if dropout else None
    plain = _grads_of(_port_model(params, SMALL, dropout_rate=dropout),
                      tokens, seed)
    remat = _grads_of(_port_model(params, SMALL, dropout_rate=dropout,
                                  remat=True), tokens, seed)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


def test_bf16_full_accumulates_in_f32():
    """Under bf16_full the microbatch grads (bf16) sum in f32, are scaled
    by 1/N, then cast: equal to that reference, not to a bf16 sum."""
    torch.manual_seed(0)
    w = torch.randn(64, 64, dtype=torch.bfloat16, requires_grad=True)
    x = torch.randn(4, 8, 64, dtype=torch.bfloat16)

    def loss_fn(params, mb):
        return (mb["x"] @ params["w"]).float().square().mean()

    loss, grads = accumulate_gradients(loss_fn, {"w": w}, {"x": x}, 4)
    per = [torch.autograd.grad(loss_fn({"w": w}, {"x": x[i:i + 1]}), w)[0]
           for i in range(4)]
    ref = (sum(g.float() for g in per) * 0.25).to(torch.bfloat16)
    assert grads["w"].dtype == torch.bfloat16
    assert torch.equal(grads["w"], ref)
    lowp = per[0]
    for g in per[1:]:
        lowp = lowp + g
    assert not torch.equal(grads["w"], (lowp * 0.25).to(torch.bfloat16))


def test_accum_microbatches_draw_distinct_dropout():
    """Each accumulation slice gets its own dropout generator: distinct
    draws per microbatch and step, the same draws on a rerun."""
    seen = []

    def loss_fn(params, mb, i):
        gen = dropout_generator(1, 0, i)
        seen.append(torch.rand(8, generator=gen))
        return (params["w"] * mb["x"].mean()).sum()

    w = torch.ones((), requires_grad=True)
    accumulate_gradients(loss_fn, {"w": w}, {"x": torch.arange(8.0)}, 4,
                         pass_microbatch_index=True)
    assert len(seen) == 4
    assert all(not torch.equal(seen[a], seen[b])
               for a in range(4) for b in range(a + 1, 4))
    again = torch.rand(8, generator=dropout_generator(1, 0, 2))
    assert torch.equal(again, seen[2])
    assert not torch.equal(
        torch.rand(8, generator=dropout_generator(1, 1, 2)), seen[2])


def test_dropout_draws_from_the_generator(small_init):
    _, params = small_init
    model = _port_model(params, SMALL, dropout_rate=0.5).train()
    tokens = torch.from_numpy(_batches()[0]).long()
    with pytest.raises(ValueError, match="generator"):
        model(tokens)
    a = model(tokens, generator=torch.Generator().manual_seed(1))
    b = model(tokens, generator=torch.Generator().manual_seed(1))
    c = model(tokens, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    assert torch.equal(model(tokens), model(tokens))


def test_eval_step_matches_jax(small_init):
    jm, params = small_init
    tokens = _batches()[0]
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=(), batch_stats={}, apply_fn=jm.apply,
                           tx=optax.identity())
    ref = float(jax_eval_step(kind="lm", lm_loss_chunk=7)(
        jstate, {"tokens": jnp.asarray(tokens)})["loss"])
    state = create_train_state(_port_model(params, SMALL),
                               build_optimizer("sgd", 0.1, weight_decay=0.0))
    got = float(make_eval_step(kind="lm", lm_loss_chunk=7)(
        state, {"tokens": torch.from_numpy(tokens)})["loss"])
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizers_match_torch_semantics(name):
    """``adam`` is torch Adam(weight_decay=) (coupled L2) and ``sgd`` torch
    SGD(momentum, weight_decay), as the JAX CLI's are
    (tests/test_cli_and_aux.py)."""
    lr, wd = 0.1, 1e-3
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    tw = torch.nn.Parameter(torch.tensor(w0))
    topt = (torch.optim.Adam([tw], lr=lr, weight_decay=wd) if name == "adam"
            else torch.optim.SGD([tw], lr=lr, momentum=0.9, weight_decay=wd))
    p = torch.tensor(w0)
    tx = build_optimizer(name, lr, weight_decay=wd, momentum=0.9)
    st = tx.init([p])
    for step in range(5):
        g = rng.standard_normal((5, 3)).astype(np.float32)
        topt.zero_grad()
        tw.grad = torch.tensor(g)
        topt.step()
        upd, st = tx.update([torch.tensor(g)], st, [p])
        p = p + upd[0]
        np.testing.assert_allclose(p.numpy(), tw.detach().numpy(),
                                   rtol=1e-4, atol=5e-6,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("clip", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(clip):
    rng = np.random.default_rng(1)
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (7,))]
    ref, _ = optax.clip_by_global_norm(clip).update(
        [jnp.asarray(g) for g in gs], optax.EmptyState())
    from pytorch_distributed_training_tpu_torch.train import optim

    got, _ = optim.clip_by_global_norm(clip).update(
        [torch.tensor(g) for g in gs], (), None)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("kind", ["cosine", "warmup-cosine"])
def test_schedules_match_optax(kind):
    total, warmup, lr = 20, 4, 6e-4
    ref = _optax_schedule(kind, lr, total, warmup)
    got = build_schedule(kind, lr, total_steps=total, warmup_steps=warmup)
    for count in range(total + 3):
        # optax evaluates in f32.
        np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-6,
                                   atol=1e-10)


@pytest.mark.parametrize("shards", [1, 2])
def test_loader_order_matches_jax(shards):
    kw = dict(n=40, seq_len=8, vocab_size=100)
    for shard in range(shards):
        jl = jdata.DataLoader(
            jdata.SyntheticTokens(**kw),
            jdata.DataLoaderConfig(batch_size=8, seed=3),
            shard_index=shard, num_shards=shards)
        tl = tdata.DataLoader(
            tdata.SyntheticTokens(**kw),
            tdata.DataLoaderConfig(batch_size=8, seed=3),
            shard_index=shard, num_shards=shards)
        assert len(jl) == len(tl)
        for epoch in range(2):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            got = [b["tokens"] for b in tl]
            ref = [b["tokens"] for b in jl]
            assert len(got) == len(ref) > 0
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)


def test_token_file_matches_jax(tmp_path):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(0).integers(0, 50257, 1000).astype(
        np.uint16).tofile(path)
    j = jdata.TokenFile(str(path), seq_len=16)
    t = tdata.TokenFile(str(path), seq_len=16)
    assert len(t) == len(j) == 62
    np.testing.assert_array_equal(t[5]["tokens"], j[5]["tokens"])
    idx = [3, 0, 61, 7]
    np.testing.assert_array_equal(t.get_batch(idx)["tokens"],
                                  j.get_batch(idx)["tokens"])
    sub = tdata.Subset(t, 10, 20)
    np.testing.assert_array_equal(sub.get_batch([0, 9])["tokens"],
                                  t.get_batch([10, 19])["tokens"])


@pytest.mark.parametrize("extra", [[], ["--remat", "--ce-chunk", "8"],
                                   ["--eval", "--eval-steps", "2"]])
def test_cli_trains_on_the_host(capsys, extra):
    trainer = cli_main([
        "--use-cpu", "--model", "gpt2", "--dataset", "synthetic-tokens",
        "--seq-len", "32", "--model-overrides",
        "num_layers=2,hidden_dim=64,num_heads=2,vocab_size=256,max_seq_len=64",
        "--batch-size", "8", "--accum-steps", "2", "--steps-per-epoch", "3",
        "--learning-rate", "1e-3", *extra,
    ])
    out = capsys.readouterr().out
    assert "training started" in out and "training finished" in out
    lines = [ln for ln in out.splitlines() if "examples_per_sec=" in ln]
    assert len(lines) == 1 and "step=3" in lines[0]
    assert ("eval_loss=" in out) == ("--eval" in extra)
    assert trainer.state.step == 3
    assert np.isfinite(trainer.history[-1]["loss"])


def test_cli_trains_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--model", "gpt2", "--dataset", "synthetic-tokens",
                  "--seq-len", "32", "--model-overrides",
                  "num_layers=1,hidden_dim=32,num_heads=2,vocab_size=64,"
                  "max_seq_len=32"])


def test_cli_usage_errors():
    base = ["--use-cpu", "--model", "gpt2", "--seq-len", "32"]
    with pytest.raises(SystemExit, match="pick a matching pair"):
        cli_main(base + ["--dataset", "cifar10"])
    image = ["--use-cpu", "--model", "resnet18", "--dataset", "cifar10"]
    with pytest.raises(SystemExit, match="--ce-chunk applies to LM"):
        cli_main(image + ["--ce-chunk", "8"])
    with pytest.raises(FileNotFoundError, match="/x"):
        cli_main(["--use-cpu", "--model", "resnet18", "--dataset",
                  "imagefolder:/x"])
    with pytest.raises(SystemExit, match="unknown optimizer"):
        cli_main(base + ["--dataset", "synthetic-tokens", "--optimizer",
                         "lamb", "--model-overrides",
                         "num_layers=1,hidden_dim=32,num_heads=2,"
                         "vocab_size=64,max_seq_len=32"])
