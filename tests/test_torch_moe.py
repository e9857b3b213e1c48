"""The port's MoE GPT-2 (``models/moe.py``) against the JAX package's
``models/moe.py`` on the CPU: the same numpy-seeded inputs and the JAX
model's own weights (``models/convert.py``), at the tolerances of JAX's
``tests/test_moe.py``.

- Routing: GShard's dispatch and combine, the scatter indices, every kept
  token in exactly one cell, capacity drops.
- ``MoeMlp`` outputs, aux loss, drop rate and gradients in both dispatch
  modes; scatter equal to einsum for the layer and the model.
- The GPT-2 MoE: logits within 1e-4 (remat too), the parameter count of
  ``gpt2_moe`` against JAX's tree, three f32 train steps against JAX's
  ``make_train_step`` within rtol 1e-5, the aux loss in the objective,
  the drop rate against the capacity factor.
- Routing over the global batch: at a capacity that drops tokens JAX's
  loss on the global batch is not the mean of its shards' losses; four
  gloo ranks (``tests/torch_moe_worker.py``, one launch for every
  layout) under data 4, expert 4, data 2 x expert 2, expert 2 x tensor 2,
  data 2 x tensor 2 and fsdp 2 x expert 2, two of them at a dropping
  capacity, against JAX's steps on the global batch; the
  expert-parallel checkpoint restored into data parallelism and into
  PP 2 x data 2; the eval step after those steps (each rank its whole
  batch), through the library and through the CLI's ``--distributed``.
- The refusals (decoding, sequence parallelism) and the CLI: ``--model
  gpt2_moe`` and the ``moe_dispatch`` override.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tpu.models import (
    create_model as jax_create_model,
)
from pytorch_distributed_training_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config,
)
from pytorch_distributed_training_tpu.models.moe import (
    MoeMlp as JaxMoeMlp, _top1_dispatch, _top1_scatter_indices,
)
from pytorch_distributed_training_tpu.train import (
    TrainState as JaxTrainState, make_eval_step as jax_eval_step,
    make_train_step as jax_train_step,
)
from pytorch_distributed_training_tpu_torch.cli.main import (
    _parse_overrides, main as cli_main,
)
from pytorch_distributed_training_tpu_torch.models import (
    GPT2, GPT2Config, create_model,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    gpt2_params_from_jax, gpt2_params_to_jax,
)
from pytorch_distributed_training_tpu_torch.models.moe import (
    MoeMlp, top1_dispatch, top1_scatter_indices,
)
from pytorch_distributed_training_tpu_torch.parallel.sharded import (
    ModelParallel,
)
from pytorch_distributed_training_tpu_torch.train import (
    create_train_state, make_train_step, optim,
)
from tests.test_torch_train import _assert_params_close
from tests.torch_dp_worker import launch_start
from tests.torch_moe_worker import (
    ACCUM, CKPT_SRC, CLI_EVAL_CF, LAYOUTS, LR, TINY_MOE, WD, moe_tokens,
)
from tests.torch_shared import shared

SMALL = dict(num_layers=2, hidden_dim=32, num_heads=2, vocab_size=64,
             max_seq_len=16, num_experts=4)
STEP_LR = 3e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _named(tree) -> dict:
    return {k: v.numpy() for k, v in gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --- routing -----------------------------------------------------------------

ROUTING_CASES = {
    "random": (np.random.default_rng(0).standard_normal((16, 4)), 8),
    "one_expert": (np.tile([[10.0, 0.0]], (8, 1)), 2),
    "tight": (np.random.default_rng(1).standard_normal((32, 4)), 3),
}


@pytest.mark.parametrize("case", sorted(ROUTING_CASES))
def test_top1_dispatch_matches_jax(case):
    """Dispatch and combine one-hots and the aux loss equal JAX's; each
    kept token occupies exactly one cell, no cell holds two, and the
    kept count is what the capacity allows."""
    logits, capacity = ROUTING_CASES[case]
    logits = logits.astype(np.float32)
    jd, jc, ja = _top1_dispatch(jnp.asarray(logits), capacity)
    d, c, a = top1_dispatch(torch.from_numpy(logits), capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-7)
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-6)
    per_token = d.sum((1, 2)).numpy()
    assert set(per_token.tolist()) <= {0.0, 1.0}
    assert d.sum(0).max() <= 1.0
    counts = np.bincount(logits.argmax(-1), minlength=logits.shape[1])
    assert per_token.sum() == np.minimum(counts, capacity).sum()


@pytest.mark.parametrize("case", sorted(ROUTING_CASES))
def test_scatter_indices_match_jax(case):
    logits, capacity = ROUTING_CASES[case]
    logits = logits.astype(np.float32)
    jf, jg, jk, _ = _top1_scatter_indices(jnp.asarray(logits), capacity)
    f, g, k = top1_scatter_indices(torch.from_numpy(logits), capacity)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-7)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))


# --- the layer ---------------------------------------------------------------

def _layer_pair(mode: str, cf: float, seed: int = 7):
    x = np.random.default_rng(seed).standard_normal((2, 16, 24)).astype(
        np.float32)
    jm = JaxMoeMlp(num_experts=4, mlp_dim=32, capacity_factor=cf,
                   dispatch_mode=mode)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = MoeMlp(24, 4, 32, capacity_factor=cf, dispatch_mode=mode,
                device="cpu")
    with torch.no_grad():
        tm.router.weight.copy_(torch.from_numpy(
            np.asarray(params["router"]["kernel"]).T.copy()))
        tm.router.bias.copy_(torch.from_numpy(
            np.array(params["router"]["bias"])))
        tm.w_up.copy_(torch.from_numpy(np.array(params["w_up"])))
        tm.w_down.copy_(torch.from_numpy(np.array(params["w_down"])))
    return x, jm, params, tm


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("mode", ["einsum", "scatter"])
def test_moe_mlp_matches_jax(mode, cf):
    """Outputs (atol 1e-5), aux loss and drop rate (1e-6) and the
    gradients of sum(out^2) (rtol 1e-4, atol 1e-5) against flax's; at
    cf 0.5 tokens are dropped."""
    x, jm, params, tm = _layer_pair(mode, cf)
    out, sown = jm.apply({"params": params}, jnp.asarray(x),
                         mutable=["losses", "moe_stats"])
    got, aux, drop = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()),
                               float(sown["losses"]["moe_aux_loss"][0]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(drop),
                               float(sown["moe_stats"]["drop_rate"][0]),
                               atol=1e-6)
    if cf < 1.0:
        assert float(drop) > 0
    jg = jax.grad(lambda p: jnp.sum(jm.apply({"params": p},
                                             jnp.asarray(x)) ** 2))(params)
    (got ** 2).sum().backward()
    pairs = {"router.weight": np.asarray(jg["router"]["kernel"]).T,
             "router.bias": jg["router"]["bias"], "w_up": jg["w_up"],
             "w_down": jg["w_down"]}
    for name, ref in pairs.items():
        np.testing.assert_allclose(
            dict(tm.named_parameters())[name].grad.numpy(), np.asarray(ref),
            rtol=1e-4, atol=1e-5, err_msg=name)


def test_scatter_equals_einsum_layer_and_model():
    """The two formulations select, weight and drop the same tokens: the
    layer's outputs and gradients, and the model's logits."""
    x, _, _, ein = _layer_pair("einsum", 0.5)
    sca = MoeMlp(24, 4, 32, capacity_factor=0.5, dispatch_mode="scatter",
                 device="cpu")
    sca.load_state_dict(ein.state_dict())
    outs = []
    for m in (ein, sca):
        out, aux, drop = m(torch.from_numpy(x))
        (out ** 2).sum().backward()
        outs.append((out.detach(), float(aux.detach()), float(drop),
                     {n: p.grad for n, p in m.named_parameters()}))
    np.testing.assert_allclose(outs[0][0], outs[1][0], atol=1e-5)
    assert outs[0][1:3] == outs[1][1:3] and outs[0][2] > 0
    for n, g in outs[0][3].items():
        np.testing.assert_allclose(g, outs[1][3][n], atol=1e-4, err_msg=n)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 64, (4, 16))).long()
    models = [create_model("gpt2_moe", device="cpu", cfg_overrides={
        **SMALL, "moe_dispatch": mode}) for mode in ("einsum", "scatter")]
    models[1].load_state_dict(models[0].state_dict())
    with torch.no_grad():
        a, b = (m(tokens) for m in models)
    np.testing.assert_allclose(a, b, atol=1e-4)


# --- the model ---------------------------------------------------------------

def _jax_model(**over):
    cfg = JaxGPT2Config(**{**SMALL, **over})
    jm = JaxGPT2(cfg=cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                     train=False)["params"]
    return jm, params


def _port_model(params, **over):
    model = GPT2(GPT2Config(**{**SMALL, **over}), device="cpu")
    model.load_state_dict(gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return model


@pytest.mark.parametrize("remat", [False, True])
def test_gpt2_moe_logits_match_jax(remat):
    jm, params = _jax_model()
    tokens = np.random.default_rng(3).integers(0, 64, (4, 16)).astype(
        np.int32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens),
                              train=False))
    model = _port_model(params, remat=remat).train(remat)
    logits, moe = model(torch.from_numpy(tokens).long(), return_moe=True)
    np.testing.assert_allclose(logits.detach().numpy(), ref, atol=1e-4)
    _, sown = jm.apply({"params": params}, jnp.asarray(tokens), train=False,
                       mutable=["losses", "moe_stats"])
    np.testing.assert_allclose(
        float(moe["moe_aux_loss"].detach()),
        sum(float(jnp.sum(v))
            for v in jax.tree_util.tree_leaves(sown["losses"])),
        rtol=1e-5)
    assert list(gpt2_params_to_jax(dict(model.named_parameters()))) == \
        list(params)


def test_gpt2_moe_parameter_count_matches_jax():
    """``gpt2_moe`` builds with 322,634,544 parameters, the JAX tree's."""
    shapes = jax.eval_shape(
        lambda: jax_create_model("gpt2_moe").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
            train=False))["params"]
    jax_count = sum(int(np.prod(x.shape))
                    for x in jax.tree_util.tree_leaves(shapes))
    model = create_model("gpt2_moe", device="meta")
    assert model.cfg.num_experts == 8
    assert sum(p.numel() for p in model.parameters()) == jax_count \
        == 322_634_544


def _jax_steps(params, batches, accum, *, aux_w=0.01, **over):
    jm = JaxGPT2(cfg=JaxGPT2Config(**{**SMALL, **over}))
    tx = optax.adamw(STEP_LR, weight_decay=0.1)
    p = jax.tree_util.tree_map(jnp.array, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p,
                          opt_state=tx.init(p), batch_stats={},
                          apply_fn=jm.apply, tx=tx)
    step = jax_train_step(kind="lm", num_microbatches=accum,
                          aux_loss_weight=aux_w)
    losses, drops = [], []
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b)})
        losses.append(float(m["loss"]))
        drops.append(float(m["moe_drop_rate"]))
    return np.array(losses), np.array(drops), state.params


def _port_steps(params, batches, accum, *, aux_w=0.01, **over):
    model = _port_model(params, **over)
    state = create_train_state(model, optim.adamw(STEP_LR, weight_decay=0.1))
    step = make_train_step(kind="lm", num_microbatches=accum,
                           aux_loss_weight=aux_w)
    losses, drops = [], []
    for b in batches:
        state, m = step(state, {"tokens": torch.from_numpy(b).long()})
        losses.append(float(m["loss"]))
        drops.append(float(m["moe_drop_rate"]))
    return np.array(losses), np.array(drops), state


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mode", ["einsum", "scatter"])
def test_three_train_steps_match_jax(mode, accum):
    """Three f32 adamw steps (aux loss weight 0.01 in the objective, the
    drop rate in the metrics) against JAX's ``make_train_step``: losses
    within rtol 1e-5, parameters within 1e-5 (the key bias within Adam's
    2 lr a step)."""
    _, params = _jax_model()
    batches = np.random.default_rng(4).integers(0, 64, (3, 8, 16)).astype(
        np.int32)
    jl, jd, jp = _jax_steps(params, batches, accum, moe_dispatch=mode,
                            moe_capacity_factor=0.5)
    tl, td, state = _port_steps(params, batches, accum, moe_dispatch=mode,
                                moe_capacity_factor=0.5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(td, jd, atol=1e-6)
    assert td.min() > 0
    _assert_params_close(gpt2_params_to_jax(state.params),
                         jax.tree_util.tree_map(np.asarray, jp), atol=1e-5,
                         lr_bound=2 * 3 * STEP_LR)


def test_aux_loss_reaches_the_objective():
    """Weight 1 adds the (positive) balancing loss to the reported loss
    and to the gradients, in the port as in JAX; weight 0 leaves the
    plain CE."""
    _, params = _jax_model()
    batch = np.random.default_rng(1).integers(0, 64, (1, 4, 16)).astype(
        np.int32)
    got = {w: _port_steps(params, batch, 1, aux_w=w) for w in (0.0, 1.0)}
    ref = {w: _jax_steps(params, batch, 1, aux_w=w) for w in (0.0, 1.0)}
    for w in (0.0, 1.0):
        np.testing.assert_allclose(got[w][0], ref[w][0], rtol=1e-5)
    assert got[1.0][0][0] > got[0.0][0][0] + 0.5
    moved = [_rel(got[1.0][2].params[n].detach().numpy(),
                  got[0.0][2].params[n].detach().numpy())
             for n in got[0.0][2].params if "router" in n]
    assert max(moved) > 1e-3


def test_drop_rate_tracks_capacity_factor():
    """cf 0.25 drops at least half the tokens, cf 8 none (JAX's
    ``test_moe_drop_rate_metric_surfaces``), each equal to JAX's."""
    _, params = _jax_model()
    batch = np.random.default_rng(0).integers(0, 64, (1, 4, 16)).astype(
        np.int32)
    drops = {}
    for cf in (0.25, 8.0):
        _, td, _ = _port_steps(params, batch, 1, moe_capacity_factor=cf)
        _, jd, _ = _jax_steps(params, batch, 1, moe_capacity_factor=cf)
        np.testing.assert_allclose(td, jd, atol=1e-6)
        drops[cf] = float(td[0])
    assert 0.0 <= drops[8.0] <= drops[0.25] <= 1.0
    assert drops[0.25] >= 0.5 and drops[8.0] <= 0.05


def test_global_routing_is_not_the_shards_routing():
    """Why the port routes over the batch group: at a capacity that drops
    tokens, JAX's loss on the global batch differs from the mean of its
    losses on the two halves (each half's capacity and slots its own)."""
    jm, params = _jax_model(moe_capacity_factor=0.5)
    tokens = jnp.asarray(np.random.default_rng(2).integers(
        0, 64, (8, 16)).astype(np.int32))

    def loss(t):
        logits = jm.apply({"params": params}, t, train=False)
        logp = jax.nn.log_softmax(logits[:, :-1])
        return -jnp.mean(jnp.take_along_axis(logp, t[:, 1:, None], -1))

    whole = float(loss(tokens))
    halves = (float(loss(tokens[:4])) + float(loss(tokens[4:]))) / 2
    assert abs(whole - halves) > 1e-4


# --- gloo ranks: data, expert, tensor and fsdp layouts -------------------------

def _compute_jax_layouts(init_params):
    """JAX's steps on the global batch for each (dispatch, cf) the layouts
    use, and one more step of the checkpoint source's configuration."""
    cfg = JaxGPT2Config(**TINY_MOE)
    tokens = moe_tokens()
    out = {}
    for dispatch, cf in {(d, c) for _, d, c, _ in LAYOUTS.values()}:
        jm = JaxGPT2(cfg=JaxGPT2Config(**{**TINY_MOE, "moe_dispatch": dispatch,
                                          "moe_capacity_factor": cf}))
        tx = optax.adamw(LR, weight_decay=WD)
        p = jax.tree_util.tree_map(jnp.array, init_params)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p,
                              opt_state=tx.init(p), batch_stats={},
                              apply_fn=jm.apply, tx=tx)
        step = jax_train_step(kind="lm", num_microbatches=ACCUM)
        losses, drops = [], []
        for b in tokens:
            state, m = step(state, {"tokens": jnp.asarray(b)})
            losses.append(float(m["loss"]))
            drops.append(float(m["moe_drop_rate"]))
        res = {"loss": np.array(losses), "drop": np.array(drops),
               "params": _named(state.params)}
        if (dispatch, cf) == LAYOUTS[CKPT_SRC][1:3]:
            _, m = step(state, {"tokens": jnp.asarray(
                moe_tokens(seed=6, steps=1)[0])})
            res["next_loss"] = float(m["loss"])
        out[(dispatch, cf)] = res
    del cfg
    return out


@pytest.fixture(scope="module")
def layouts(request, tmp_path_factory):
    """(JAX's results, rank 0's results) of the four-rank worker."""
    def compute():
        params = JaxGPT2(cfg=JaxGPT2Config(**TINY_MOE)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
            train=False)["params"]
        out = tmp_path_factory.mktemp("moe")
        np.savez(out / "init.npz", **_named(params))
        # The ranks run while JAX's references compile.
        ranks = launch_start(["tests/torch_moe_worker.py", "moe", str(out)],
                             4, timeout=300)
        try:
            ref = _compute_jax_layouts(params)
            ranks.wait()
        finally:
            ranks.kill()
        got = dict(np.load(out / "rank0.npz"))
        for r in range(1, 4):
            with np.load(out / f"rank{r}.npz") as z:
                got.update({f"rank{r}/{k}": z[k] for k in z.files
                            if k.endswith("/eval")})
        return ref, _named(params), got

    return shared(request, tmp_path_factory, "torch_moe_layouts", compute)


@pytest.mark.parametrize("label", sorted(LAYOUTS))
def test_layouts_match_jax_on_the_global_batch(layouts, label):
    """Three adamw steps of two microbatches under each layout: losses
    within rtol 1e-5 and drop rates within 1e-6 of JAX's on the global
    batch, parameters within relative 1e-4 (updates 1e-2)."""
    ref_all, init, got = layouts
    _, dispatch, cf, _ = LAYOUTS[label]
    ref = ref_all[(dispatch, cf)]
    np.testing.assert_allclose(got[f"{label}/loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got[f"{label}/drop"], ref["drop"], atol=1e-6)
    if cf < 1.0:
        assert got[f"{label}/drop"].min() > 0.25
    names = sorted(ref["params"])
    a = np.concatenate([got[f"{label}/p/{n}"].ravel() for n in names])
    b = np.concatenate([ref["params"][n].ravel() for n in names])
    p0 = np.concatenate([init[n].ravel() for n in names])
    assert _rel(a, b) < 1e-4
    assert _rel(a - p0, b - p0) < 1e-2


def test_expert_axis_divides_the_expert_state(layouts):
    """A rank holds E / ep experts: the expert-parallel state a rank is
    smaller than data parallelism's, and expert x tensor smaller still."""
    got = layouts[2]
    assert got["e2t2/bytes"] < got["d2e2/bytes"] < got["dp4/bytes"]
    assert got["ep4/bytes"] < got["d2e2/bytes"]


@pytest.mark.parametrize("target", ["dp4", "pp2d2"])
def test_checkpoint_restores_across_expert_layouts(layouts, target):
    """The expert-parallel (data 2 x expert 2) state's checkpoint, its
    expert leaves gathered on save, restores bit for bit into plain data
    parallelism and into PP 2 x data 2, and both take a step: data
    parallelism's loss is JAX's next step's (rtol 1e-5); the pipeline
    routes each data rank's rows alone (JAX's PP), so its loss is held
    near it only."""
    ref_all, _, got = layouts
    ref = ref_all[LAYOUTS[CKPT_SRC][1:3]]
    assert int(got[f"restore/{target}/step"]) == 3
    for n in ref["params"]:
        np.testing.assert_array_equal(got[f"restore/{target}/p/{n}"],
                                      got[f"{CKPT_SRC}/p/{n}"], err_msg=n)
    loss = float(got[f"restore/{target}/loss"])
    if target == "dp4":
        np.testing.assert_allclose(loss, ref["next_loss"], rtol=1e-5)
    else:
        assert abs(loss - ref["next_loss"]) < 0.05


def test_data_parallel_checkpoint_restores_into_experts(layouts):
    """The other way: data parallelism's state after that step, saved and
    restored into data 2 x expert 2 (each rank its experts), gathers
    back bit for bit."""
    got = layouts[2]
    assert int(got["restore/e2_from_dp4/step"]) == 4
    names = [k[len("restore/dp4/p4/"):] for k in got
             if k.startswith("restore/dp4/p4/")]
    assert any(".moe.w_up" in n for n in names)
    for n in names:
        np.testing.assert_array_equal(got[f"restore/e2_from_dp4/p/{n}"],
                                      got[f"restore/dp4/p4/{n}"], err_msg=n)


EVAL_LABELS = sorted(lb for lb, (_, _, cf, _) in LAYOUTS.items() if cf < 1.0)


def _jax_eval_loss(port_params: dict, dispatch: str, cf: float,
                   tokens: np.ndarray) -> float:
    jm = JaxGPT2(cfg=JaxGPT2Config(**{**TINY_MOE, "moe_dispatch": dispatch,
                                      "moe_capacity_factor": cf}))
    params = jax.tree_util.tree_map(jnp.asarray, gpt2_params_to_jax(
        {k: torch.from_numpy(v) for k, v in port_params.items()}))
    tx = optax.adamw(LR)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats={},
                          apply_fn=jm.apply, tx=tx)
    return float(jax_eval_step(kind="lm")(
        state, {"tokens": jnp.asarray(tokens)})["loss"])


@pytest.mark.parametrize("label", EVAL_LABELS)
def test_eval_routes_the_whole_batch_on_every_rank(layouts, label):
    """After train steps that route over the batch group, each rank
    evaluates the whole batch, at a capacity that drops tokens: the same
    loss on all four ranks, and JAX's eval loss of the same parameters on
    that batch (rtol 1e-5)."""
    _, _, got = layouts
    _, dispatch, cf, _ = LAYOUTS[label]
    losses = [float(got[f"{label}/eval"])] + [
        float(got[f"rank{r}/{label}/eval"]) for r in range(1, 4)]
    assert losses == [losses[0]] * 4, losses
    params = {k[len(f"{label}/p/"):]: v for k, v in got.items()
              if k.startswith(f"{label}/p/")}
    ref = _jax_eval_loss(params, dispatch, cf, moe_tokens(seed=7, steps=1)[0])
    np.testing.assert_allclose(losses[0], ref, rtol=1e-5)


def test_cli_eval_under_distributed_routes_the_whole_batch(layouts):
    """``--model gpt2_moe --distributed`` on four gloo ranks at a capacity
    that drops tokens, one train step then one eval batch: every rank
    computes the same eval loss, and it is JAX's eval loss of the trained
    parameters on that batch (rtol 1e-5)."""
    _, _, got = layouts
    losses = [got["cli/eval"].tolist()] + [
        got[f"rank{r}/cli/eval"].tolist() for r in range(1, 4)]
    assert len(losses[0]) == 1 and losses == [losses[0]] * 4, losses
    params = {k[len("cli/p/"):]: v for k, v in got.items()
              if k.startswith("cli/p/")}
    ref = _jax_eval_loss(params, "scatter", CLI_EVAL_CF, got["cli/batch"])
    np.testing.assert_allclose(losses[0][0], ref, rtol=1e-5)


# --- refusals and the CLI ------------------------------------------------------

def test_moe_refuses_decoding_and_sequence_parallelism():
    """JAX's refusals: a KV cache (serving) and sequence-parallel
    attention with MoE blocks."""
    model = create_model("gpt2_moe", device="cpu", cfg_overrides=SMALL)
    with pytest.raises(ValueError, match="decode mode supports the dense"):
        model.new_cache(1, 8)
    with pytest.raises(ValueError, match="decode mode supports the dense"):
        model.new_block_cache(4, 4)
    model.parallel = ModelParallel(sp_size=2)
    with pytest.raises(ValueError, match="MoE blocks are not SP-wired"):
        model(torch.zeros((1, 8), dtype=torch.long))


def test_moe_dispatch_override_parses_as_a_string():
    assert _parse_overrides("num_experts=4,moe_dispatch=einsum") == {
        "num_experts": 4, "moe_dispatch": "einsum"}
    with pytest.raises(ValueError, match="must be int/float/bool"):
        _parse_overrides("hidden_dim=7a68")


@pytest.mark.parametrize("extra", ["", ",moe_dispatch=einsum"])
def test_cli_trains_gpt2_moe(capsys, extra):
    """``--model gpt2_moe`` trains through the CLI (scatter unless the
    override says einsum); the epoch line carries ``moe_drop_rate``."""
    cli_main([
        "--use-cpu", "--model", "gpt2_moe", "--dataset", "synthetic-tokens",
        "--seq-len", "16", "--model-overrides",
        "num_layers=2,hidden_dim=32,num_heads=2,vocab_size=64,"
        "max_seq_len=16" + extra,
        "--batch-size", "4", "--steps-per-epoch", "2", "--num-workers", "0",
        "--learning-rate", "1e-3"])
    out = capsys.readouterr().out
    line = next(l for l in out.splitlines() if "moe_drop_rate=" in l)
    drop = float(line.split("moe_drop_rate=")[1].split()[0].rstrip("|"))
    assert 0.0 <= drop <= 1.0
    assert "training finished" in out
