"""GPipe x MoE (``parallel/gpt2_pipeline.py``) against the JAX package's
``PipelinedGPT2`` on the CPU (JAX's ``tests/test_pipeline.py:1220-1444``,
``test_moe_pipeline_*``): PP 2 x data 2 on four gloo ranks (one launch
of ``tests/torch_moe_worker.py moe_pipeline``) and JAX on a data 2 x
pipeline 2 mesh of four simulated devices, from the same weights.

- One batch of two microbatches: the loss (CE plus 0.01 times the aux
  loss summed over the MoE layers and averaged over the microbatches)
  and the whole gradients at JAX's tolerances (rtol 2e-4, atol 1e-5),
  the evaluation logits (2e-5) and the drop rate.
- Three train steps through ``make_pipeline_grad_fn``: losses within
  rtol 1e-5, drop rates, parameters.
- JAX's refusals: another schedule, an odd number of layers a stage,
  tensor, sequence or fsdp axes (and, in the port, an expert axis).

Each data rank routes its own rows of a microbatch, as JAX's GPipe does
on its batch-sharded microbatches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pytorch_distributed_training_tpu.comm.mesh import (
    MeshConfig as JaxMeshConfig, make_mesh as jax_make_mesh,
)
from pytorch_distributed_training_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config,
)
from pytorch_distributed_training_tpu.parallel import gpt2_pipeline as jgp
from pytorch_distributed_training_tpu.train import (
    TrainState as JaxTrainState, make_train_step as jax_train_step,
)
from pytorch_distributed_training_tpu_torch.comm.mesh import (
    MESH_AXES, Mesh,
)
from pytorch_distributed_training_tpu_torch.models import GPT2Config
from pytorch_distributed_training_tpu_torch.models.convert import (
    gpt2_params_from_jax,
)
from pytorch_distributed_training_tpu_torch.parallel.gpt2_pipeline import (
    PipelinedGPT2,
)
from tests.torch_dp_worker import launch_start
from tests.torch_moe_worker import LR, PP_MICRO, PP_MOE, WD, moe_tokens
from tests.torch_shared import shared

AUX_W = 0.01


def _named(tree) -> dict:
    return {k: v.numpy() for k, v in gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _compute(cfg, params):
    """JAX's side on ``params``."""
    mesh = jax_make_mesh(JaxMeshConfig(data=2, pipeline=2),
                         devices=jax.devices()[:4])
    pp = jgp.PipelinedGPT2(cfg, mesh, num_microbatches=PP_MICRO)
    split = jgp.split_gpt2_params(params, 2)
    batches = moe_tokens(seed=2, batch=4, vocab=PP_MOE["vocab_size"])
    t = jnp.asarray(batches[0])

    def loss_fn(p):
        logits, sown = pp.apply({"params": p}, t, train=False,
                                mutable=["losses", "moe_stats"])
        logp = jax.nn.log_softmax(logits[:, :-1])
        nll = -jnp.mean(jnp.take_along_axis(logp, t[:, 1:, None], -1))
        return (nll + AUX_W * sown["losses"]["moe_aux_loss"],
                (logits, sown["moe_stats"]["drop_rate"]))

    ref = {}
    with mesh:
        (loss, (logits, drop)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(split)
        ref["vg"] = (float(loss), float(drop), _named(jgp.merge_gpt2_params(
            jax.tree_util.tree_map(np.asarray, grads), 2)))
        ref["logits"] = np.asarray(logits)
        tx = optax.adamw(LR, weight_decay=WD)
        p = jax.tree_util.tree_map(jnp.array, split)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p,
                              opt_state=tx.init(p), batch_stats={},
                              apply_fn=pp.apply, tx=tx)
        step = jax_train_step(kind="lm")
        losses, drops = [], []
        for b in batches:
            state, m = step(state, {"tokens": jnp.asarray(b)})
            losses.append(float(m["loss"]))
            drops.append(float(m["moe_drop_rate"]))
        ref["steps"] = (np.array(losses), np.array(drops), _named(
            jgp.merge_gpt2_params(jax.tree_util.tree_map(
                np.asarray, state.params), 2)))
    return ref


@pytest.fixture(scope="module")
def pp_moe(request, tmp_path_factory, devices8):
    """(JAX's results, rank 0's and rank 2's: the two data rows)."""
    def compute():
        cfg = JaxGPT2Config(**PP_MOE)
        params = JaxGPT2(cfg=cfg).init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 8), jnp.int32),
                                       train=False)["params"]
        out = tmp_path_factory.mktemp("moe_pipeline")
        np.savez(out / "init_pp.npz", **_named(params))
        # The ranks run while JAX's references compile.
        ranks = launch_start(["tests/torch_moe_worker.py", "moe_pipeline",
                              str(out)], 4, timeout=300)
        try:
            ref = _compute(cfg, params)
            ranks.wait()
        finally:
            ranks.kill()
        return ref, [dict(np.load(out / f"rank{r}.npz")) for r in (0, 2)]

    return shared(request, tmp_path_factory, "torch_moe_pipeline", compute)


def test_pp_moe_loss_and_grads_match_jax(pp_moe):
    ref, (got, _) = pp_moe
    loss, drop, grads = ref["vg"]
    np.testing.assert_allclose(float(got["vg/loss"]), loss, rtol=1e-5)
    np.testing.assert_allclose(float(got["vg/drop"]), drop, atol=1e-6)
    for name, g in grads.items():
        np.testing.assert_allclose(got[f"vg/g/{name}"], g, rtol=2e-4,
                                   atol=1e-5, err_msg=name)


def test_pp_moe_logits_match_jax(pp_moe):
    """The evaluation path's logits, each data row's rows in place."""
    ref, ranks = pp_moe
    got = np.concatenate([r["logits"].reshape(PP_MICRO, -1, 16, 128)
                          for r in ranks], axis=1).reshape(-1, 16, 128)
    np.testing.assert_allclose(got, ref["logits"], rtol=2e-5, atol=2e-5)


def test_pp_moe_steps_match_jax(pp_moe):
    """Losses within rtol 1e-5 and drop rates within 1e-6 of JAX's, the
    parameters within relative 1e-4 (as ``test_torch_moe.py`` holds the
    sharded layouts: Adam moves a weight whose gradient is rounding noise
    by up to lr a step)."""
    ref, (got, _) = pp_moe
    losses, drops, params = ref["steps"]
    np.testing.assert_allclose(got["steps/loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["steps/drop"], drops, atol=1e-6)
    assert 0.0 <= got["steps/drop"].min() <= got["steps/drop"].max() <= 1.0
    names = sorted(params)
    a = np.concatenate([got[f"steps/p/{n}"].ravel() for n in names])
    b = np.concatenate([params[n].ravel() for n in names])
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-4


def _mesh(**axes) -> Mesh:
    """Rank 0's place on a mesh of those axes (no process group: the
    refusals come before any collective)."""
    shape = [axes.get(a, 1) for a in MESH_AXES]
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), 0)


REFUSALS = {
    "1f1b": (dict(pipeline=2), dict(schedule="1f1b"), {}, "gpipe only"),
    "interleaved": (dict(pipeline=2), dict(schedule="interleaved"), {},
                    "gpipe only"),
    "odd_layers": (dict(pipeline=2), {}, dict(num_layers=6),
                   "even number of layers"),
    "tensor": (dict(pipeline=2, tensor=2), {}, {}, "plain GPipe only"),
    "fsdp": (dict(pipeline=2, fsdp=2), {}, {}, "plain GPipe only"),
    "sequence": (dict(pipeline=2, sequence=2), {}, {}, "plain GPipe only"),
    "expert": (dict(pipeline=2, expert=2), {}, {}, "plain GPipe only"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_pp_moe_refusals(case):
    axes, kw, over, match = REFUSALS[case]
    cfg = GPT2Config(**{**PP_MOE, **over})
    with pytest.raises(ValueError, match=match):
        PipelinedGPT2(cfg, _mesh(**axes), device="meta", **kw)
