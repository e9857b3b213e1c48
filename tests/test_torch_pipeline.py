"""Pipeline parallelism of the PyTorch port (``--pipeline-parallel``,
``--pipeline-schedule``, ``--pp-compress``) against the JAX package, on
the CPU with gloo.

- The interleaved schedule's tables, element for element JAX's over a
  sweep of (S, V, M); split and merge of the stage-stacked parameters,
  plain and interleaved, equal to JAX's trees; the stage-boundary codec's
  int8 and bf16 payloads bitwise JAX's, the one-rank hop and its residual
  JAX's, and both byte models JAX's across a sweep.
- Four gloo ranks (``tests/torch_pp_worker.py``, one launch): JAX's tiny
  GPT-2 (``tests/test_pipeline.py::_pp_gpt2_cfg``: 4 layers, width 32, 4
  heads, vocab 128; 8 layers for interleaved at PP 4) on the JAX
  package's weights, under GPipe, 1F1B and interleaved at PP 4 and PP 2 x
  data 2: the loss and every gradient against JAX's ``PipelinedGPT2``
  (``value_and_grad``, ``jax.grad`` of ``apply`` for GPipe), the
  interleaved forward's logits, and three train steps against JAX's
  ``make_train_step`` (``grad_fn=make_pipeline_grad_fn`` for the manual
  schedules), at ``tests/test_pipeline.py``'s tolerances; ``--pp-compress``
  int8 (every schedule) and bf16 (GPipe): the loss and every gradient
  against JAX's within bounds set under a third of the compressed-to-
  uncompressed gap (interleaved int8 against the port's uncompressed
  gradients: JAX's stray from its own by 0.27), and a train step within
  JAX's band; stripe 2 bitwise stripe 1; dropout replay (1F1B's recomputed
  gradients equal GPipe's autograd through the same masks); a JAX-saved
  pipelined state continued by the port; a PP 4 checkpoint resumed under
  PP 4 (bitwise), PP 2 x data 2 and the plain model at world 1; the
  compositions at PP 2 with fsdp 2 and tensor 2 (all three schedules)
  and ring sequence 2 (GPipe) against JAX's on the same axes.
- The CLI: JAX's refusals (exit 2, its messages) and one torchrun run at
  PP 2.

The JAX references and the ranks' results are computed once a run and
shared by the test workers (a file lock beside the workers' temp dirs).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tpu.comm import compress as jcompress
from pytorch_distributed_training_tpu.comm.mesh import (
    MeshConfig as JaxMeshConfig, make_mesh as jax_make_mesh,
)
from pytorch_distributed_training_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config,
)
from pytorch_distributed_training_tpu.ops.losses import (
    cross_entropy_loss as jax_ce,
)
from pytorch_distributed_training_tpu.parallel import gpt2_pipeline as jgp
from pytorch_distributed_training_tpu.parallel import (
    pipeline_schedule as jsched,
)
from pytorch_distributed_training_tpu.train import (
    TrainState as JaxTrainState, make_train_step as jax_train_step,
)
from pytorch_distributed_training_tpu_torch.cli.main import main as cli_main
from pytorch_distributed_training_tpu_torch.comm import compress as tcompress
from pytorch_distributed_training_tpu_torch.comm.mesh import (
    MeshConfig, make_mesh,
)
from pytorch_distributed_training_tpu_torch.models import (
    GPT2Config as TorchGPT2Config, gpt2_params_from_jax, gpt2_params_to_jax,
)
from pytorch_distributed_training_tpu_torch.parallel import (
    gpt2_pipeline as tgp,
)
from pytorch_distributed_training_tpu_torch.parallel import (
    pipeline_schedule as tsched,
)
from tests.torch_dp_worker import launch
from tests.torch_shared import shared, shared_parts
from tests.torch_pp_worker import (
    COMPOSITION_MICRO, COMPOSITIONS, COMPRESSED_VG, LAYOUTS, LR, MICRO,
    SCHEDULES, STEP_LAYOUTS, TINY, WD, composition_tokens, tokens,
)

# tests/test_pipeline.py's tolerances.
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
STEP_RTOL = 1e-5
# Adam steps every weight by up to lr whatever its gradient: the key
# third of each qkv bias, whose gradient is rounding noise, moves by up to
# lr a step on either side (tests/test_torch_train.py), and the
# parameters after the steps are held leaf by leaf within this.
PARAM_ATOL = 2e-5
# JAX's int8 / bf16 band against the uncompressed step
# (test_pp_compress_int8_matches_uncompressed).
PP_BAND = 5e-3
# The compressed hops' gradients against JAX's, relative L2 over every
# leaf (readings at PP 2 x data 2: int8 5.3e-7 under gpipe, 5.9e-7 under
# 1f1b; bf16 3.6e-4 under gpipe, where a rounding that flips between the
# two implementations moves an element by a bf16 step).  JAX's own
# compressed gradients lie 6.8e-3 (gpipe int8), 7.4e-3 (1f1b int8) and
# 1.85e-3 (gpipe bf16) from its uncompressed ones: each bound is under a
# third of that gap, so a backward hop that skipped its codec or sent
# zeros fails.
COMPRESSED_GRAD_REL = {("gpipe", "int8"): 1e-5, ("1f1b", "int8"): 1e-5,
                       ("gpipe", "bf16"): 6e-4}
# Interleaved int8: the port's gradients against its uncompressed ones
# (reading 1.39e-2; the chunk crossings double the hops a microbatch
# takes).  JAX's interleaved int8 gradients are not the reference: they
# lie 0.27 from JAX's uncompressed gradients, because stage 0's
# cotangent residual commits the quantization error of the chunk-0
# input cotangent, which it sends on the wrap edge where no rank banks
# it and which is 60-100x the real cotangents (LayerNorm's 1/sigma on
# the small embedding output); the port sends zeros on that tick.
INTERLEAVED_INT8_REL = 2e-2
WORKER_TIMEOUT = 420


def _jax_cfg(layers: int = 4, width: int = 32) -> JaxGPT2Config:
    return JaxGPT2Config(**{**TINY, "num_layers": layers,
                            "hidden_dim": width})


def _named(tree) -> dict:
    return {k: v.numpy() for k, v in gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _plain_tree(x):
    """Nested dicts and (named) tuples of numpy, without optax's types."""
    if isinstance(x, dict):
        return {k: _plain_tree(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_plain_tree(v) for v in x)
    return np.asarray(x)


def _jax_pp(sched, S, V, layers=4, mode="none"):
    mesh = jax_make_mesh(JaxMeshConfig(data=-1, pipeline=S))
    pp = jgp.PipelinedGPT2(_jax_cfg(layers), mesh, num_microbatches=MICRO,
                           schedule=sched, num_chunks=V, pp_compress=mode)
    return pp, mesh


def _jax_split(init, sched, S, V):
    if sched == "interleaved":
        return jgp.split_gpt2_params_interleaved(init, S, V)
    return jgp.split_gpt2_params(init, S)


def _jax_merge(tree, sched, S, V):
    tree = jax.tree_util.tree_map(np.asarray, tree)
    if sched == "interleaved":
        return jgp.merge_gpt2_params_interleaved(tree, S, V)
    return jgp.merge_gpt2_params(tree, S)


def _jax_value_and_grad(init, sched, S, V, layers, batch, mode="none"):
    pp, mesh = _jax_pp(sched, S, V, layers, mode)
    params = _jax_split(init, sched, S, V)
    t = jnp.asarray(batch)
    with mesh:
        if sched == "gpipe":
            def loss_fn(p):
                logits = pp.apply({"params": p}, t, train=False)
                return jax_ce(logits[:, :-1], t[:, 1:])

            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        else:
            loss, grads = jax.jit(pp.value_and_grad)(params, t)
    return float(loss), _named(_jax_merge(grads, sched, S, V))


def _jax_steps(init, sched, S, V, batches, mode="none", state=None):
    """JAX's train step on the pipelined model: the losses, the whole
    parameters after each step, and the final state."""
    pp, mesh = _jax_pp(sched, S, V, mode=mode)
    tx = optax.adamw(LR, weight_decay=WD)
    if state is None:
        # The step donates its state: copies, not the init's arrays.
        p = jax.tree_util.tree_map(jnp.array, _jax_split(init, sched, S, V))
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p,
                              opt_state=tx.init(p), batch_stats={},
                              apply_fn=pp.apply, tx=tx)
    grad_fn = None if sched == "gpipe" else jgp.make_pipeline_grad_fn(pp)
    step = jax_train_step(kind="lm", grad_fn=grad_fn)
    losses, params = [], []
    with mesh:
        for b in batches:
            state, m = step(state, {"tokens": jnp.asarray(b)})
            losses.append(float(m["loss"]))
            params.append(_named(_jax_merge(state.params, sched, S, V)))
    return np.array(losses), params, state


def _jax_composition(label: str) -> tuple:
    """JAX's PipelinedGPT2 at PP 2 with an fsdp, tensor or sequence axis
    of 2 (data the rest of the 8 devices), ``COMPOSITIONS[label]``: loss
    and gradients of one batch (2 microbatches), merged to the plain tree
    (``_pp_tp`` layouts, the permuted qkv, where the stage body is the
    manual block)."""
    t = jnp.asarray(composition_tokens())
    sched, axis, width = COMPOSITIONS[label]
    cfg = _jax_cfg(4, width)
    init = JaxGPT2(cfg=cfg).init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32),
                                 train=False)["params"]
    mesh = jax_make_mesh(JaxMeshConfig(data=-1, pipeline=2, **{axis: 2}))
    V = 2 if sched == "interleaved" else 0
    pp = jgp.PipelinedGPT2(cfg, mesh, num_microbatches=COMPOSITION_MICRO,
                           schedule=sched, num_chunks=V or 2)
    manual = axis in ("tensor", "sequence")
    if manual:
        params = jgp.split_gpt2_params_pp_tp(init, 2, cfg.num_heads,
                                             num_chunks=V)
    else:
        params = _jax_split(init, sched, 2, V)
    with mesh:
        if sched == "gpipe":
            def loss_fn(p):
                logits = pp.apply({"params": p}, t, train=False)
                return jax_ce(logits[:, :-1], t[:, 1:])

            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        else:
            loss, grads = jax.jit(pp.value_and_grad)(params, t)
    grads = jax.tree_util.tree_map(np.asarray, grads)
    if manual:
        merged = jgp.merge_gpt2_params_pp_tp(grads, 2, cfg.num_heads,
                                             num_chunks=V)
    else:
        merged = _jax_merge(grads, sched, 2, V)
    return float(loss), _named(merged)


def _jax_inputs() -> dict:
    """The batches and the inits (4 and 8 layers, width 256)."""
    batches = tokens()
    inits = {}
    for layers in (4, 8):
        jm = JaxGPT2(cfg=_jax_cfg(layers))
        inits[layers] = jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32),
                                train=False)["params"]
    return {"batches": batches, "inits": inits,
            "init_w256": _named(JaxGPT2(cfg=_jax_cfg(4, 256)).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                train=False)["params"])}


def _jax_state(inputs: dict) -> dict:
    """JAX's 1F1B state after one step, carried to the port's ranks."""
    _, _, one = _jax_steps(inputs["inits"][4], "1f1b", 2, 1,
                           inputs["batches"][:1])
    return {"step": np.asarray(one.step),
            "params": _plain_tree(jax.tree_util.tree_map(
                np.asarray, one.params)),
            "opt_state": _plain_tree(jax.tree_util.tree_map(
                np.asarray, one.opt_state)),
            "batch_stats": {}}


def _jax_train(inputs: dict, sched: str) -> dict:
    """JAX's train steps under ``sched``, compressed and not."""
    batches, inits = inputs["batches"], inputs["inits"]
    V = 2 if sched == "interleaved" else 1
    losses, params, _ = _jax_steps(inits[4], sched, 2, V, batches)
    ref = {"steps": (losses, params[-1]),
           "pp": {(sched, "none"): (losses[:1], params[0])},
           # JAX's own continuation of the 1F1B state carried to the port.
           "jax_continued": (losses[1:], params[-1])}
    for mode in ("int8", "bf16") if sched == "gpipe" else ("int8",):
        losses_c, params_c, _ = _jax_steps(inits[4], sched, 2, V,
                                           batches[:1], mode=mode)
        ref["pp"][(sched, mode)] = (losses_c, params_c[0])
    return ref


def _jax_logits(inputs: dict) -> np.ndarray:
    pp, mesh = _jax_pp("interleaved", 2, 2)
    with mesh:
        return np.asarray(jax.jit(
            lambda p, t: pp.apply({"params": p}, t, train=False))(
                _jax_split(inputs["inits"][4], "interleaved", 2, 2),
                jnp.asarray(inputs["batches"][0])))


def _vg_part(label: str) -> str:
    return "vg_" + "_".join(map(str, LAYOUTS[label]))


def _parts(inputs: dict, tmp_path_factory) -> dict:
    """Every part of the pipeline tests' references by name: JAX's loss
    and gradients a layout, its compressed ones, its train steps a
    schedule, a composition each, the interleaved logits, and the port's
    four ranks (``_launch_ranks``)."""
    batch, inits = inputs["batches"][0], inputs["inits"]

    def vg(sched, S, V, layers, mode="none"):
        return lambda: _jax_value_and_grad(inits[layers], sched, S, V,
                                           layers, batch, mode)

    parts = {"ranks": lambda: _launch_ranks(inputs, tmp_path_factory)}
    for label, key in LAYOUTS.items():
        parts[_vg_part(label)] = vg(*key)
    for sched, mode in COMPRESSED_VG:
        parts[f"vgc_{sched}_{mode}"] = vg(
            sched, 2, 2 if sched == "interleaved" else 1, 4, mode)
    for sched in SCHEDULES:
        parts[f"train_{sched}"] = (lambda sched=sched:
                                   _jax_train(inputs, sched))
    for label in COMPOSITIONS:
        parts[f"comp_{label}"] = lambda label=label: _jax_composition(label)
    parts["logits"] = lambda: _jax_logits(inputs)
    return parts


class _Table:
    """``ref[key][k]`` read from the part ``name(k)``."""

    def __init__(self, parts: dict, name, pick=None):
        self.parts, self.name = parts, name
        self.pick = pick or (lambda part, k: part)

    def __getitem__(self, k):
        return self.pick(self.parts[self.name(k)], k)


def _jax_ref_view(inputs: dict, parts: dict) -> dict:
    """JAX's side by the keys the tests read."""
    return {
        "init": {k: _named(v) for k, v in inputs["inits"].items()},
        "init_w256": inputs["init_w256"],
        "logits": parts["logits"],
        "comp": _Table(parts, lambda label: f"comp_{label}"),
        "vg": _Table(parts, _vg_part),
        "vgc": _Table(parts, lambda k: "vgc_" + "_".join(k)),
        "steps": _Table(parts, lambda sched: f"train_{sched}",
                        lambda part, _: part["steps"]),
        "pp": _Table(parts, lambda k: f"train_{k[0]}",
                     lambda part, k: part["pp"][k]),
        "jax_continued": parts["train_1f1b"]["jax_continued"],
    }


def _launch_ranks(inputs: dict, tmp_path_factory) -> dict:
    """Rank 0's results of the four-rank worker."""
    inits = inputs["inits"]
    out = tmp_path_factory.mktemp("pipeline")
    np.savez(out / "init.npz", **_named(inits[4]))
    np.savez(out / "init8.npz", **_named(inits[8]))
    np.savez(out / "init_w32.npz", **_named(inits[4]))
    np.savez(out / "init_w256.npz", **inputs["init_w256"])
    with open(out / "jax_state.pkl", "wb") as f:
        pickle.dump(_jax_state(inputs), f)
    launch(["tests/torch_pp_worker.py", "pipeline", str(out)], 4,
           timeout=WORKER_TIMEOUT)
    return dict(np.load(out / "rank0.npz"))


@pytest.fixture(scope="module")
def jax_inputs(devices8, tmp_path_factory, request):
    return shared(request, tmp_path_factory, "torch_pp_inputs", _jax_inputs)


@pytest.fixture(scope="module")
def pp_parts(jax_inputs, tmp_path_factory, request):
    """Every part once per run; the xdist workers that reach them at once
    compute different parts side by side (``shared_parts``)."""
    return shared_parts(request, tmp_path_factory, "torch_pp",
                        _parts(jax_inputs, tmp_path_factory))


@pytest.fixture(scope="module")
def jax_ref(jax_inputs, pp_parts):
    return _jax_ref_view(jax_inputs, pp_parts)


@pytest.fixture(scope="module")
def ranks(pp_parts):
    """Rank 0's results of the four-rank worker."""
    return pp_parts["ranks"]


def _sub(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def _assert_params(got: dict, ref: dict, steps: int = 3,
                   what: str = "") -> None:
    """Leaf by leaf within PARAM_ATOL, the key third of each qkv bias
    within the ``steps`` x lr Adam can move it (its gradient is zero in
    exact arithmetic: ``tests/test_torch_train.py::_assert_params_close``)."""
    assert sorted(got) == sorted(ref)
    for k in ref:
        x, y = ref[k], got[k]
        if k.endswith("attn.qkv.bias"):
            d = x.shape[0] // 3
            np.testing.assert_allclose(y[d:2 * d], x[d:2 * d], rtol=0,
                                       atol=steps * LR,
                                       err_msg=f"{what} {k} key")
            x = np.concatenate([x[:d], x[2 * d:]])
            y = np.concatenate([y[:d], y[2 * d:]])
        np.testing.assert_allclose(y, x, rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{what} {k}")


# --- schedule tables, split/merge, the codec, the byte models -------------

SWEEP = [(1, 1, 1), (2, 1, 3), (2, 2, 2), (2, 2, 5), (3, 2, 4), (4, 2, 8),
         (4, 3, 8), (3, 4, 7), (4, 4, 4)]


@pytest.mark.parametrize("S,V,M", SWEEP)
def test_interleaved_tables_match_jax(S, V, M):
    want = jsched.make_interleaved_schedule(S, V, M)
    got = tsched.make_interleaved_schedule(S, V, M)
    for field in want.__dataclass_fields__:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=field)
            assert a.dtype == b.dtype, field
        else:
            assert a == b, field
    assert got.bubble_fraction() == want.bubble_fraction()


@pytest.mark.parametrize("S,V,layers", [(2, None, 4), (4, None, 4),
                                        (2, 2, 4), (4, 2, 8)])
def test_split_and_merge_match_jax(jax_ref, S, V, layers):
    init = jax.tree_util.tree_map(jnp.asarray, gpt2_params_to_jax(
        {k: torch.from_numpy(v) for k, v in jax_ref["init"][layers].items()}))
    plain = {k: torch.from_numpy(v) for k, v in jax_ref["init"][layers].items()}
    if V is None:
        want = jgp.split_gpt2_params(init, S)
        got = tgp.split_gpt2_params(plain, S)
        back = tgp.merge_gpt2_params(got, S)
    else:
        want = jgp.split_gpt2_params_interleaved(init, S, V)
        got = tgp.split_gpt2_params_interleaved(plain, S, V)
        back = tgp.merge_gpt2_params_interleaved(got, S, V)
    want = _named(want)
    model = tgp.PipelinedGPT2(
        TorchGPT2Config(**{**TINY, "num_layers": layers}), _mesh_of(S),
        schedule="interleaved" if V else "gpipe", num_chunks=V or 2,
        device="meta")
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(t.shape) for n, t in got.items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert list(back) == list(plain)
    for k in plain:
        np.testing.assert_array_equal(back[k].numpy(), plain[k].numpy())
    assert tgp.to_plain(got).keys() == plain.keys()


def _mesh_of(S: int):
    return make_mesh(MeshConfig(data=-1, pipeline=S), world=S, rank=0)


def _boundary_input(seed: int = 0):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((2, 16, 32)) * 3).astype(np.float32)
    y[0, 3] = 0.0                      # a row of zeros: the tiny scale
    resid = (rng.standard_normal((2, 16, 32)) * 0.01).astype(np.float32)
    return y, resid


def test_int8_boundary_payload_bitwise_jax():
    y, resid = _boundary_input()
    err = y + resid
    jq, js = jcompress.encode_int8(jcompress._rows2d(jnp.asarray(err)))
    tq, ts = tcompress.encode_int8(tcompress._rows2d(torch.from_numpy(err)))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_bf16_boundary_payload_bitwise_jax():
    y, _ = _boundary_input(1)
    want = np.asarray(jax.lax.bitcast_convert_type(
        jnp.asarray(y).astype(jnp.bfloat16), jnp.uint16))
    got = torch.from_numpy(y).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got.view(np.uint16), want)


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_one_rank_hop_matches_jax(mode):
    """The hop of a ring of one rank (group None): what arrives and the
    error-feedback residual, as JAX's codec computes them."""
    y, resid = _boundary_input(2)
    got, new = tcompress.boundary_permute(
        torch.from_numpy(y), torch.from_numpy(resid) if mode == "int8"
        else (), None, [(0, 0)], mode)
    if mode == "none":
        want = y
    elif mode == "bf16":
        want = np.asarray(jnp.asarray(y).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    else:
        err = jnp.asarray(y) + jnp.asarray(resid)
        want = np.asarray(jcompress._qdq_int8(err))
        np.testing.assert_array_equal(
            new.numpy(), np.asarray(err - jcompress._qdq_int8(err)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_byte_models_match_jax(schedule):
    for mode in ("none", "bf16", "int8"):
        for rows, cols, item in ((4, 32, 4), (2048, 768, 2), (3, 7, 4)):
            assert tcompress.boundary_payload_bytes(rows, cols, mode, item) \
                == jcompress.boundary_payload_bytes(rows, cols, mode, item)
        for S, M, V in ((2, 4, 2), (4, 8, 3), (4, 8, 2), (3, 5, 1)):
            kw = dict(schedule=schedule, num_stages=S, num_microbatches=M,
                      microbatch_rows=2, seq_len=1024, hidden=768,
                      act_itemsize=2, mode=mode,
                      num_chunks=V if schedule == "interleaved" else 1)
            assert tcompress.pp_boundary_bytes_per_step(**kw) == \
                jcompress.pp_boundary_bytes_per_step(**kw)


def test_resolve_channel_stripe_matches_jax():
    from pytorch_distributed_training_tpu.comm.striping import (
        resolve_channel_stripe as jres,
    )
    from pytorch_distributed_training_tpu_torch.comm.striping import (
        resolve_channel_stripe as tres,
    )

    for v in (None, "off", "1", 1, "auto", "3", 7):
        assert tres(v) == jres(v)
    for bad in ("0", -2):
        with pytest.raises(ValueError, match="lane count"):
            tres(bad)


def test_constructor_refusals_match_jax(devices8):
    jmesh = jax_make_mesh(JaxMeshConfig(data=-1, pipeline=2))
    for kw, cfg in ((dict(schedule="zigzag"), {}),
                    (dict(pp_compress="int4"), {}),
                    ({}, dict(tie_embeddings=False)),
                    ({}, dict(num_layers=3)),
                    (dict(schedule="interleaved", num_chunks=4), {})):
        with pytest.raises(ValueError) as want:
            jgp.PipelinedGPT2(JaxGPT2Config(**{**TINY, **cfg}), jmesh, **kw)
        with pytest.raises(ValueError) as got:
            tgp.PipelinedGPT2(TorchGPT2Config(**{**TINY, **cfg}), _mesh_of(2),
                              device="meta", **kw)
        assert str(got.value) == str(want.value)


# --- the engines against JAX (four gloo ranks) ----------------------------

@pytest.mark.parametrize("label", sorted(LAYOUTS))
def test_value_and_grad_matches_jax(jax_ref, ranks, label):
    loss, grads = jax_ref["vg"][label]
    np.testing.assert_allclose(float(ranks[f"vg/{label}/loss"]), loss,
                               rtol=LOSS_RTOL)
    got = _sub(ranks, f"vg/{label}/g/")
    assert sorted(got) == sorted(grads)
    for k in grads:
        np.testing.assert_allclose(got[k], grads[k], **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("label", sorted(COMPOSITIONS))
def test_composition_matches_jax(jax_ref, ranks, label):
    """PP 2 with fsdp 2 (all three schedules), tensor 2 (all three) and
    ring sequence 2 (GPipe), four ranks, against JAX's PipelinedGPT2 on
    the same axes at JAX's composition tolerances (loss rtol 1e-5,
    gradients rtol 5e-4 / atol 1e-5)."""
    loss, grads = jax_ref["comp"][label]
    np.testing.assert_allclose(float(ranks[f"comp/{label}/loss"]), loss,
                               rtol=LOSS_RTOL)
    got = _sub(ranks, f"comp/{label}/g/")
    assert sorted(got) == sorted(grads)
    for k in grads:
        np.testing.assert_allclose(got[k], grads[k], rtol=5e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("label", ["gpipe_remat_pp2d2",
                                   "gpipe_accum2_pp2d2"])
def test_gpipe_remat_and_accumulation_match_jax(jax_ref, ranks, label):
    """GPipe with each tick's stage call checkpointed, and GPipe under
    ``--accum-steps 2`` (two pipeline passes of 2 microbatches, the
    gradients averaged): the same batch's loss and gradients as JAX's
    GPipe."""
    loss, grads = jax_ref["vg"]["gpipe_pp2d2"]
    np.testing.assert_allclose(float(ranks[f"vg/{label}/loss"]), loss,
                               rtol=LOSS_RTOL)
    got = _sub(ranks, f"vg/{label}/g/")
    assert sorted(got) == sorted(grads)
    for k in grads:
        np.testing.assert_allclose(got[k], grads[k], **GRAD_TOL, err_msg=k)


def test_interleaved_forward_logits_match_jax(jax_ref, ranks):
    np.testing.assert_allclose(ranks["logits/interleaved_pp2d2"],
                               jax_ref["logits"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("label", STEP_LAYOUTS)
def test_three_steps_match_jax(jax_ref, ranks, label):
    losses, params = jax_ref["steps"][LAYOUTS[label][0]]
    np.testing.assert_allclose(ranks[f"steps/{label}/loss"], losses,
                               rtol=STEP_RTOL)
    _assert_params(_sub(ranks, f"steps/{label}/p/"), params, what=label)


def _rel_l2(got: dict, ref: dict) -> float:
    names = sorted(ref)
    x = np.concatenate([got[n].ravel() for n in names])
    y = np.concatenate([ref[n].ravel() for n in names])
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


@pytest.mark.parametrize("sched,mode", COMPRESSED_VG)
def test_compressed_gradients_match_jax(jax_ref, ranks, sched, mode):
    """The loss and every gradient of one batch through compressed hops
    (the forward codec and the backward's cotangent hops), PP 2 x data 2,
    against JAX's ``PipelinedGPT2(pp_compress=...)`` (``jax.grad`` of
    ``apply`` for GPipe, ``value_and_grad`` for the manual schedules)
    within ``COMPRESSED_GRAD_REL``; interleaved int8 against the port's
    uncompressed gradients within ``INTERLEAVED_INT8_REL``."""
    loss, grads = jax_ref["vgc"][(sched, mode)]
    _, plain = jax_ref["vg"][f"{sched}_pp2d2"]
    tag = f"vgc/{sched}/{mode}"
    np.testing.assert_allclose(float(ranks[f"{tag}/loss"]), loss,
                               rtol=LOSS_RTOL)
    got = _sub(ranks, f"{tag}/g/")
    assert sorted(got) == sorted(grads)
    if (sched, mode) in COMPRESSED_GRAD_REL:
        bound = COMPRESSED_GRAD_REL[sched, mode]
        assert bound < _rel_l2(grads, plain) / 3
        assert _rel_l2(got, grads) <= bound
        if mode == "int8":
            for k in grads:
                np.testing.assert_allclose(got[k], grads[k], **GRAD_TOL,
                                           err_msg=k)
    else:
        assert _rel_l2(got, plain) <= INTERLEAVED_INT8_REL
    assert _rel_l2(got, plain) > 1e-4      # the codec ran


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_one_rank_hop_backward_matches_jax(mode):
    """The cotangent a one-rank compressed hop sends back: JAX's codec of
    the cotangent (its ``_permute_int8`` / ``_permute_bf16`` vjps encode
    and decode the cotangent as the forward does its payload)."""
    y, resid = _boundary_input(3)
    ct, _ = _boundary_input(4)
    x = torch.from_numpy(y).requires_grad_()
    out, _ = tcompress.boundary_permute(
        x, torch.from_numpy(resid) if mode == "int8" else (), None,
        [(0, 0)], mode)
    out.backward(torch.from_numpy(ct))
    if mode == "bf16":
        want = np.asarray(jnp.asarray(ct).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    else:
        q, scale = jcompress.encode_int8(jcompress._rows2d(jnp.asarray(ct)))
        want = np.asarray(jcompress.decode_int8(q, scale)).reshape(ct.shape)
    np.testing.assert_array_equal(x.grad.numpy(), want)


def _assert_band(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref)
    assert max(np.abs(got[k] - ref[k]).max() for k in ref) < PP_BAND


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_pp_compress_int8_matches_jax(jax_ref, ranks, schedule):
    """The port's int8 hops against JAX's through a train step: the
    loss of the step at the loss tolerance, the parameters after its Adam
    step within JAX's int8 band; and the port's int8 within that band of
    its uncompressed step, as JAX holds its own.  (Adam's first step moves
    each weight by lr times the sign of its gradient, so this band checks
    the step's wiring, not the gradients:
    ``test_compressed_gradients_match_jax`` holds those.)"""
    loss, params = jax_ref["pp"][(schedule, "int8")]
    tag = f"pp/{schedule}/int8/1"
    np.testing.assert_allclose(ranks[f"{tag}/loss"], loss, rtol=LOSS_RTOL)
    _assert_band(_sub(ranks, f"{tag}/p/"), params)
    assert abs(float(ranks[f"{tag}/loss"][0])
               - float(ranks[f"pp/{schedule}/none/1/loss"][0])) < PP_BAND
    _assert_band(_sub(ranks, f"{tag}/p/"),
                 _sub(ranks, f"pp/{schedule}/none/1/p/"))


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_pp_compress_bf16_close(jax_ref, ranks, schedule):
    """bf16 hops within JAX's band of the uncompressed step; under GPipe
    (JAX's bf16 test) against JAX's bf16 step as int8 is."""
    tag = f"pp/{schedule}/bf16/1"
    assert abs(float(ranks[f"{tag}/loss"][0])
               - float(ranks[f"pp/{schedule}/none/1/loss"][0])) < PP_BAND
    _assert_band(_sub(ranks, f"{tag}/p/"),
                 _sub(ranks, f"pp/{schedule}/none/1/p/"))
    if schedule == "gpipe":
        loss, params = jax_ref["pp"][("gpipe", "bf16")]
        np.testing.assert_allclose(ranks[f"{tag}/loss"], loss,
                                   rtol=LOSS_RTOL)
        _assert_band(_sub(ranks, f"{tag}/p/"), params)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_stripe_2_bitwise_stripe_1(ranks, schedule, mode):
    one, two = (f"pp/{schedule}/{mode}/{k}" for k in (1, 2))
    np.testing.assert_array_equal(ranks[f"{two}/loss"], ranks[f"{one}/loss"])
    a, b = _sub(ranks, f"{one}/p/"), _sub(ranks, f"{two}/p/")
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_uncompressed_step_matches_jax(jax_ref, ranks):
    for schedule in ("gpipe", "1f1b", "interleaved"):
        loss, params = jax_ref["pp"][(schedule, "none")]
        np.testing.assert_allclose(ranks[f"pp/{schedule}/none/1/loss"],
                                   loss, rtol=LOSS_RTOL)
        _assert_params(_sub(ranks, f"pp/{schedule}/none/1/p/"), params,
                       steps=1,
                       what=schedule)


def test_dropout_replay(ranks):
    """1F1B recomputes each stage in its backward tick; with dropout its
    gradients equal GPipe's, which are autograd through the masks the
    forward drew (the same (seed, step, microbatch, stage, layer)
    seeds)."""
    np.testing.assert_allclose(float(ranks["drop/1f1b/loss"]),
                               float(ranks["drop/gpipe/loss"]),
                               rtol=LOSS_RTOL)
    a, b = _sub(ranks, "drop/gpipe/g/"), _sub(ranks, "drop/1f1b/g/")
    for k in a:
        np.testing.assert_allclose(b[k], a[k], **GRAD_TOL, err_msg=k)
    # Dropout changed the function (the masks are not all ones).
    assert float(ranks["drop/gpipe/loss"]) != float(
        ranks["vg/gpipe_pp2d2/loss"])


def test_interleaved_dropout_trains_and_replays(ranks):
    a = ranks["drop/interleaved/0/loss"]
    np.testing.assert_array_equal(ranks["drop/interleaved/1/loss"], a)
    assert np.isfinite(a).all() and a[-1] < a[0]


def test_jax_saved_state_continued(jax_ref, ranks):
    losses, params = jax_ref["jax_continued"]
    assert int(ranks["jaxstate/step"]) == 3
    np.testing.assert_allclose(ranks["jaxstate/loss"], losses,
                               rtol=STEP_RTOL)
    _assert_params(_sub(ranks, "jaxstate/p/"), params, steps=2,
                   what="continued")


def test_train_state_to_jax_gives_jaxs_pipelined_tree(jax_ref, ranks):
    """The continued port state carried back (``train_state_to_jax``):
    JAX's pipelined tree, ``{"outer", "stages"}`` with (S, in, out)
    kernels, whose merge is the port's whole parameters bitwise; the
    Adam first moment's tree alike."""
    for part, prefix in (("/params", "jaxstate/p/"), ("/mu", None)):
        tree: dict = {}
        head = f"jaxstate/tojax{part}/"
        for key, v in ranks.items():
            if key.startswith(head):
                node = tree
                *path, leaf = key[len(head):].split("/")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = v
        assert set(tree) == {"outer", "stages"}
        assert tree["stages"]["layer_0"]["attn"]["qkv"]["kernel"].shape == \
            (2, 32, 96)
        named = _named(_jax_merge(tree, "1f1b", 2, 1))
        if prefix is not None:
            want = _sub(ranks, prefix)
            assert sorted(named) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(named[k], want[k], err_msg=k)


def test_checkpoint_pp4_resumes_bitwise_under_pp4(ranks):
    assert int(ranks["ckpt/pp4/step"]) == 2
    np.testing.assert_array_equal(ranks["ckpt/pp4/loss"],
                                  ranks["ckpt/straight/loss"])
    a, b = _sub(ranks, "ckpt/straight/p/"), _sub(ranks, "ckpt/pp4/p/")
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("label", ["pp2d2", "plain"])
def test_checkpoint_pp4_resumes_in_other_layouts(ranks, label):
    assert int(ranks[f"ckpt/{label}/step"]) == 2
    np.testing.assert_allclose(ranks[f"ckpt/{label}/loss"],
                               ranks["ckpt/straight/loss"], rtol=STEP_RTOL)
    if label == "pp2d2":
        _assert_params(_sub(ranks, "ckpt/pp2d2/p/"),
                       _sub(ranks, "ckpt/straight/p/"), what=label)


# --- the CLI ----------------------------------------------------------------

TINY_OVERRIDES = ("num_layers=4,hidden_dim=32,num_heads=4,vocab_size=128,"
                  "max_seq_len=32")
REFUSALS = [
    (["--pp-compress", "int8"],
     "--pp-compress compresses pipeline stage-boundary payloads; it needs "
     "--pipeline-parallel > 1"),
    (["--pipeline-parallel", "2", "--pipeline-schedule", "1f1b",
      "--sequence-parallel", "2"],
     "--sequence-parallel composes with --pipeline-parallel only as ring "
     "SP under --pipeline-schedule gpipe"),
    (["--pipeline-parallel", "2", "--sequence-parallel", "2",
      "--sequence-parallel-mode", "ulysses"],
     "--sequence-parallel composes with --pipeline-parallel only as ring "
     "SP"),
    (["--pipeline-parallel", "2", "--model", "resnet18"],
     "--pipeline-parallel requires a transformer LM (--model gpt2)"),
    (["--pipeline-parallel", "2", "--fsdp", "2", "--tensor-parallel", "2"],
     "--fsdp and --tensor-parallel do not combine under "
     "--pipeline-parallel (both split the same matmul dims)"),
    (["--pipeline-parallel", "2", "--ce-chunk", "8"],
     "--ce-chunk is not wired through the pipelined model "
     "(PipelinedGPT2 has no hidden-state output)"),
    (["--pipeline-parallel", "2", "--pipeline-schedule", "1f1b",
      "--accum-steps", "2"],
     "--accum-steps does not compose with --pipeline-schedule 1f1b (the "
     "schedule owns microbatching; size --pipeline-microbatches instead)"),
    (["--pipeline-parallel", "2", "--zero1"],
     "--zero1 composes with data parallelism only"),
    (["--pipeline-parallel", "2", "--grad-sync-stripe", "2"],
     "--grad-sync-stripe lanes the explicit two-tier sync's DCN hop (and "
     "--pp-compress stage boundaries)"),
]


@pytest.mark.parametrize("extra,message", REFUSALS,
                         ids=[str(i) for i in range(len(REFUSALS))])
def test_cli_refusals(capsys, extra, message):
    argv = ["--use-cpu", "--model", "gpt2", "--dataset", "synthetic-tokens",
            "--model-overrides", TINY_OVERRIDES, "--seq-len", "16", *extra]
    if "--model" in extra:
        argv = argv[:1] + argv[3:]
        argv[argv.index("synthetic-tokens")] = "cifar10"
    with pytest.raises(SystemExit) as e:
        cli_main(argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err.replace("\n", " ")


@pytest.mark.parametrize("overrides,extra,message", [
    ("num_layers=3", [], "3 layers not divisible by 2 pipeline stages"),
    ("num_layers=4", ["--pipeline-schedule", "interleaved",
                      "--pipeline-chunks", "4"],
     "4 layers not divisible by 2 pipeline stages x 4 chunks"),
    ("num_layers=4,tie_embeddings=false", [],
     "pipelined GPT-2 requires tied embeddings"),
])
def test_cli_model_refusals(capsys, overrides, extra, message):
    """The refusals that need the model (JAX's PipelinedGPT2 messages) as
    usage errors, from the CLI's ``_pipelined`` on rank 0
    of a two-rank mesh."""
    from pytorch_distributed_training_tpu_torch.cli.main import (
        _parse_overrides, _pipelined, build_parser,
    )
    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.train import make_policy

    args = build_parser().parse_args(
        ["--model", "gpt2", "--pipeline-parallel", "2", *extra])
    over = _parse_overrides(TINY_OVERRIDES.replace("num_layers=4",
                                                   overrides))
    net = create_model("gpt2", device="cpu", cfg_overrides=over)
    with pytest.raises(SystemExit) as e:
        _pipelined(args, net, _mesh_of(2), make_policy("f32"))
    assert e.value.code == 2
    assert message in capsys.readouterr().err.replace("\n", " ")


def test_cli_torchrun_pp2(tmp_path):
    """``--distributed --pipeline-parallel 2 --pipeline-schedule 1f1b
    --pp-compress int8 --metrics-dir`` under torchrun, two CPU ranks: the
    mesh line, the summary naming the stages and the schedule, and the
    byte model: each rank's event log holds the ``pp_compress_model``
    record, field for field the JAX CLI's for this configuration
    (``tests/test_obs.py``'s pin), and its ``pp_boundary_bytes`` counter
    on every step; ``merge_timeline`` aligns the two ranks' steps."""
    from pytorch_distributed_training_tpu import obs as jobs
    from pytorch_distributed_training_tpu_torch import obs as tobs

    mdir = tmp_path / "tm"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           "2", "--master_port", str(_free_port()), "-m",
           "pytorch_distributed_training_tpu_torch.cli.main", "--use-cpu",
           "--distributed", "--model", "gpt2", "--dataset",
           "synthetic-tokens", "--model-overrides", TINY_OVERRIDES,
           "--seq-len", "16", "--batch-size", "8", "--steps-per-epoch", "2",
           "--optimizer", "adamw", "--learning-rate", "1e-3",
           "--num-workers", "0", "--pipeline-parallel", "2",
           "--pipeline-schedule", "1f1b", "--pp-compress", "int8",
           "--grad-sync-stripe", "2", "--metrics-dir", str(mdir)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, cwd=tmp_path, env={
        **env, "PYTHONPATH": os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))}, capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert "'pipeline': 2" in out
    fields = dict(schedule="1f1b", num_stages=2, num_microbatches=4,
                  microbatch_rows=2, seq_len=16, hidden=32, act_itemsize=4,
                  mode="int8", num_chunks=1)
    want = {"record": "pp_compress_model", **fields,
            "pp_boundary_bytes_per_step":
                jobs.pp_step_counters(**fields)["pp_boundary_bytes"]}
    assert want["pp_boundary_bytes_per_step"] == \
        jcompress.pp_boundary_bytes_per_step(**fields)
    logs = tobs.load_rank_logs(str(mdir))
    assert sorted(logs) == [0, 1]
    for rank, events in logs.items():
        tobs.validate_events(events)
        assert events[0]["world"] == 2 and events[0]["rank"] == rank
        (rec,) = [e for e in events if e.get("record") == "pp_compress_model"]
        assert {k: v for k, v in rec.items()
                if k not in ("v", "t", "rank", "kind")} == want
        steps = [e for e in events if e["kind"] == "step"]
        assert [e["counters"]["pp_boundary_bytes"] for e in steps] == \
            [want["pp_boundary_bytes_per_step"]] * 2
    timeline = tobs.merge_timeline(logs)
    assert timeline == jobs.merge_timeline(logs)
    assert [row["step"] for row in timeline] == [0, 1]
    assert all(sorted(row["ranks"]) == [0, 1] for row in timeline)
    assert "pipeline_stages=2 | pipeline_schedule=1f1b" in out
    # The two pipeline ranks share their rows: 2 steps of 8.
    assert "examples=16 |" in out
    assert "training finished" in out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]



def _epoch_losses(out: str) -> list:
    return [float(line.split("| loss=")[1].split()[0])
            for line in out.splitlines() if line.startswith("epoch=")]


def test_cli_device_cache_tokens_under_pp2(tmp_path):
    """``--device-cache`` on a token file under ``--pipeline-parallel 2``
    (two torchrun CPU ranks): the cache hands both pipeline ranks the
    global batch (the batch axes have one shard), so the run's epoch
    losses are one process's cached run's (rtol 1e-5); the uncached pair
    likewise.  The cache draws its own windows, not the loader's, so a
    cached run is held to a cached run."""
    from pytorch_distributed_training_tpu_torch.data.lm_corpus import (
        synthesize_token_bin,
    )

    path = str(tmp_path / "train.bin")
    synthesize_token_bin(path, n_tokens=20_000, vocab_size=128, seed=0)
    common = ["--use-cpu", "--model", "gpt2", "--dataset",
              f"token-file:{path}", "--model-overrides", TINY_OVERRIDES,
              "--seq-len", "16", "--batch-size", "8", "--epochs", "2",
              "--steps-per-epoch", "2", "--optimizer", "adamw",
              "--learning-rate", "1e-3", "--num-workers", "0"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    for cached in ([], ["--device-cache"]):
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", "2", "--master_port", str(_free_port()),
             "-m", "pytorch_distributed_training_tpu_torch.cli.main",
             "--distributed", "--pipeline-parallel", "2", *common, *cached],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=240)
        assert res.returncode == 0, res.stderr[-3000:]
        flat = subprocess.run(
            [sys.executable, "-m",
             "pytorch_distributed_training_tpu_torch.cli.main", *common,
             *cached], cwd=tmp_path, env=env, capture_output=True,
            text=True, timeout=240)
        assert flat.returncode == 0, flat.stderr[-3000:]
        got, want = _epoch_losses(res.stdout), _epoch_losses(flat.stdout)
        assert len(got) == len(want) == 2, (res.stdout, flat.stdout)
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=cached)
