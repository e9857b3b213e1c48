"""Sharded training of the PyTorch port (``--fsdp``, ``--tensor-parallel``,
``--zero1``, ``--sequence-parallel``) against the JAX package, on the CPU
with gloo.

- The placement decisions: the port's spec for every leaf of GPT-2 124M,
  ViT-B/16 and ResNet-50 equal to JAX's ``infer_params_sharding`` on the
  same mesh shape (the leaves' paths and dims mapped by
  ``models/convert.py``), under the FSDP, TP, ZeRO-1 and DDP rules; the
  mesh's rank layout equal to JAX's ``make_mesh`` device layout on
  ``devices8``; ``MeshConfig``'s refusals with JAX's messages; a
  placement's shard/unshard round trip (the by-head QKV included).
- Four gloo ranks (``tests/torch_dp_worker.py sharded``, one launch):
  JAX's tiny GPT-2 (4 heads, width 64, vocab 128) on converted weights,
  each configuration's first-batch loss, logits and gradients (gathered
  whole) held to JAX's unsharded value-and-grad at JAX's own tolerances
  (``tests/test_parallel.py``: its sharded runs are held to the same
  unsharded reference), then two adamw steps of two microbatches held to
  JAX's ``make_train_step``: TP 2 and 4, data 2 x fsdp 2, fsdp 4,
  fsdp 2 x tp 2, ZeRO-1 (flat, ``hier`` and ``hier-int8`` over 2
  slices), ring and Ulysses at sequence 2 (and ring at 4), SP x TP in
  both modes, ``--ce-chunk`` under SP, a clip that fires under fsdp 2
  and tp 2 (every rank's gate norm the one-process norm); dropout under
  TP 2 (a tensor group's replicated leaves bitwise equal); the shallow
  ResNet under data 2 x fsdp 2 and the small ViT under TP 2, from the
  JAX package's weights, against JAX's ``make_train_step`` on the same
  batches (the tolerances of test_torch_dp.py) and against the port's
  one-process step.
- Two gloo ranks (``sharded2``): fsdp 2, TP 2 and Ulysses 2 at world 2,
  and a checkpoint saved under fsdp 2 restored under fsdp 2 (bitwise the
  uninterrupted run), ZeRO-1, plain data parallelism and one process.
- Ring attention and Ulysses over a sequence axis of 4, causal and not,
  output and gradients against JAX's attention.
- The CLI: JAX's refusals (exit 2, its messages) and two torchrun runs of
  four CPU ranks.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tpu.comm.mesh import (
    MeshConfig as JaxMeshConfig, make_mesh as jax_make_mesh,
)
from pytorch_distributed_training_tpu.models import resnet as jresnet
from pytorch_distributed_training_tpu.models import vit as jvit
from pytorch_distributed_training_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config,
)
from pytorch_distributed_training_tpu.ops.attention import (
    dot_product_attention as jax_attention,
)
from pytorch_distributed_training_tpu.parallel import sharding as jsh
from pytorch_distributed_training_tpu.train import (
    TrainState as JaxTrainState, make_train_step as jax_train_step,
)
from pytorch_distributed_training_tpu_torch.cli.main import main as cli_main
from pytorch_distributed_training_tpu_torch.comm.mesh import (
    MeshConfig, make_hybrid_mesh, make_mesh,
)
from pytorch_distributed_training_tpu_torch.models import (
    create_model, gpt2_params_from_jax, resnet_params_from_jax,
    resnet_params_to_jax, vit_params_from_jax, vit_params_to_jax,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    jax_leaf_dims, jax_leaf_paths,
)
from pytorch_distributed_training_tpu_torch.parallel import sharding as tsh
from pytorch_distributed_training_tpu_torch.parallel.sharded import Placement
from pytorch_distributed_training_tpu_torch.tools import dp_check
from tests.test_torch_resnet import (
    CONFIGS as RESNET_CONFIGS, _assert_tree_close,
    _jax_init as _jax_resnet_init, _run_jax as _run_jax_resnet,
)
from tests.test_torch_train import _assert_params_close
from tests.test_torch_vit import (
    _jax_init as _jax_vit_init, run_jax as _run_jax_vit,
)
from tests.torch_shared import shared, shared_parts
from tests.torch_dp_worker import (
    CLIP, IMAGE_SIZE, SHARD_ACCUM, SHARD_LR, SHARDED2_CASES, SHARDED_CASES, TINY4,
    launch, shard_tokens, sp_inputs,
)

# JAX's tolerances (tests/test_parallel.py).
TP_TOL = dict(logits=(2e-4, 2e-4), loss=1e-5, grads=(2e-3, 2e-5))
FSDP_TOL = dict(logits=(2e-4, 2e-4), loss=1e-5, grads=(2e-4, 1e-5))
SP_TOL = dict(logits=(2e-4, 2e-4), loss=1e-5, grads=(5e-4, 1e-5))
ZERO1_REL = 1e-4      # relative L2 of the parameters after the steps
# Relative L2 of the parameter updates (p_after - p_before) against
# JAX's: a misplaced slot or shard moves it by O(1).
UPDATE_REL = {"hier-int8": 0.1}
UPDATE_REL_DEFAULT = 1e-2


def _tol(label: str) -> dict:
    if "ring" in label or "ulysses" in label:
        return SP_TOL
    if "tp" in label and "fsdp" not in label:
        return TP_TOL
    return FSDP_TOL


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the JAX side -------------------------------------------------------------

def _tiny_params():
    return JaxGPT2(cfg=JaxGPT2Config(**TINY4)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        train=False)["params"]


def _compute_jax_tiny(params):
    """JAX's tiny GPT-2 (``tests/test_parallel.py::_tiny_gpt2``), its
    params, the first batch's loss/logits/grads and the steps' results
    (keyed by (clip, chunk))."""
    jm = JaxGPT2(cfg=JaxGPT2Config(**TINY4))
    tokens = shard_tokens()
    t0 = jnp.asarray(tokens[0])

    def loss_fn(p, t):
        logits = jm.apply({"params": p}, t, train=False)
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32))
        nll = -jnp.take_along_axis(logp, t[:, 1:, None], axis=-1)
        return jnp.mean(nll)

    loss, grads = jax.value_and_grad(loss_fn)(params, t0)
    ref = {"loss": float(loss),
           "logits": np.asarray(jm.apply({"params": params}, t0,
                                         train=False)),
           "grads": _named(grads),
           "grad_norm": float(optax.global_norm(grads)),
           "init": _named(params)}
    steps = {}
    for clip, chunk in ((None, None), (CLIP, None), (None, 8)):
        tx = optax.adamw(SHARD_LR, weight_decay=0.1)
        if clip is not None:
            tx = optax.chain(optax.clip_by_global_norm(clip), tx)
        p = jax.tree_util.tree_map(jnp.array, params)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p,
                              opt_state=tx.init(p), batch_stats={},
                              apply_fn=jm.apply, tx=tx)
        step = jax_train_step(kind="lm", num_microbatches=SHARD_ACCUM,
                              lm_loss_chunk=chunk)
        losses = []
        for b in tokens:
            state, m = step(state, {"tokens": jnp.asarray(b)})
            losses.append(float(m["loss"]))
        steps[(clip, chunk)] = (np.array(losses), _named(state.params))
    ref["steps"] = steps
    return ref


def _named(tree) -> dict:
    return {k: v.numpy() for k, v in gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


# The sharded image runs of the worker: sgd for the ResNet, adamw for the
# ViT (tools/dp_check.py's optimizers), 2 steps of 2 microbatches.
IMAGE_RUNS = {"resnet_fsdp": ("resnet", dict(opt="sgd", lr=0.05, wd=1e-3)),
              "vit_tp2": ("vit", dict(opt="adamw", lr=3e-4, wd=0.05))}


def _image_inits() -> dict:
    """The shallow ResNet's and the small ViT's JAX weights: the JAX
    params (and statistics) and the port's state dict."""
    out = {}
    for kind, _ in IMAGE_RUNS.values():
        if kind == "resnet":
            _, params, stats = _jax_resnet_init(
                RESNET_CONFIGS["BasicBlock-fused"])
            out[kind] = ((params, stats), resnet_params_from_jax(
                jax.tree_util.tree_map(np.asarray, params),
                jax.tree_util.tree_map(np.asarray, stats)))
        else:
            jm, params = _jax_vit_init(IMAGE_SIZE[kind])
            out[kind] = ((jm, params), vit_params_from_jax(
                jax.tree_util.tree_map(np.asarray, params)))
    return out


def _compute_jax_images(inits: dict):
    """JAX's ``make_train_step`` on the worker's batches for the shallow
    ResNet and the small ViT (losses, final state), with their weights
    as the port's state dicts."""
    out = {}
    for kind, opt in IMAGE_RUNS.values():
        batches = [(b["image"], b["label"]) for b in
                   dp_check.global_batches(kind, 2, 8, IMAGE_SIZE[kind], 3)]
        jax_init, init = inits[kind]
        if kind == "resnet":
            losses, _, state = _run_jax_resnet(
                RESNET_CONFIGS["BasicBlock-fused"], *jax_init, batches,
                accum=2, **opt)
        else:
            losses, state = _run_jax_vit(*jax_init, batches, accum=2, **opt)
        # The state's arrays only: the pickle that shares this fixture
        # takes no optimizer closures.
        out[kind] = (init, losses, SimpleNamespace(
            params=jax.tree_util.tree_map(np.asarray, state.params),
            batch_stats=jax.tree_util.tree_map(np.asarray,
                                               state.batch_stats)))
    return out


def _launch(tmp_path_factory, task: str, world: int, *, images=False,
            cases=None) -> list:
    """One launch of the worker on the JAX inits: each rank's results
    (``cases``: the ``SHARDED_CASES`` labels it runs)."""
    out = tmp_path_factory.mktemp(task)
    np.savez(out / "init.npz", **_named(_tiny_params()))
    for kind, (_, state_dict) in (_image_inits() if images else {}).items():
        np.savez(out / f"{kind}_init.npz",
                 **{k: v.numpy() for k, v in state_dict.items()})
    if cases is not None:
        (out / "cases.json").write_text(json.dumps(cases))
    launch(["tests/torch_dp_worker.py", task, str(out)], world, timeout=240)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)], out


# The sharded cases in two launches, and the extras in a third.
_CASES = sorted(SHARDED_CASES)
_HALVES = (_CASES[::2], _CASES[1::2])


@pytest.fixture(scope="module")
def sharded_parts(request, tmp_path_factory):
    """The JAX references and the worker's launches, each once per run;
    the xdist workers that reach them at once compute different ones
    side by side (``shared_parts``).  Each part draws the JAX inits
    itself (they are deterministic)."""
    f = tmp_path_factory
    return shared_parts(request, f, "torch_parallel", {
        "jax_tiny": lambda: _compute_jax_tiny(_tiny_params()),
        "jax_images": lambda: _compute_jax_images(_image_inits()),
        "cases0": lambda: _launch(f, "sharded", 4, cases=_HALVES[0])[0],
        "cases1": lambda: _launch(f, "sharded", 4, cases=_HALVES[1])[0],
        "extra": lambda: _launch(f, "sharded_extra", 4, images=True)[0],
        "ranks2": lambda: _launch(f, "sharded2", 2),
    })


@pytest.fixture(scope="module")
def jax_tiny(sharded_parts):
    return sharded_parts["jax_tiny"]


@pytest.fixture(scope="module")
def jax_images(sharded_parts):
    return sharded_parts["jax_images"]


@pytest.fixture(scope="module")
def ranks4(sharded_parts):
    """Each rank's results of the three 4-rank launches, merged."""
    return [{**a, **b, **c} for a, b, c in zip(
        sharded_parts["cases0"], sharded_parts["cases1"],
        sharded_parts["extra"])]


@pytest.fixture(scope="module")
def ranks2(sharded_parts):
    return sharded_parts["ranks2"]


@pytest.fixture(scope="module")
def sp_ranks(request, tmp_path_factory):
    def compute():
        out = tmp_path_factory.mktemp("sp_attention")
        launch(["tests/torch_dp_worker.py", "sp_attention", str(out)], 4,
               timeout=120)
        return dict(np.load(out / "rank0.npz"))

    return shared(request, tmp_path_factory, "torch_parallel_sp_ranks",
                  compute)


# --- placement decisions -----------------------------------------------------

def _jax_shapes(family: str):
    if family == "gpt2":
        jm = JaxGPT2(cfg=JaxGPT2Config())
        x = jnp.zeros((1, 8), jnp.int32)
        kw = dict(train=False)
        port = create_model("gpt2", device="meta")
    elif family == "vit":
        jm = jvit.vit_b16()
        x = jnp.zeros((1, 224, 224, 3))
        kw = dict(train=False)
        port = create_model("vit_b16", device="meta", image_size=224)
    else:
        jm = jresnet.resnet50(num_classes=1000)
        x = jnp.zeros((1, 64, 64, 3))
        kw = dict(train=True)
        port = create_model("resnet50", num_classes=1000, device="meta")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, **kw))
    return shapes["params"], {n: tuple(p.shape)
                              for n, p in port.named_parameters()}


MESHES = {
    "fsdp4": dict(data=2, fsdp=4),
    "tp2": dict(data=4, tensor=2),
    "tp4": dict(data=2, tensor=4),
    "fsdp2_tp2": dict(data=2, fsdp=2, tensor=2),
    "data8": dict(data=8),
}
RULES = {"fsdp": "FSDP_RULES", "zero1": "ZERO1_OPT_RULES",
         "ddp": "DDP_RULES", "tp": None}


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("family", ["gpt2", "vit", "resnet"])
def test_rule_decisions_match_jax(devices8, family, mesh, rules):
    jshapes, tshapes = _jax_shapes(family)
    jmesh = jax_make_mesh(JaxMeshConfig(**MESHES[mesh]), devices=devices8)
    model = {"gpt2": "gpt2", "vit": "vit_b16", "resnet": "resnet50"}[family]
    jrules = (jsh.tp_rules_for(model) if RULES[rules] is None
              else getattr(jsh, RULES[rules]))
    trules = (tsh.tp_rules_for(model) if RULES[rules] is None
              else getattr(tsh, RULES[rules]))
    want = jsh.infer_params_sharding(jshapes, jmesh, jrules)
    want = {jsh._path_str(p): s.spec
            for p, s in jax.tree_util.tree_leaves_with_path(want)}
    got = tsh.infer_params_sharding(tshapes, dict(jmesh.shape), trules)
    paths = jax_leaf_paths(tshapes)
    assert sorted(paths.values()) == sorted(want)
    sharded = 0
    for name, spec in got.items():
        dims = jax_leaf_dims(paths[name], len(spec))
        jspec = list(want[paths[name]]) + [None] * len(spec)
        as_jax = [None] * len(spec)
        for i, j in enumerate(dims):
            as_jax[j] = spec[i]
        assert tuple(as_jax) == tuple(jspec[:len(spec)]), name
        sharded += any(e is not None for e in spec)
    if rules == "ddp":
        assert sharded == 0


def test_wte_falls_back_at_gpt2_vocab(devices8):
    """50257 rows refuse the tensor axis: ``wte`` is JAX's rule-dropped
    leaf, replicated under TP alone."""
    jmesh = jax_make_mesh(JaxMeshConfig(data=4, tensor=2), devices=devices8)
    rules = tsh.tp_rules_for("gpt2")
    assert rules.classify("wte", (50257, 768), dict(jmesh.shape)) == \
        jsh.tp_rules_for("gpt2").classify("wte", (50257, 768), jmesh)
    assert rules.classify("wte", (50257, 768), dict(jmesh.shape))[1] == \
        "rule-dropped"


@pytest.mark.parametrize("sizes", [dict(data=2, fsdp=4),
                                   dict(data=2, sequence=2, tensor=2),
                                   dict(fsdp=2, tensor=4), dict(data=8)])
def test_mesh_layout_matches_jax(devices8, sizes):
    jmesh = jax_make_mesh(JaxMeshConfig(**sizes), devices=devices8)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(8):
        mesh = make_mesh(MeshConfig(**sizes), world=8, rank=rank)
        assert mesh.shape == dict(jmesh.shape)
        np.testing.assert_array_equal(mesh.ranks, ids)
        assert mesh.ranks[tuple(mesh.coords.values())] == rank
    assert tsh.batch_sharding(mesh, ndim=2, sequence_sharded=True) == \
        tuple(jsh.batch_sharding(jmesh, ndim=2, sequence_sharded=True).spec)


def test_hybrid_mesh_is_slice_major():
    mesh = make_hybrid_mesh(MeshConfig(data=-1, tensor=2), n_slices=2,
                            world=8, rank=5)
    # Slice 0 holds ranks 0-3: the data axis's first half.
    assert mesh.ranks[:2].reshape(-1).tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="must span all slices"):
        make_hybrid_mesh(MeshConfig(data=1, fsdp=8), n_slices=2, world=8,
                         rank=0)


@pytest.mark.parametrize("cfg,n", [(dict(data=-1, fsdp=-1), 8),
                                   (dict(fsdp=3), 8),
                                   (dict(data=2, fsdp=2), 8)])
def test_mesh_config_refusals_match_jax(cfg, n):
    with pytest.raises(ValueError) as want:
        JaxMeshConfig(**cfg).resolve(n)
    with pytest.raises(ValueError) as got:
        MeshConfig(**cfg).resolve(n)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("blocks", [1, 3])
def test_placement_shard_unshard_roundtrip(blocks):
    full = torch.arange(24 * 5, dtype=torch.float32).view(24, 5)
    p = Placement((24, 5), 0, ("tensor",), 4, 0, blocks)
    shards = [p.shard(full, i) for i in range(4)]
    assert all(s.shape == (6, 5) for s in shards)
    if blocks == 3:   # rank i holds rows i of each third: q, k, v heads
        assert shards[1][:2].tolist() == full[2:4].tolist()
        assert shards[1][2:4].tolist() == full[10:12].tolist()
    assert torch.equal(p.unshard(torch.cat(shards)), full)


def test_shard_params_takes_each_rank_its_block(devices8):
    """``shard_params`` on GPT-2 124M's shapes under fsdp 4: each rank's
    block of the leaf the rules shard, concatenating back to the leaf."""
    model = create_model("gpt2", device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    full = {"blocks.0.mlp_up.weight":
            torch.arange(3072 * 768, dtype=torch.float32).view(3072, 768),
            "blocks.0.ln1.weight": torch.ones(768)}
    specs = tsh.infer_params_sharding(
        shapes, {"data": 2, "fsdp": 4}, tsh.FSDP_RULES)
    assert specs["blocks.0.mlp_up.weight"] == tsh.P("fsdp", None)
    shards = [tsh.shard_params(full, make_mesh(MeshConfig(data=2, fsdp=4),
                                               world=8, rank=r),
                               tsh.FSDP_RULES) for r in range(4)]
    assert torch.equal(torch.cat([s["blocks.0.mlp_up.weight"]
                                  for s in shards]),
                       full["blocks.0.mlp_up.weight"])
    assert all(s["blocks.0.ln1.weight"] is full["blocks.0.ln1.weight"]
               for s in shards)


# --- the four-rank family ----------------------------------------------------

def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("label", sorted(SHARDED_CASES))
def test_probe_matches_jax(ranks4, jax_tiny, label):
    """First-batch loss, logits and every gradient, gathered whole, at
    JAX's tolerances for the configuration's kind."""
    got = ranks4[0]
    tol = _tol(label)
    np.testing.assert_allclose(got[f"{label}/probe/loss"], jax_tiny["loss"],
                               rtol=tol["loss"])
    np.testing.assert_allclose(got[f"{label}/probe/logits"],
                               jax_tiny["logits"], rtol=tol["logits"][0],
                               atol=tol["logits"][1])
    for name, g in jax_tiny["grads"].items():
        np.testing.assert_allclose(got[f"{label}/probe/grad/{name}"], g,
                                   rtol=tol["grads"][0],
                                   atol=tol["grads"][1], err_msg=name)


@pytest.mark.parametrize("label", sorted(SHARDED_CASES))
def test_steps_match_jax(ranks4, jax_tiny, label):
    """Two adamw steps of two microbatches: the losses at JAX's loss
    tolerance (the compressed sync's second at its H1 bound), the
    parameters within ZeRO-1's relative 1e-4 and their updates within
    1e-2 of JAX's (hier-int8's within its quantization)."""
    opts = SHARDED_CASES[label][1]
    losses, params = jax_tiny["steps"][(opts.get("clip"), opts.get("chunk"))]
    got = ranks4[0]
    if opts.get("sync") == "hier-int8":
        np.testing.assert_allclose(got[f"{label}/loss"][0], losses[0],
                                   rtol=1e-5)
        np.testing.assert_allclose(got[f"{label}/loss"], losses, atol=0.02)
    else:
        np.testing.assert_allclose(got[f"{label}/loss"], losses, rtol=1e-5)
    names = sorted(params)
    a = np.concatenate([got[f"{label}/p/{n}"].ravel() for n in names])
    b = np.concatenate([params[n].ravel() for n in names])
    p0 = np.concatenate([jax_tiny["init"][n].ravel() for n in names])
    if opts.get("sync") == "hier-int8":
        # Quantized gradients: Adam moves a weight at most lr a step, so
        # two runs differ by at most 2 lr a step wherever they disagree.
        assert np.abs(a - b).max() <= 2 * SHARD_LR * len(losses)
    else:
        assert _rel(a, b) < ZERO1_REL
    assert _rel(a - p0, b - p0) < UPDATE_REL.get(opts.get("sync"),
                                                 UPDATE_REL_DEFAULT)


def test_zero1_and_fsdp_shrink_the_state(ranks4):
    """Each rank's bytes of parameters and slots (min size 1: every leaf
    shards): fsdp N keeps 1/N, ZeRO-1 its parameters whole and 1/4 of
    the two Adam moments, TP the embeddings and norms whole."""
    r = {k[:-len("/bytes")]: int(v) for k, v in ranks4[0].items()
         if k.endswith("/bytes")}
    full = r["ring2"]       # sequence parallelism replicates the state
    assert r["fsdp4"] * 4 == full
    assert r["data2_fsdp2"] * 2 == full
    assert r["zero1"] == full // 3 + (2 * full // 3) // 4
    assert r["tp4"] < r["tp2"] < full


@pytest.mark.parametrize("label", ["clip_fsdp2", "clip_tp2"])
def test_clip_norm_is_the_one_process_norm(ranks4, jax_tiny, label):
    """The gate's (and the clip's) global norm on every rank is the norm
    of the whole gradient, not a rank's share of it."""
    norms = np.array([r[f"{label}/grad_norm"][0] for r in ranks4])
    np.testing.assert_allclose(norms, jax_tiny["grad_norm"], rtol=1e-5)
    assert jax_tiny["grad_norm"] > CLIP     # the clip fires
    assert np.all(norms == norms[0])


def test_dropout_keeps_a_tensor_group_identical(ranks4):
    """Dropout under TP 2: the masks on replicated activations are the
    same on the ranks of a tensor group (ranks 0/1 and 2/3), so their
    replicated leaves stay bitwise equal; the two data replicas' rows
    differ and so do their masks, but the mean gradient keeps them equal
    too."""
    names = [k for k in ranks4[0] if k.startswith("dropout/")]
    assert names
    for k in names:
        assert np.isfinite(ranks4[0][k]).all()
        for r in (1, 2, 3):
            np.testing.assert_array_equal(ranks4[r][k], ranks4[0][k],
                                          err_msg=k)


@pytest.mark.parametrize("label", ["resnet_fsdp", "vit_tp2"])
def test_image_models_sharded_match_one_process(ranks4, label):
    """Within 2e-5, except the key bias (the middle third of each qkv
    bias): its gradient is zero in exact arithmetic, so Adam turns the
    rounding noise into steps of up to lr either way (the rule of
    test_torch_train.py::_assert_params_close), bounded by 2 lr a step."""
    r = ranks4[0]
    np.testing.assert_allclose(r[f"{label}/sharded/loss"],
                               r[f"{label}/one/loss"], rtol=1e-5)
    names = sorted(k[len(f"{label}/one/p/"):] for k in r
                   if k.startswith(f"{label}/one/p/"))
    assert names
    for n in names:
        a, b = r[f"{label}/sharded/p/{n}"], r[f"{label}/one/p/{n}"]
        if n.endswith("attn.qkv.bias"):
            d = a.shape[0] // 3
            np.testing.assert_allclose(a[d:2 * d], b[d:2 * d], rtol=0,
                                       atol=2 * 3e-4 * 2, err_msg=n)
            a = np.concatenate([a[:d], a[2 * d:]])
            b = np.concatenate([b[:d], b[2 * d:]])
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0, err_msg=n)


@pytest.mark.parametrize("label", sorted(IMAGE_RUNS))
def test_image_models_sharded_match_jax(ranks4, jax_images, label):
    """The sharded ResNet (BatchNorm statistics included) within 1e-4 of
    JAX's, the sharded ViT's losses within 1e-5 and its parameters within
    1e-5 (the key bias within 2 lr a step), as test_torch_dp.py holds
    data parallelism."""
    kind, opt = IMAGE_RUNS[label]
    init, losses, state = jax_images[kind]
    r = ranks4[0]
    got = {k: torch.from_numpy(r[f"{label}/sharded/p/{k}"]) for k in init}
    if kind == "resnet":
        np.testing.assert_allclose(r[f"{label}/sharded/loss"], losses,
                                   atol=1e-4, rtol=0)
        params, stats = resnet_params_to_jax(got)
        _assert_tree_close(params, state.params, 1e-4, "params")
        _assert_tree_close(stats, state.batch_stats, 1e-4, "batch_stats")
        return
    np.testing.assert_allclose(r[f"{label}/sharded/loss"], losses, rtol=1e-5)
    _assert_params_close(vit_params_to_jax(got),
                         jax.tree_util.tree_map(np.asarray, state.params),
                         atol=1e-5, lr_bound=2 * 2 * opt["lr"])


# --- the two-rank family and checkpoints across layouts --------------------

@pytest.mark.parametrize("label", sorted(SHARDED2_CASES))
def test_two_ranks_match_jax(ranks2, jax_tiny, label):
    got = ranks2[0][0]
    tol = _tol(label)
    np.testing.assert_allclose(got[f"{label}/probe/loss"], jax_tiny["loss"],
                               rtol=tol["loss"])
    for name, g in jax_tiny["grads"].items():
        np.testing.assert_allclose(got[f"{label}/probe/grad/{name}"], g,
                                   rtol=tol["grads"][0],
                                   atol=tol["grads"][1], err_msg=name)
    losses, _ = jax_tiny["steps"][(None, None)]
    np.testing.assert_allclose(got[f"{label}/loss"], losses, rtol=1e-5)


@pytest.mark.parametrize("layout", ["fsdp2", "zero1", "dp"])
def test_checkpoint_restores_into_another_layout(ranks2, layout):
    """Saved under fsdp 2 after step 1; restored into the layout and
    stepped once: the same layout is bitwise the uninterrupted run, the
    others within the loss tolerance."""
    r = ranks2[0][0]
    assert int(r[f"resume/{layout}/step"]) == 1
    src = r["ckpt_src/loss"][1]
    names = sorted(k[len("ckpt_src/p/"):] for k in r
                   if k.startswith("ckpt_src/p/"))
    if layout == "fsdp2":
        assert r[f"resume/{layout}/loss"] == src
        for n in names:
            np.testing.assert_array_equal(r[f"resume/{layout}/p/{n}"],
                                          r[f"ckpt_src/p/{n}"])
        return
    np.testing.assert_allclose(r[f"resume/{layout}/loss"], src, rtol=1e-5)
    a = np.concatenate([r[f"resume/{layout}/p/{n}"].ravel() for n in names])
    b = np.concatenate([r[f"ckpt_src/p/{n}"].ravel() for n in names])
    assert _rel(a, b) < ZERO1_REL


def test_checkpoint_restores_at_world_one(ranks2):
    """The fsdp 2 checkpoint into a one-process state: step 2's loss is
    the uninterrupted run's, and the state maps onto JAX's."""
    from pytorch_distributed_training_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from pytorch_distributed_training_tpu_torch.cli.main import (
        build_optimizer,
    )
    from pytorch_distributed_training_tpu_torch.models import (
        GPT2, GPT2Config, train_state_to_jax,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_train_step,
    )

    res, out = ranks2
    model = GPT2(GPT2Config(**TINY4))
    state = create_train_state(model, build_optimizer(
        "adamw", SHARD_LR, weight_decay=0.1))
    state = CheckpointManager(str(out / "ckpt")).restore_latest(state)
    assert state.step == 1
    step = make_train_step(kind="lm", num_microbatches=SHARD_ACCUM)
    state, m = step(state, {"tokens": torch.from_numpy(
        shard_tokens()[1]).long()})
    np.testing.assert_allclose(float(m["loss"]), res[0]["ckpt_src/loss"][1],
                               rtol=1e-5)
    tree = train_state_to_jax(state, scheduled=False)
    assert tree["params"]["wte"].shape == (128, 64)


# --- ring attention and Ulysses ----------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sp_attention_matches_jax(sp_ranks, mode, causal):
    q, k, v, dy = (jnp.asarray(x) for x in sp_inputs())

    def attn(q, k, v):
        return jax_attention(q, k, v, causal=causal)

    out, vjp = jax.vjp(attn, q, k, v)
    grads = vjp(dy)
    np.testing.assert_allclose(sp_ranks[f"{mode}/{causal}/out"], out,
                               atol=2e-5)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(sp_ranks[f"{mode}/{causal}/{name}"], g,
                                   atol=5e-5, err_msg=name)


# --- the CLI ----------------------------------------------------------------

TINY_ARGS = ["--use-cpu", "--model", "gpt2", "--dataset", "synthetic-tokens",
             "--seq-len", "32", "--model-overrides",
             "num_layers=2,hidden_dim=64,num_heads=4,vocab_size=128,"
             "max_seq_len=32", "--batch-size", "8", "--num-workers", "0",
             "--steps-per-epoch", "2"]
REFUSALS = {
    "zero1-fsdp": (["--zero1", "--fsdp", "2"],
                   "with --fsdp the slots are already sharded (ZeRO-3)"),
    "zero1-tp": (["--zero1", "--tensor-parallel", "2"],
                 "--zero1 composes with data parallelism only"),
    "hier-fsdp": (["--grad-sync", "hier", "--fsdp", "2", "--distributed"],
                  "--grad-sync hier composes with data parallelism only"),
    "hier-tp": (["--grad-sync", "hier-int8", "--tensor-parallel", "2",
                 "--distributed"],
                "--grad-sync hier-int8 composes with data parallelism"),
    "hier-sp": (["--grad-sync", "hier", "--sequence-parallel", "2",
                 "--distributed"],
                "not --fsdp/--tensor-parallel/--pipeline-parallel/"
                "--sequence-parallel"),
    "sp-image": (["--model", "resnet18", "--dataset", "cifar10",
                  "--sequence-parallel", "2"],
                 "--sequence-parallel requires a transformer LM"),
    "sp-seq-len": (["--sequence-parallel", "3"],
                   "--seq-len 32 not divisible by --sequence-parallel 3"),
    "tp-heads": (["--tensor-parallel", "3"],
                 "--tensor-parallel 3 needs heads (4) divisible by it"),
    "ulysses-heads": (["--sequence-parallel", "8",
                       "--sequence-parallel-mode", "ulysses"],
                      "needs per-tensor-shard heads (4) divisible by "
                      "--sequence-parallel 8; use ring"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_cli_refusals(case, capsys):
    extra, message = REFUSALS[case]
    with pytest.raises(SystemExit) as e:
        cli_main([*TINY_ARGS, *extra])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_cli_refuses_a_mesh_the_world_cannot_hold(capsys):
    with pytest.raises(SystemExit, match="not divisible by fixed axes"):
        cli_main([*TINY_ARGS, "--fsdp", "2"])
    assert "mesh:" not in capsys.readouterr().out


@pytest.mark.parametrize("extra,mesh", [
    (["--fsdp", "2", "--tensor-parallel", "2"],
     "'fsdp': 2, 'expert': 1, 'pipeline': 1, 'sequence': 1, 'tensor': 2"),
    (["--zero1", "--sequence-parallel", "2", "--sequence-parallel-mode",
      "ulysses", "--ce-chunk", "8"],
     "'data': 2, 'fsdp': 1, 'expert': 1, 'pipeline': 1, 'sequence': 2"),
])
def test_cli_torchrun_four_ranks(extra, mesh):
    outs = launch(["-m", "pytorch_distributed_training_tpu_torch.cli.main",
                   "--distributed", *TINY_ARGS, "--accum-steps", "2",
                   *extra], 4, timeout=120)
    for out in outs:
        assert mesh in out, out
        assert "training finished" in out
    assert "step=2" in outs[0]
