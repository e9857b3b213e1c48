"""PyTorch port of the ResNet training path against the JAX package.

The same inputs (numpy, seeded) and the same weights (the JAX init,
converted by ``resnet_params_from_jax``) go through the JAX functions and
their counterparts in the port:

- the output-saving BatchNorm functions (``batch_norm``, ``bn_relu``,
  ``bn_add_relu``): outputs, statistics and grads against the JAX
  ``custom_vjp``s and against the port's plain composition (f32, atol
  1e-5); the modules' running statistics and eval outputs; under the
  bf16 policy the fused modules' f32 master ``scale``/``bias`` get JAX's
  unrounded f32 ``dgamma``/``dbeta`` (1e-6 relative) with the forward
  bit-equal;
- the space-to-depth stem: the s2d channel order bit-equal to JAX's, the
  convolution against a plain 7x7 stride-2 conv with padding 3 and the
  JAX stem (atol 1e-5);
- ResNet-18 and ResNet-50 parameter counts;
- f32 logits of shallow ``BasicBlock`` and ``Bottleneck`` ResNets, train
  and eval mode, ``tpu_fused`` on and off (atol 1e-4), with the new
  running statistics;
- three train steps against JAX's ``make_train_step(kind=
  "image_classifier")`` (sgd and adam, accumulation 1 and 2, label
  smoothing): losses, weights mapped back by ``resnet_params_to_jax`` and
  ``batch_stats`` within 1e-4 (see ``TRAIN_CASES`` for where Adam runs);
  the eval step; the bf16 policy's losses within 2e-2.

Port-only: ``stem_remat`` gives the same grads and statistics, the weight
bridge round-trips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pytorch_distributed_training_tpu.models import resnet as jresnet
from pytorch_distributed_training_tpu.ops import fused_norm as jfn
from pytorch_distributed_training_tpu.ops import s2d_stem as js2d
from pytorch_distributed_training_tpu.train import (
    TrainState as JaxTrainState, make_eval_step as jax_eval_step,
    make_policy as jax_policy, make_train_step as jax_train_step,
)
from pytorch_distributed_training_tpu_torch.cli.main import build_optimizer
from pytorch_distributed_training_tpu_torch.models import (
    create_model, resnet_params_from_jax, resnet_params_to_jax,
)
from pytorch_distributed_training_tpu_torch.models import resnet as tresnet
from pytorch_distributed_training_tpu_torch.ops import fused_norm as tfn
from pytorch_distributed_training_tpu_torch.ops import s2d_stem as ts2d
from pytorch_distributed_training_tpu_torch.train import (
    create_train_state, make_eval_step, make_policy, make_train_step,
)

SIZE, BATCH, CLASSES, STEPS = 16, 8, 10, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the cores are shared with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x: np.ndarray) -> torch.Tensor:
    """An NHWC numpy array as the port's NCHW (channels_last) view."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# --- the BatchNorm functions ------------------------------------------------

def _bn_inputs(seed=0, shape=(6, 5, 5, 7)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    gamma[1] = -0.7              # a negative gamma reconstructs too
    gamma[2] = 3e-13             # below the clamp: 1e-12 with gamma's sign
    beta = rng.standard_normal(c).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, gamma, beta, r, dy


def _jax_fn(name):
    if name == "bn_add_relu":
        return lambda x, r, g, b: jfn.bn_add_relu(x, r, g, b)
    fn = getattr(jfn, name)
    return lambda x, r, g, b: fn(x, g, b)


def _port_fused(name):
    if name == "bn_add_relu":
        return lambda x, r, g, b: tfn.bn_add_relu(x, r, g, b)
    fn = getattr(tfn, name)
    return lambda x, r, g, b: fn(x, g, b)


def _port_plain(name):
    """The plain composition: the port's ``BatchNorm`` (flax's math),
    then ReLU / add + ReLU, differentiated by autograd."""
    def fn(x, r, g, b):
        m = tfn.BatchNorm(g.shape[0])
        stats: dict = {}
        y = torch.func.functional_call(m, {"scale": g, "bias": b}, (x, stats))
        # flax's variance is clipped at 0 and the batch mean recovered from
        # the update m * 0 + (1 - m) * mean.
        mean = stats["mean"] / (1 - m.momentum)
        var = (stats["var"] - m.momentum) / (1 - m.momentum)
        if name == "bn_relu":
            y = F.relu(y)
        elif name == "bn_add_relu":
            y = F.relu(y + r)
        return y, mean, var
    return fn


def _port_grads(fn, x, r, g, b, dy):
    xt, rt = _nchw(x).requires_grad_(), _nchw(r).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y, mean, var = fn(xt, rt, gt, bt)
    grads = torch.autograd.grad(y, (xt, rt, gt, bt), _nchw(dy),
                                allow_unused=True)
    dr = grads[1]
    return (_nhwc(y), mean.detach().numpy(), var.detach().numpy(),
            _nhwc(grads[0]), None if dr is None else _nhwc(dr),
            grads[2].numpy(), grads[3].numpy())


@pytest.mark.parametrize("name", ["batch_norm", "bn_relu", "bn_add_relu"])
def test_bn_functions_match_jax(name):
    x, g, b, r, dy = _bn_inputs()
    fn = _jax_fn(name)
    (y, mean, var), vjp = jax.vjp(fn, x, r, g, b)
    dx, dr, dg, db = vjp((dy, jnp.zeros_like(mean), jnp.zeros_like(var)))
    got = _port_grads(_port_fused(name), x, r, g, b, dy)
    ref = (y, mean, var, dx, dr if name == "bn_add_relu" else None, dg, db)
    for what, a, e in zip(("y", "mean", "var", "dx", "dr", "dgamma",
                           "dbeta"), got, ref):
        if e is None:
            assert a is None, what
            continue
        np.testing.assert_allclose(a, np.asarray(e), atol=1e-5, rtol=1e-5,
                                   err_msg=f"{name} {what}")


@pytest.mark.parametrize("name", ["batch_norm", "bn_relu", "bn_add_relu"])
def test_bn_functions_match_plain_composition(name):
    """Fused against autograd of the plain composition.  The tiny-gamma
    channel is replaced: the fused backward divides by its clamp (the JAX
    behaviour the test above pins), the plain one never divides."""
    x, g, b, r, dy = _bn_inputs(seed=1)
    g[2] = 0.9
    got = _port_grads(_port_fused(name), x, r, g, b, dy)
    ref = _port_grads(_port_plain(name), x, r, g, b, dy)
    for what, a, e in zip(("y", "mean", "var", "dx", "dr", "dgamma",
                           "dbeta"), got, ref):
        if e is None:
            assert a is None, what
            continue
        np.testing.assert_allclose(a, e, atol=1e-5, rtol=1e-5,
                                   err_msg=f"{name} {what}")


def test_bn_relu_tie_takes_half_the_gradient():
    """``jnp.maximum(z, 0)`` sends half the cotangent through a z of
    exactly 0; the fused backward does the same."""
    x = np.array([[[[-1.0]]], [[[1.0]]], [[[0.0]]]], np.float32)
    g, b = np.ones(1, np.float32), np.zeros(1, np.float32)
    dy = np.ones_like(x)
    _, vjp = jax.vjp(lambda x: jfn.bn_relu(x, g, b), x)
    (dx_ref,) = vjp((dy, np.zeros(1, np.float32), np.zeros(1, np.float32)))
    got = _port_grads(_port_fused("bn_relu"), x, x, g, b, dy)
    np.testing.assert_allclose(got[3], np.asarray(dx_ref), atol=1e-6)


_MODULES = {
    "FusedBNRelu": (jfn.FusedBNRelu, tfn.FusedBNRelu),
    "FusedBN": (jfn.FusedBN, tfn.FusedBN),
    "FusedBNAddRelu": (jfn.FusedBNAddRelu, tfn.FusedBNAddRelu),
    "BatchNorm": (None, tfn.BatchNorm),
}


@pytest.mark.parametrize("name", sorted(_MODULES))
def test_bn_modules_match_jax(name):
    """Running statistics after two train calls (JAX's momentum 0.9 on
    the biased variance), then the eval output on them."""
    jcls, tcls = _MODULES[name]
    if jcls is None:
        from flax import linen as nn

        def jcls(use_running_average):
            return nn.BatchNorm(use_running_average=use_running_average,
                                momentum=0.9, epsilon=1e-5)
    x, g, b, r, _ = _bn_inputs(seed=2)
    args = (x, r) if name == "FusedBNAddRelu" else (x,)
    jtrain = jcls(use_running_average=False)
    variables = jtrain.init(jax.random.PRNGKey(0), *args)
    variables = {"params": {"scale": g, "bias": b},
                 "batch_stats": variables["batch_stats"]}
    m = tcls(x.shape[-1])
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(g))
        m.bias.copy_(torch.from_numpy(b))
    targs = (_nchw(x), _nchw(r)) if name == "FusedBNAddRelu" else (_nchw(x),)
    for k in range(2):
        xs = [a * (1 + k) for a in args]
        _, upd = jtrain.apply(variables, *xs, mutable=["batch_stats"])
        variables = {**variables, **upd}
        m.train()
        m(*[t * (1 + k) for t in targs])
    for stat in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(m, stat).numpy(),
            np.asarray(variables["batch_stats"][stat]), atol=1e-5,
            err_msg=f"{name} running {stat}")
    y_ref = jcls(use_running_average=True).apply(variables, *args)
    m.eval()
    np.testing.assert_allclose(_nhwc(m(*targs)), np.asarray(y_ref),
                               atol=1e-5, err_msg=f"{name} eval")


_FUSED = {"bn_relu": tfn.FusedBNRelu, "batch_norm": tfn.FusedBN,
          "bn_add_relu": tfn.FusedBNAddRelu}


@pytest.mark.parametrize("name", sorted(_FUSED))
def test_bf16_master_affine_grads_reach_the_master_as_jax_sums(name):
    """Under the bf16 policy the step's cast keeps the fused norms' f32
    master ``scale``/``bias`` (``master_affine_params``): the forward is
    bit-equal to JAX's on the bf16-cast gamma/beta, and ``dgamma``/
    ``dbeta`` reach the f32 master as JAX's ``custom_vjp`` sums, within
    1e-6 of their largest entry.  Rounded to bf16 on the way (as autograd
    rounds a gradient to a bf16 input's dtype) they are ~1e-3 off."""
    bf16 = jnp.bfloat16
    x, g, b, r, dy = _bn_inputs(seed=4)
    g[2] = 0.8                   # away from the clamp: a sum, not a limit
    xb, rb, dyb = (jnp.asarray(a).astype(bf16) for a in (x, r, dy))
    fn = _jax_fn(name)
    y_ref, vjp = jax.vjp(
        lambda gg, bb: fn(xb, rb, gg.astype(bf16), bb.astype(bf16))[0],
        jnp.asarray(g), jnp.asarray(b))
    dg_ref, db_ref = (np.asarray(v) for v in vjp(dyb))
    assert dg_ref.dtype == np.float32

    module = _FUSED[name](g.shape[0]).train()
    master = {"scale": torch.tensor(g, requires_grad=True),
              "bias": torch.tensor(b, requires_grad=True)}
    keep = tfn.master_affine_params(module)
    assert keep == {"scale", "bias"}
    tensors = make_policy("bf16").cast_to_compute(master, keep)

    def port(a):
        return _nchw(np.array(a.astype(jnp.float32))).to(torch.bfloat16)

    args = (port(xb), port(rb)) if name == "bn_add_relu" else (port(xb),)
    y = torch.func.functional_call(module, tensors, args)
    dg, db = torch.autograd.grad(y, (master["scale"], master["bias"]),
                                 port(dyb))
    np.testing.assert_array_equal(
        _nhwc(y.detach().float()), np.asarray(y_ref.astype(jnp.float32)))
    for got, ref in ((dg, dg_ref), (db, db_ref)):
        assert got.dtype == torch.float32
        scale = np.abs(ref).max()
        assert np.abs(got.numpy() - ref).max() <= 1e-6 * scale
        rounded = got.to(torch.bfloat16).float().numpy()
        assert np.abs(rounded - ref).max() > 1e-4 * scale


# --- the space-to-depth stem ------------------------------------------------

def test_space_to_depth_order_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 6, 8, 3)).astype(
        np.float32)
    ref = np.asarray(js2d.space_to_depth_2x2(x))
    got = _nhwc(ts2d.space_to_depth_2x2(_nchw(x)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("size", [(16, 16), (12, 10), (9, 11)])
def test_s2d_stem_exact_vs_7x7_conv(size):
    """The stem against a plain 7x7 stride-2 conv with padding 3, on the
    same kernel, and against the JAX stem (even sizes); odd sizes take
    the plain conv."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *size, 3)).astype(np.float32)
    k = (rng.standard_normal((7, 7, 3, 8)) * 0.1).astype(np.float32)
    stem = ts2d.SpaceToDepthStem(3, 8)
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
    got = stem(_nchw(x))
    ref = F.conv2d(_nchw(x), stem.weight, stride=2, padding=3)
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               atol=1e-5)
    if size[0] % 2 == 0 and size[1] % 2 == 0:
        jref = js2d.SpaceToDepthStem(8, dtype=jnp.float32).apply(
            {"params": {"kernel": k}}, x)
        np.testing.assert_allclose(_nhwc(got), np.asarray(jref), atol=1e-5)


# --- the model --------------------------------------------------------------

@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_param_counts_match_jax(name):
    jm = getattr(jresnet, name)(num_classes=1000)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=True))
    want = sum(np.prod(s.shape) for s in
               jax.tree_util.tree_leaves(shapes["params"]))
    model = create_model(name, num_classes=1000, device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    stats = sum(np.prod(s.shape) for s in
                jax.tree_util.tree_leaves(shapes["batch_stats"]))
    assert sum(b.numel() for b in model.buffers()) == stats


def _configs():
    out = {}
    for block in ("BasicBlock", "Bottleneck"):
        for fused in (True, False):
            out[f"{block}-{'fused' if fused else 'plain'}"] = dict(
                block=block, tpu_fused=fused)
    out["Bottleneck-zero-init"] = dict(block="Bottleneck", tpu_fused=True,
                                       zero_init_residual=True)
    out["BasicBlock-small-stem"] = dict(block="BasicBlock", tpu_fused=True,
                                        small_stem=True)
    return out


CONFIGS = _configs()


def _jax_model(cfg):
    kw = dict(cfg)
    block = getattr(jresnet, kw.pop("block"))
    return jresnet.ResNet(stage_sizes=(1, 1), block=block,
                          num_classes=CLASSES, num_filters=8, **kw)


def _port_model(cfg, params, stats):
    kw = dict(cfg)
    block = getattr(tresnet, kw.pop("block"))
    model = tresnet.ResNet((1, 1), block, CLASSES, 8, device="cpu", **kw)
    model.load_state_dict(resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, stats)))
    return model.to(memory_format=torch.channels_last)


def _jax_init(cfg, seed=3):
    jm = _jax_model(cfg)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)),
                train=True)
    # Running statistics away from (0, 1), so eval mode is not trivial.
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.abs(rng.standard_normal(a.shape)).astype(
            np.float32) * 0.3, v["batch_stats"])
    return jm, v["params"], stats


def _images(n=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, SIZE, SIZE, 3), np.float32),
            rng.integers(0, CLASSES, n).astype(np.int32))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_logits_match_jax(case, train):
    cfg = CONFIGS[case]
    jm, params, stats = _jax_init(cfg)
    model = _port_model(cfg, params, stats)
    x, _ = _images()
    variables = {"params": params, "batch_stats": stats}
    model.train(train)
    new_stats: dict = {}
    got = model(_nchw(x), new_stats if train else None)
    if train:
        ref, upd = jm.apply(variables, x, train=True, mutable=["batch_stats"])
        _, got_stats = resnet_params_to_jax(new_stats)
        want, have = _flat(upd["batch_stats"]), _flat(got_stats)
        assert want.keys() == have.keys()
        for k in want:
            np.testing.assert_allclose(have[k], want[k], atol=1e-4,
                                       err_msg=k)
    else:
        ref = jm.apply(variables, x, train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-4)


def test_weight_bridge_round_trips():
    cfg = CONFIGS["Bottleneck-fused"]
    _, params, stats = _jax_init(cfg)
    model = _port_model(cfg, params, stats)
    p, s = resnet_params_to_jax(model.state_dict())
    for got, ref in ((p, params), (s, stats)):
        want, have = _flat(ref), _flat(got)
        assert want.keys() == have.keys()
        for k in want:
            np.testing.assert_array_equal(have[k], want[k], err_msg=k)


# --- training ---------------------------------------------------------------

def _optax_tx(name, lr, wd):
    """The JAX CLI's optimizer block (adam: coupled L2; sgd: coupled L2
    then momentum 0.9)."""
    if name == "adam":
        return optax.chain(optax.add_decayed_weights(wd),
                           optax.scale_by_adam(),
                           optax.scale_by_learning_rate(lr))
    return optax.chain(optax.add_decayed_weights(wd),
                       optax.sgd(lr, momentum=0.9))


def _batches(n=STEPS):
    return [_images(seed=10 + i) for i in range(n)]


def _run_jax(cfg, params, stats, batches, *, opt, lr, wd, accum=1,
             smoothing=0.0, precision="f32"):
    jm = _jax_model(cfg)
    tx = _optax_tx(opt, lr, wd)
    params = jax.tree_util.tree_map(jnp.array, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params),
                          batch_stats=jax.tree_util.tree_map(jnp.array, stats),
                          apply_fn=jm.apply, tx=tx)
    step = jax_train_step(kind="image_classifier",
                          policy=jax_policy(precision),
                          num_microbatches=accum, label_smoothing=smoothing)
    losses, accs = [], []
    for x, y in batches:
        state, m = step(state, {"image": jnp.asarray(x),
                                "label": jnp.asarray(y)})
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    return losses, accs, state


def _run_port(cfg, params, stats, batches, *, opt, lr, wd, accum=1,
              smoothing=0.0, precision="f32"):
    policy = make_policy(precision)
    model = _port_model(cfg, params, stats)
    state = create_train_state(
        model, build_optimizer(opt, lr, weight_decay=wd), policy=policy)
    step = make_train_step(kind="image_classifier", policy=policy,
                           num_microbatches=accum, label_smoothing=smoothing)
    losses, accs = [], []
    for x, y in batches:
        state, m = step(state, {"image": torch.from_numpy(x),
                                "label": torch.from_numpy(y)})
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    return losses, accs, state


def _assert_tree_close(got, ref, atol, what):
    want, have = _flat(ref), _flat(got)
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_allclose(have[k], want[k], atol=atol, rtol=0,
                                   err_msg=f"{what} {k}")


# Adam at lr 1e-3 moves every weight by ~1e-3 a step, ten times the
# tolerance; sgd's steps are set by the gradients.
# Adam is run on the BasicBlock models only.  In a Bottleneck model the
# first block projects its residual, so a per-channel shift of the stem's
# pooled output is cancelled by both branches' 1x1 conv + BatchNorm, and a
# 3x3 window's max is positive almost always: the stem BatchNorm's bias
# has a zero gradient in exact arithmetic.  Adam turns both sides'
# rounding noise there into steps of up to lr, which the BatchNorms after
# it then record in their running statistics.  sgd's update is linear in the gradient and keeps that noise
# at its own size, so the Bottleneck models are held to JAX under sgd.
TRAIN_CASES = {
    "sgd-accum1": dict(opt="sgd", lr=0.05, wd=1e-3),
    "sgd-accum2": dict(opt="sgd", lr=0.05, wd=1e-3, accum=2),
    "adam-accum1": dict(opt="adam", lr=1e-3, wd=1e-3),
    "adam-accum2": dict(opt="adam", lr=1e-3, wd=1e-3, accum=2,
                        smoothing=0.1),
}
TRAIN_PAIRS = [
    ("BasicBlock-fused", "sgd-accum1"), ("BasicBlock-fused", "sgd-accum2"),
    ("BasicBlock-fused", "adam-accum1"), ("BasicBlock-fused", "adam-accum2"),
    ("BasicBlock-plain", "adam-accum2"), ("Bottleneck-plain", "sgd-accum1"),
    ("Bottleneck-plain", "sgd-accum2"), ("Bottleneck-fused", "sgd-accum2"),
    ("Bottleneck-zero-init", "sgd-accum1"),
]


@pytest.mark.parametrize("model_case,case", TRAIN_PAIRS)
def test_train_steps_match_jax(model_case, case):
    cfg = CONFIGS[model_case]
    _, params, stats = _jax_init(cfg)
    batches = _batches()
    kw = TRAIN_CASES[case]
    ref_losses, ref_accs, ref_state = _run_jax(cfg, params, stats, batches,
                                               **kw)
    losses, accs, state = _run_port(cfg, params, stats, batches, **kw)
    np.testing.assert_allclose(losses, ref_losses, atol=1e-4, rtol=0)
    np.testing.assert_allclose(accs, ref_accs, atol=1e-6)
    got_params, got_stats = resnet_params_to_jax(
        {**state.params, **state.batch_stats})
    _assert_tree_close(got_params, ref_state.params, 1e-4, "params")
    _assert_tree_close(got_stats, ref_state.batch_stats, 1e-4, "batch_stats")
    assert all(v.dtype == torch.float32 for v in state.batch_stats.values())


def test_eval_step_matches_jax():
    cfg = CONFIGS["BasicBlock-fused"]
    jm, params, stats = _jax_init(cfg)
    x, y = _images(seed=5)
    tx = _optax_tx("sgd", 0.1, 0.0)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats=stats,
                           apply_fn=jm.apply, tx=tx)
    ref = jax_eval_step(kind="image_classifier")(
        jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    state = create_train_state(_port_model(cfg, params, stats),
                               build_optimizer("sgd", 0.1, weight_decay=0.0))
    got = make_eval_step(kind="image_classifier")(
        state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), atol=1e-5)


def test_uint8_input_is_scaled_on_the_device():
    """A uint8 batch trains like its /255 float twin (the device-side
    ToTensor of ``prepare_image_input``)."""
    cfg = CONFIGS["BasicBlock-fused"]
    _, params, stats = _jax_init(cfg)
    rng = np.random.default_rng(7)
    x8 = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    y = rng.integers(0, CLASSES, BATCH).astype(np.int32)
    xf = x8.astype(np.float32) / np.float32(255.0)
    kw = dict(opt="sgd", lr=0.05, wd=1e-3)
    a, _, _ = _run_port(cfg, params, stats, [(x8, y)], **kw)
    b, _, _ = _run_port(cfg, params, stats, [(xf, y)], **kw)
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_bf16_policy_loss_tracks_jax():
    """32 px and 8 images a microbatch: at 16 px and 4 a microbatch the
    last stage's BatchNorm normalizes over 16 values a channel, and three
    bf16 steps there are too chaotic to resolve 2e-2."""
    cfg = CONFIGS["BasicBlock-fused"]
    jm = _jax_model(cfg)
    v = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)), train=True)
    params, stats = v["params"], v["batch_stats"]
    batches = []
    for i in range(STEPS):
        rng = np.random.default_rng(20 + i)
        batches.append((rng.random((16, 32, 32, 3), np.float32),
                        rng.integers(0, CLASSES, 16).astype(np.int32)))
    kw = dict(opt="sgd", lr=0.05, wd=1e-3, accum=2, precision="bf16")
    ref_losses, _, _ = _run_jax(cfg, params, stats, batches, **kw)
    losses, _, state = _run_port(cfg, params, stats, batches, **kw)
    np.testing.assert_allclose(losses, ref_losses, atol=2e-2, rtol=0)
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert all(v.dtype == torch.float32 for v in state.batch_stats.values())


def test_stem_remat_gives_the_same_grads_and_stats():
    """``stem_remat`` recomputes the stem in the backward on the same
    tensors: grads and new running statistics are identical, and the
    statistics are written once."""
    x, y = _images(seed=9)
    out = []
    for remat in (False, True):
        model = tresnet.resnet18(CLASSES, {"num_filters": 8,
                                           "stem_remat": remat},
                                 device="cpu", seed=4)
        params = dict(model.named_parameters())
        stats: dict = {}
        logits = torch.func.functional_call(
            model, params, (_nchw(x),), {"new_stats": stats})
        loss = F.cross_entropy(logits, torch.from_numpy(y).long())
        grads = torch.autograd.grad(loss, list(params.values()))
        before = model.stem.bn_init.mean.clone()
        model(_nchw(x))         # no dict: the buffers take the update
        out.append((grads, stats, before, model.stem.bn_init.mean.clone()))
    (g0, s0, b0, a0), (g1, s1, b1, a1) = out
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert s0.keys() == s1.keys()
    for k in s0:
        torch.testing.assert_close(s0[k], s1[k], rtol=0, atol=0)
    torch.testing.assert_close(a1, s1["stem.bn_init.mean"], rtol=0, atol=0)
    torch.testing.assert_close(b1, b0, rtol=0, atol=0)
