"""Weight bridge between the JAX package's GPT-2, ResNet and ViT param
trees and this port's ``state_dict``, both ways.

The tree is nested mappings of arrays (numpy, or anything ``np.asarray``
takes), as ``GPT2.init(...)["params"]`` returns it.  What changes on the
way:

- flax ``Dense`` kernels are (in, out); ``nn.Linear`` weights are
  (out, in), so kernels are transposed;
- flax ``LayerNorm`` names its parameters ``scale``/``bias``; torch's are
  ``weight``/``bias`` (both use epsilon 1e-6 here, ``models/gpt2.py``);
- ``wte`` doubles as the LM head when embeddings are tied, so there is no
  ``lm_head`` entry then;
- flax ``Conv`` kernels are HWIO, ``nn.Conv2d`` weights OIHW; the ResNet's
  BatchNorm ``scale``/``bias`` are parameters of the same names and its
  ``batch_stats`` ``mean``/``var`` are buffers; flax's auto-names
  (``BasicBlock_i`` / ``Bottleneck_i``, ``Conv_j``, ``BatchNorm_j``) map to
  ``blocks.i``, ``convj``, ``bnj``, and ``conv_init``/``bn_init`` live
  under the port's ``stem``;
- the ViT's ``block_i`` become ``blocks.i``; its ``cls_token`` and
  ``pos_embed`` keep their (1, 1, D) and (1, N, D) shapes.

No downloading is involved: tests build the JAX params from its own
init, compare the two models on the same inputs, and map the port's
parameters back (``gpt2_params_to_jax``) to compare weights after the
same training steps leaf by leaf.

``train_state_from_jax`` / ``train_state_to_jax`` carry a whole training
state across: the JAX ``CheckpointManager.restore_latest`` arrays
(``step``, ``params``, optax's ``opt_state``, ``batch_stats``) into a
port ``TrainState`` and back.  The JAX package writes orbax checkpoints,
which need JAX to read, so this bridge runs in the tests only.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(tree: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["kernel"]).t().contiguous()
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _layer_norm(tree: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def gpt2_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Map a flax GPT-2 param tree to ``GPT2.state_dict()`` keys (f32)."""
    out = {"wte": _t(tree["wte"]), "wpe": _t(tree["wpe"])}
    layer = 0
    while f"block_{layer}" in tree:
        blk = tree[f"block_{layer}"]
        p = f"blocks.{layer}"
        if "attn" not in blk:
            raise NotImplementedError(
                f"block_{layer} is not a dense block (MoE is not yet ported)"
            )
        _layer_norm(blk["ln1"], f"{p}.ln1", out)
        _dense(blk["attn"]["qkv"], f"{p}.attn.qkv", out)
        _dense(blk["attn"]["proj"], f"{p}.attn.proj", out)
        _layer_norm(blk["ln2"], f"{p}.ln2", out)
        _dense(blk["mlp_up"], f"{p}.mlp_up", out)
        _dense(blk["mlp_down"], f"{p}.mlp_down", out)
        layer += 1
    _layer_norm(tree["ln_final"], "ln_final", out)
    if "lm_head" in tree:
        _dense(tree["lm_head"], "lm_head", out)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def gpt2_params_to_jax(params: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``gpt2_params_from_jax``: ``GPT2.state_dict()`` (or
    a name → tensor mapping of the same keys) as the flax GPT-2 param
    tree of f32 numpy arrays."""
    def dense(prefix):
        out = {"kernel": _np(params[f"{prefix}.weight"]).T.copy()}
        if f"{prefix}.bias" in params:
            out["bias"] = _np(params[f"{prefix}.bias"])
        return out

    def layer_norm(prefix):
        return {"scale": _np(params[f"{prefix}.weight"]),
                "bias": _np(params[f"{prefix}.bias"])}

    tree = {"wte": _np(params["wte"]), "wpe": _np(params["wpe"])}
    layer = 0
    while f"blocks.{layer}.ln1.weight" in params:
        p = f"blocks.{layer}"
        tree[f"block_{layer}"] = {
            "ln1": layer_norm(f"{p}.ln1"),
            "attn": {"qkv": dense(f"{p}.attn.qkv"),
                     "proj": dense(f"{p}.attn.proj")},
            "ln2": layer_norm(f"{p}.ln2"),
            "mlp_up": dense(f"{p}.mlp_up"),
            "mlp_down": dense(f"{p}.mlp_down"),
        }
        layer += 1
    tree["ln_final"] = layer_norm("ln_final")
    if "lm_head.weight" in params:
        tree["lm_head"] = dense("lm_head")
    return tree


def _resnet_key(path: tuple[str, ...]) -> str:
    """A flax ResNet leaf path -> the port's ``state_dict`` key."""
    head, *rest = path
    leaf = "weight" if rest[-1] == "kernel" else rest[-1]
    m = re.fullmatch(r"(?:BasicBlock|Bottleneck)_(\d+)", head)
    if m:
        inner = re.sub(r"^Conv_(\d+)$", r"conv\1", rest[0])
        inner = re.sub(r"^BatchNorm_(\d+)$", r"bn\1", inner)
        return f"blocks.{m.group(1)}.{inner}.{leaf}"
    if head in ("conv_init", "bn_init"):
        return f"stem.{head}.{leaf}"
    return f"{head}.{leaf}"


def _from_flax_leaf(x) -> torch.Tensor:
    t = _t(x)
    if t.ndim == 4:
        return t.permute(3, 2, 0, 1).contiguous()   # HWIO -> OIHW
    if t.ndim == 2:
        return t.t().contiguous()                   # Dense (in, out)
    return t


def resnet_params_from_jax(params: Mapping,
                           batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """Map a flax ResNet's ``params`` and ``batch_stats`` trees to the
    port's ``ResNet.state_dict()`` keys (f32)."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                out[_resnet_key(path + (k,))] = _from_flax_leaf(v)

    walk(params, ())
    walk(batch_stats, ())
    return out


def resnet_params_to_jax(state: Mapping[str, torch.Tensor]
                         ) -> tuple[dict, dict]:
    """The inverse of ``resnet_params_from_jax``: a ``ResNet.state_dict()``
    (or a name -> tensor mapping of its keys) as the flax ``(params,
    batch_stats)`` trees of f32 numpy arrays.  ``batch_stats`` holds the
    running statistics the mapping has."""
    kind = ("Bottleneck" if any(".conv2." in k or ".bn2." in k for k in state)
            else "BasicBlock")
    params: dict = {}
    stats: dict = {}
    for key, value in state.items():
        *mods, leaf = key.split(".")
        if mods[0] == "stem":
            path = [mods[1]]
        elif mods[0] == "blocks":
            inner = re.sub(r"^conv(\d+)$", r"Conv_\1", mods[2])
            inner = re.sub(r"^bn(\d+)$", r"BatchNorm_\1", inner)
            path = [f"{kind}_{mods[1]}", inner]
        else:
            path = mods
        x = _np(value)
        if x.ndim == 4:
            x = x.transpose(2, 3, 1, 0).copy()      # OIHW -> HWIO
        elif x.ndim == 2:
            x = x.T.copy()
        tree = stats if leaf in ("mean", "var") else params
        for p in path:
            tree = tree.setdefault(p, {})
        tree["kernel" if leaf == "weight" else leaf] = x
    return params, stats


def vit_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Map a flax ``VisionTransformer`` param tree to the port's
    ``VisionTransformer.state_dict()`` keys (f32)."""
    out = {"cls_token": _t(tree["cls_token"]),
           "pos_embed": _t(tree["pos_embed"])}
    out["patch_embed.weight"] = _from_flax_leaf(tree["patch_embed"]["kernel"])
    out["patch_embed.bias"] = _t(tree["patch_embed"]["bias"])
    layer = 0
    while f"block_{layer}" in tree:
        blk = tree[f"block_{layer}"]
        p = f"blocks.{layer}"
        _layer_norm(blk["ln1"], f"{p}.ln1", out)
        _dense(blk["attn"]["qkv"], f"{p}.attn.qkv", out)
        _dense(blk["attn"]["proj"], f"{p}.attn.proj", out)
        _layer_norm(blk["ln2"], f"{p}.ln2", out)
        _dense(blk["mlp"]["fc1"], f"{p}.mlp.fc1", out)
        _dense(blk["mlp"]["fc2"], f"{p}.mlp.fc2", out)
        layer += 1
    _layer_norm(tree["ln_final"], "ln_final", out)
    _dense(tree["head"], "head", out)
    return out


def vit_params_to_jax(params: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``vit_params_from_jax``: the port's ViT
    ``state_dict()`` (or a name -> tensor mapping of its keys) as the flax
    param tree of f32 numpy arrays."""
    def dense(prefix):
        return {"kernel": _np(params[f"{prefix}.weight"]).T.copy(),
                "bias": _np(params[f"{prefix}.bias"])}

    def layer_norm(prefix):
        return {"scale": _np(params[f"{prefix}.weight"]),
                "bias": _np(params[f"{prefix}.bias"])}

    tree = {
        "patch_embed": {
            "kernel": _np(params["patch_embed.weight"]).transpose(
                2, 3, 1, 0).copy(),                  # OIHW -> HWIO
            "bias": _np(params["patch_embed.bias"]),
        },
        "cls_token": _np(params["cls_token"]),
        "pos_embed": _np(params["pos_embed"]),
    }
    layer = 0
    while f"blocks.{layer}.ln1.weight" in params:
        p = f"blocks.{layer}"
        tree[f"block_{layer}"] = {
            "ln1": layer_norm(f"{p}.ln1"),
            "attn": {"qkv": dense(f"{p}.attn.qkv"),
                     "proj": dense(f"{p}.attn.proj")},
            "ln2": layer_norm(f"{p}.ln2"),
            "mlp": {"fc1": dense(f"{p}.mlp.fc1"),
                    "fc2": dense(f"{p}.mlp.fc2")},
        }
        layer += 1
    tree["ln_final"] = layer_norm("ln_final")
    tree["head"] = dense("head")
    return tree


# --- whole training states ----------------------------------------------


def _family(names) -> str:
    names = set(names)
    if "wte" in names:
        return "gpt2"
    if "patch_embed" in names or "patch_embed.weight" in names:
        return "vit"
    return "resnet"


def _tree_to_named(tree: Mapping, family: str) -> dict[str, torch.Tensor]:
    """A param-shaped flax tree (params, or a moment of them) by the
    port's parameter names."""
    if family == "gpt2":
        return gpt2_params_from_jax(tree)
    if family == "vit":
        return vit_params_from_jax(tree)
    return resnet_params_from_jax(tree, {})


def _named_to_tree(named: Mapping[str, torch.Tensor], family: str) -> dict:
    if family == "gpt2":
        return gpt2_params_to_jax(named)
    if family == "vit":
        return vit_params_to_jax(named)
    return resnet_params_to_jax(named)[0]


def train_state_from_jax(arrays: Mapping, state):
    """Fill the port ``TrainState`` ``state`` (live tensors, filled in
    place with ``copy_``) from a JAX training state's arrays as numpy
    (``{"step", "params", "opt_state", "batch_stats"}``, what the JAX
    ``CheckpointManager.restore_latest`` returns); returns ``state`` with
    the step.

    ``opt_state`` is optax's, for the optimizers the CLI builds (adam with
    coupled L2, adamw, sgd with ``trace``, ``clip_by_global_norm`` in
    front; constant, cosine and warmup-cosine rates): chains are tuples,
    ``ScaleByAdamState`` is (count, mu, nu), ``TraceState`` (trace,),
    ``ScaleByScheduleState`` (count,), and the stateless transforms (and
    a constant rate's ``ScaleState``) are empty.  The port's rate counter
    under a constant rate, which optax does not keep, is the step."""
    from ..train.optim import AdamState, CountState

    family = _family(arrays["params"])
    names = list(state.params)
    step = int(np.asarray(arrays["step"]))

    def fill(targets: dict, source: Mapping, what: str) -> None:
        if set(targets) != set(source):
            diff = sorted(set(targets) ^ set(source))
            raise ValueError(f"{what}: {len(diff)} names differ "
                             f"(first: {diff[0]})")
        with torch.no_grad():
            for n, t in targets.items():
                t.copy_(source[n])

    def slots(tree, live: list, what: str) -> None:
        fill(dict(zip(names, live)), _tree_to_named(tree, family), what)

    def walk(port, jax_node, path: str):
        jax_node = tuple(jax_node)   # a chain's tuple, a namedtuple
        if isinstance(port, tuple):
            if len(port) != len(jax_node):
                raise ValueError(f"{path}: {len(port)} transforms against "
                                 f"optax's {len(jax_node)}")
            return tuple(walk(p, j, f"{path}/{i}")
                         for i, (p, j) in enumerate(zip(port, jax_node)))
        if isinstance(port, AdamState):
            count, mu, nu = jax_node
            slots(mu, port.mu, f"{path}/mu")
            slots(nu, port.nu, f"{path}/nu")
            port.count = int(np.asarray(count))
            return port
        if isinstance(port, CountState):
            # A constant rate's ScaleState holds no count: the step.
            port.count = int(np.asarray(jax_node[0])) if jax_node else step
            return port
        if isinstance(port, list):      # optax.trace's momentum
            slots(jax_node[0], port, f"{path}/trace")
            return port
        raise TypeError(f"{path}: no optax counterpart for {type(port)}")

    opt_state = walk(state.opt_state, arrays["opt_state"], "opt_state")
    if family == "resnet":
        named = resnet_params_from_jax(arrays["params"],
                                       arrays["batch_stats"])
        fill(state.params, {n: named[n] for n in state.params}, "params")
        fill(state.batch_stats, {n: named[n] for n in named
                                 if n not in state.params}, "batch_stats")
    else:
        fill(state.params, _tree_to_named(arrays["params"], family),
             "params")
        fill(state.batch_stats, {}, "batch_stats")
    return dataclasses.replace(state, step=step, opt_state=opt_state)


def train_state_to_jax(state, *, scheduled: bool = True) -> dict:
    """The inverse of ``train_state_from_jax``: ``{"step", "params",
    "opt_state", "batch_stats"}`` as numpy, ``opt_state`` in optax's
    layout with plain tuples for its named tuples (the same leaves in the
    same order: ``jax.tree_util.tree_unflatten`` of the optax state's
    structure over its leaves rebuilds optax's state).  ``scheduled``:
    False for a constant rate, whose optax state (``ScaleState``) holds
    no count."""
    from ..train.optim import AdamState, CountState

    family = _family(state.params)
    names = list(state.params)

    def tree(live: list) -> dict:
        return _named_to_tree(dict(zip(names, live)), family)

    def walk(port):
        if isinstance(port, tuple):
            return tuple(walk(p) for p in port)
        if isinstance(port, AdamState):
            return (np.asarray(port.count, np.int32), tree(port.mu),
                    tree(port.nu))
        if isinstance(port, CountState):
            return (np.asarray(port.count, np.int32),) if scheduled else ()
        if isinstance(port, list):
            return (tree(port),)
        raise TypeError(f"no optax counterpart for {type(port)}")

    if family == "resnet":
        params, stats = resnet_params_to_jax(
            {**state.params, **state.batch_stats})
    else:
        params, stats = _named_to_tree(state.params, family), {}
    return {"step": np.asarray(state.step, np.int32), "params": params,
            "opt_state": walk(state.opt_state), "batch_stats": stats}
